"""repro_torch.distributed — logical-axis rules and fault tolerance (the
port of ``repro.distributed``)."""

from . import sharding
from .fault import (MeshUnavailableError, StragglerWatchdog, check_mesh,
                    run_with_restarts)

__all__ = ["MeshUnavailableError", "StragglerWatchdog", "check_mesh",
           "run_with_restarts", "sharding"]
