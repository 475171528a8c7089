"""propagate_sharding — the distribution pass, as a registry citizen.

The thin pipeline wrapper around :mod:`repro_torch.dist.propagate`,
registered where the reference registers it: after every optimization
pass (placement is decided on the final graph, so fusion and layout
rewrites never reason about collective nodes).  A no-op for graphs
without a ``dist`` annotation, which keeps the default pipeline the
reference's for unsharded compiles.  ``repro_torch.dist`` is imported
lazily: only sharded compiles load it.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..graph import Graph
from .manager import register_pass


@register_pass("propagate_sharding",
               after=("canonicalize", "fold_constants", "fuse_pad",
                      "fuse_activation", "fold_batchnorm",
                      "fuse_activation.post_bn", "optimize_layout"))
def propagate_sharding(graph: Graph) -> Tuple[Graph, Dict]:
    """Resolve per-tensor shardings and insert collectives
    (repro_torch.dist); no-op (``{"sharded": False}``) for unsharded
    graphs."""
    if not getattr(graph, "dist", None):
        return graph, {"sharded": False}
    from ...dist.propagate import propagate_shardings
    return graph, propagate_shardings(graph)
