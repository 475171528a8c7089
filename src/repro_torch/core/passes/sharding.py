"""propagate_sharding — registered where the reference registers it.

A no-op for graphs without a ``dist`` annotation, which keeps the
default pipeline identical to the reference's for unsharded compiles.
Sharded graphs raise until ROADMAP A.14 ports ``repro.dist``.
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
    """No-op (``{"sharded": False}``) for unsharded graphs."""
    if not getattr(graph, "dist", None):
        return graph, {"sharded": False}
    raise NotImplementedError(
        "sharded graphs are not ported yet (ROADMAP A.14: distribution)")
