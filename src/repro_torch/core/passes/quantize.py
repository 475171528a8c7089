"""quantize — registered where the reference registers it, not yet ported.

The reference's pass calibrates int8/bf16 sites from a request riding
on ``graph.quant``.  The port registers the pass at the same place in
the order (so ``DEFAULT_PIPELINE`` names the same passes) and keeps its
no-request behaviour; a real request raises until ROADMAP A.5 ports the
calibration and the int8 kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..graph import Graph
from .manager import register_pass


@register_pass("quantize", after=("fuse_activation.post_bn",),
               before=("optimize_layout",))
def quantize(graph: Graph) -> Tuple[Graph, Dict]:
    """No-op without a request or under ``mode="f32"`` (as in the
    reference); any other mode raises ``NotImplementedError``."""
    req = graph.quant
    if not req or req.get("mode") in (None, "f32"):
        if req:
            graph.quant = {"mode": "f32"}
        return graph, {"sites": 0}
    raise NotImplementedError(
        f"quantization mode {req['mode']!r} is not ported yet "
        f"(ROADMAP A.5: precision modes)")
