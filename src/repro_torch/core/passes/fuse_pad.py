"""Merge explicit zero-padding nodes into the following convolution.

CompiledNN merges layers "if that is deemed beneficial for … the
performance of the generated code" (§3.2); an explicit ZeroPadding2D in
front of a 'valid' conv is the canonical case — the conv kernel can read
the padding implicitly instead of materializing a padded copy of the
tensor in memory.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..graph import Graph
from .manager import register_pass


@register_pass("fuse_pad", after=("canonicalize",))
def fuse_pad(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    fused = 0
    changed = True
    while changed:
        changed = False
        for pad in list(g.nodes):
            if pad.op != "zero_pad2d" or pad.output in g.outputs:
                continue
            consumers = g.consumers(pad.output)
            if len(consumers) != 1:
                continue
            conv = consumers[0]
            if conv.op not in ("conv2d", "depthwise_conv2d"):
                continue
            if conv.attrs.get("padding") != "valid":
                continue
            (t, b), (l, r) = pad.attrs["padding"]
            # Explicit per-edge padding replaces the 'valid' string form.
            conv.attrs["padding"] = ((t, b), (l, r))
            conv.inputs = [pad.inputs[0]]
            g.nodes.remove(pad)
            g.rebuild_index()
            fused += 1
            changed = True
    g.rebuild_index()
    return g, {"fused_pads": fused}
