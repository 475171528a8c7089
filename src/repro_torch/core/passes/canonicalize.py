"""Canonicalization: rewrite sugar ops into core forms so later passes
see a uniform IR (the paper's front end does the equivalent when mapping
Keras layers onto compilation units)."""

from __future__ import annotations

from typing import Dict, Tuple

from ..graph import Graph
from .manager import register_pass


@register_pass("canonicalize")
def canonicalize(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    specs = g.infer_shapes()
    rewrites = 0
    for node in g.nodes:
        # flatten -> reshape with an explicit static shape.
        if node.op == "flatten":
            node.op = "reshape"
            node.attrs = {"shape": (specs[node.inputs[0]].size,)}
            rewrites += 1
        # standalone softmax node -> activation(fn=softmax) so the
        # fusion pass has one representation of activations.
        elif node.op == "softmax":
            node.op = "activation"
            node.attrs = {"fn": "softmax", "axis": node.attrs["axis"]}
            rewrites += 1
    g.rebuild_index()
    return g, {"rewrites": rewrites}
