"""Constant folding: any node all of whose inputs are graph params (or
constants) is evaluated at compile time and replaced by a new param.

The paper's compiler does this implicitly (everything weight-derived is
baked into the emitted code); in the IR it is an explicit pass so the
report can show what got precomputed.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np

from ..graph import Graph
from ..simple import SimpleNN
from .manager import register_pass


@register_pass("fold_constants", after=("canonicalize",))
def fold_constants(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    # Tensors that are compile-time constants: params referenced via
    # ``constant`` nodes.  (Graph inputs are runtime values.)
    const_tensors: Set[str] = set()
    for node in g.nodes:
        if node.op == "constant":
            const_tensors.add(node.output)

    if not const_tensors:
        return g, {"folded": 0}

    folded = 0
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op == "constant":
                continue
            if node.inputs and all(t in const_tensors for t in node.inputs):
                # Evaluate this node at compile time via the oracle on a
                # single-node graph.
                sub = Graph()
                sub.params = g.params
                for t in node.inputs:
                    prod = g.producer(t)
                    sub.add_input(t, g.params[prod.params["value"]].shape)
                sub.nodes = [node]
                sub.rebuild_index()
                sub.set_outputs([node.output])
                oracle = SimpleNN(sub, device="cpu")
                feeds = {
                    t: np.asarray(g.params[g.producer(t).params["value"]])[None]
                    for t in node.inputs
                }
                value = np.asarray(oracle(**feeds)[node.output])[0]
                pname = f"{node.name}/folded"
                g.params[pname] = value.astype(np.float32)
                node.op = "constant"
                node.inputs = []
                node.params = {"value": pname}
                node.attrs = {}
                const_tensors.add(node.output)
                folded += 1
                changed = True
    g.rebuild_index()
    return g, {"folded": folded}
