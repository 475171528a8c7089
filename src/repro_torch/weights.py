"""Carry a graph and its weights across from the JAX package.

:func:`from_reference` takes a graph of the reference package by duck
typing (``.inputs``, ``.nodes``, ``.params`` as numpy arrays,
``.outputs``, ``.output_names``) and returns the port's
:class:`~repro_torch.core.graph.Graph` with the same nodes and the same
numpy parameters.  It never imports the reference.  Weights keep the
reference's storage layout here (HWIO convolutions; dense "io" or
"oi"); the targets move them to the device and to OIHW when they
compile.
"""

from __future__ import annotations

import copy

import numpy as np

from .core.graph import Graph, Node


def from_reference(ref) -> Graph:
    """The port's copy of a reference graph (nodes, params, I/O names,
    and the ``quant``/``dist`` annotations where set)."""
    g = Graph()
    for name, spec in ref.inputs.items():
        g.add_input(name, tuple(spec.shape), spec.dtype)
    for name, value in ref.params.items():
        g.add_param(name, np.array(value, dtype=np.float32, copy=True))
    for n in ref.nodes:
        node = Node(op=n.op, name=n.name, inputs=list(n.inputs),
                    output=n.output, attrs=copy.deepcopy(dict(n.attrs)),
                    params=dict(n.params), epilogue=n.epilogue,
                    epilogue_attrs=copy.deepcopy(dict(n.epilogue_attrs)))
        node.validate()
        g.nodes.append(node)
    g.rebuild_index()
    names, tensors = list(ref.output_names), list(ref.outputs)
    g.set_outputs(dict(zip(names, tensors)) if names != tensors else tensors)
    g.quant = copy.deepcopy(getattr(ref, "quant", None))
    g.dist = copy.deepcopy(getattr(ref, "dist", None))
    return g
