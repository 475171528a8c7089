"""Carry a graph and its weights, or a model's params, across from the
JAX package.

:func:`from_reference` takes a graph of the reference package by duck
typing (``.inputs``, ``.nodes``, ``.params`` as numpy arrays,
``.outputs``, ``.output_names``) and returns the port's
:class:`~repro_torch.core.graph.Graph` with the same nodes and the same
numpy parameters.  It never imports the reference.  Weights keep the
reference's storage layout here (HWIO convolutions; dense "io" or
"oi"); the targets move them to the device and to OIHW when they
compile.  :func:`params_from_reference` carries an LLM's param tree
(``repro.models.get_model(cfg).init(key)``) to torch tensors.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

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


def _leaf_to_torch(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_reference(params):
    """The port's copy of a reference model's param tree: the same nested
    dict, keys, stacked ``(L, ...)`` shapes and dtypes, with torch
    tensors (on the CPU) for its numpy, ``ml_dtypes.bfloat16`` or array
    leaves.  ``repro_torch.compile(cfg, target="engine", params=...)``
    moves them to its device."""
    if isinstance(params, dict):
        return {k: params_from_reference(v) for k, v in params.items()}
    return _leaf_to_torch(params)
