"""The ``.npz`` + JSON model container — save/load a Graph with weights.

This is the stand-in for the paper's Keras-HDF5 flow ("the Model class
allows to load a network … as written by the Python library Keras"): a
model authored elsewhere is serialized into a single file and ingested
at runtime, then JIT-compiled.  The format is an ``.npz`` archive whose
``__header__`` member is a JSON description of the graph (inputs,
nodes, outputs, public output names) and whose ``param::*`` members are
the weight arrays.

The format is shared with the JAX package's
``repro.frontends.container``: a container written by either package
loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from ..core.graph import Graph, Node

CONTAINER_SUFFIX = ".npz"


def save_model(graph: Graph, path) -> None:
    """Serialize graph + weights; ``path`` is a filename or file object."""
    header = {
        "inputs": {k: {"shape": v.shape, "dtype": v.dtype}
                   for k, v in graph.inputs.items()},
        "outputs": graph.outputs,
        "output_names": graph.output_names,
        "nodes": [
            {"op": n.op, "name": n.name, "inputs": n.inputs, "output": n.output,
             "attrs": _jsonify(n.attrs), "params": n.params,
             "epilogue": n.epilogue, "epilogue_attrs": _jsonify(n.epilogue_attrs)}
            for n in graph.nodes
        ],
    }
    if graph.quant:
        # Graph-level quantization record (mode + decision counts);
        # the per-site scales live in the node attrs above.
        header["quant"] = _jsonify(graph.quant)
    arrays = {f"param::{k}": v for k, v in graph.params.items()}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_model(path) -> Graph:
    """Load a container back into a :class:`Graph` (public output names
    included; containers written before they existed default them to
    the tensor names)."""
    data = np.load(path, allow_pickle=False)
    header = json.loads(bytes(data["__header__"]).decode())
    g = Graph()
    for name, spec in header["inputs"].items():
        g.add_input(name, spec["shape"], spec["dtype"])
    for k in data.files:
        if k.startswith("param::"):
            g.add_param(k[len("param::"):], data[k])
    for nd in header["nodes"]:
        node = Node(op=nd["op"], name=nd["name"], inputs=nd["inputs"],
                    output=nd["output"], attrs=_tuplify(nd["attrs"]),
                    params=nd["params"], epilogue=nd["epilogue"],
                    epilogue_attrs=_tuplify(nd["epilogue_attrs"]))
        g.nodes.append(node)
    g.rebuild_index()
    if header.get("quant"):
        g.quant = header["quant"]
    names = header.get("output_names")
    if names and names != header["outputs"]:
        g.set_outputs(dict(zip(names, header["outputs"])))
    else:
        g.set_outputs(header["outputs"])
    return g


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_jsonify(v) for v in obj]
    return obj


def _tuplify(obj):
    """JSON round-trips tuples as lists; the IR uses tuples for shapes
    and paddings, so convert lists (recursively) back to tuples."""
    if isinstance(obj, dict):
        return {k: _tuplify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return tuple(_tuplify(v) for v in obj)
    return obj
