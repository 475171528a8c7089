"""Sharding propagation — per-tensor partition specs from logical rules.

The port of ``repro.dist.propagate``, decision for decision: the same
graph, mesh and rules give the same ``graph.dist`` (shardings and edit
log) and the same inserted collectives as the reference.  The
compile-time half of the subsystem.  ``propagate_shardings`` reads
the mesh + logical-axis rules a :class:`ShardedExecutable` attached to
``graph.dist``, walks the optimized graph once, and

* decides a placement for every tensor: the batch dim shards over the
  ``batch``-rule mesh axes (pure data parallelism), and dense layers go
  Megatron-style tensor-parallel over the ``mlp``-rule axes — column
  parallel (cout sharded) when the channel count divides the model-axis
  size, row parallel (contraction over an already-sharded channel dim)
  when the producer left the input sharded;
* inserts the collectives that placement implies as first-class graph
  nodes — a ``psum`` closing every row-parallel contraction, an
  ``all_gather`` in front of every op that needs the channel dim whole
  (softmax, flatten/reshape, convs, mismatched elementwise) and every
  graph output;
* records the result in ``graph.dist["shardings"]`` — one
  batch-*inclusive* axis list per tensor, JSON-plain so it round-trips
  through the artifact manifest byte-for-byte.

Everything here is placement, never math: the collectives are logical
identities.  On a live mesh each rank runs the local form of every
tensor the specs give it; the dense lowering and the collectives' move
the data (``repro_torch.dist.collectives``, ``core/lowering.py``).

``check_shardings`` is the pipeline verifier hook: after every pass the
:class:`~repro_torch.core.passes.manager.PassManager` re-checks (like shape
inference) that collective attrs name real mesh axes and — once the
propagation pass has run — that every live tensor has a resolved spec
of the right rank.

A deserialized manifest injects its stored placement as
``graph.dist["resolved"]`` — the spec table plus the exact graph edits
(inserted collectives, input rewires, final outputs) the original
propagation made.  ``propagate_shardings`` then *replays* the edits
mechanically instead of re-deriving anything, so a second process
reconstructs placement with **zero re-propagation** and ends up with a
byte-identical ``graph.dist`` / node list — i.e. the same persistent
executable-cache key, hence zero recompiles on a warm cache.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..core.graph import Graph
from ..distributed.sharding import DEFAULT_RULES
from .collectives import COLLECTIVE_OPS, axis_names
from .mesh import MeshSpec


class ShardingError(ValueError):
    """A sharding annotation is inconsistent with the graph or mesh."""


#: Ops that keep their input's channel (last-dim) sharding: elementwise
#: or spatial-only, so a sharded channel dim passes straight through.
PRESERVE_LAST = frozenset({
    "batchnorm", "maxpool2d", "avgpool2d", "upsample2d", "zero_pad2d",
    "global_avg_pool",
})


def _norm_axes(value) -> Tuple[str, ...]:
    """A rule value (str or sequence of str) as a tuple of axis names."""
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(str(v) for v in value)


def merged_rules(overrides=None) -> Dict[str, Tuple[str, ...]]:
    """``DEFAULT_RULES`` with ``overrides`` applied on top.

    ``overrides`` accepts a mapping or ``(logical, axes)`` pairs (the
    normalized form ``CompileOptions.sharding_rules`` stores); values
    are a mesh-axis name or sequence of names; ``None`` deletes the
    rule (forces replication for that logical axis).
    """
    rules = {k: _norm_axes(v) for k, v in DEFAULT_RULES.items()}
    if overrides:
        items = overrides.items() if hasattr(overrides, "items") else overrides
        for k, v in items:
            if v is None:
                rules.pop(str(k), None)
            else:
                rules[str(k)] = _norm_axes(v)
    return rules


def _rules_pairs(rules: Dict[str, Tuple[str, ...]]) -> List[list]:
    """Rules as sorted JSON-plain pairs (the form stored on
    ``graph.dist`` and in the artifact manifest)."""
    return [[k, list(v)] for k, v in sorted(rules.items())]


def _axes_for(logical: str, rules: Dict[str, Tuple[str, ...]],
              mesh: MeshSpec) -> Tuple[str, ...]:
    """Mesh axes the logical axis ``logical`` shards over: the rule's
    axes filtered to ones this mesh actually has, deduplicated."""
    out: List[str] = []
    names = set(mesh.names)
    for ax in rules.get(logical, ()):
        if ax in names and ax not in out:
            out.append(ax)
    return tuple(out)


def _axes_size(axes, mesh: MeshSpec) -> int:
    return math.prod(mesh.axis_size(a) for a in axes) if axes else 1


def _normalize_shardings(shardings: Dict[str, list]) -> Dict[str, list]:
    """Canonical JSON-plain form: every entry a list of axis-name lists
    or None, so a fresh propagation and a manifest round-trip produce
    byte-identical ``graph.dist`` (and hence the same cache key)."""
    out = {}
    for t, entry in shardings.items():
        out[str(t)] = [None if e is None else [str(a) for a in e]
                       for e in entry]
    return out


def _fresh_name(graph: Graph, base: str) -> str:
    """A node name whose output tensor name is unused in the graph."""
    name, i = base, 1
    while f"{name}:out" in graph._producers or f"{name}:out" in graph.inputs:
        name = f"{base}{i}"
        i += 1
    return name


def propagate_shardings(graph: Graph) -> Dict[str, object]:
    """Annotate ``graph`` (in place) with per-tensor shardings and the
    collectives they imply; returns pass stats.

    Expects ``graph.dist`` to carry ``{"mesh": ..., "rules": ...}`` (as
    set by :class:`~repro_torch.dist.executable.ShardedExecutable`); leaves it carrying the
    normalized ``{"mesh", "rules", "shardings"}`` triple.
    """
    dist = getattr(graph, "dist", None)
    if not dist:
        return {"sharded": False}
    mesh = MeshSpec.coerce(dist["mesh"])
    rules = merged_rules(dist.get("rules"))
    dist["mesh"] = mesh.to_dict()
    dist["rules"] = _rules_pairs(rules)

    resolved = dist.pop("resolved", None)
    if resolved is not None:
        return _replay(graph, dist, resolved)

    model_axes = _axes_for("mlp", rules, mesh)
    batch_axes = tuple(a for a in _axes_for("batch", rules, mesh)
                       if a not in model_axes)
    model_size = _axes_size(model_axes, mesh)

    specs = graph.infer_shapes()
    #: tensor -> mesh axes its LAST dim is sharded over (() = whole).
    part: Dict[str, Tuple[str, ...]] = {t: () for t in graph.inputs}
    #: tensor -> replacement every later consumer must read instead
    #: (set when a psum closes a row-parallel partial sum).
    alias: Dict[str, str] = {}
    #: tensor -> its all_gather'ed copy (dedup across consumers).
    gathered: Dict[str, str] = {}
    #: The edit log: everything the walk changes, recorded so a
    #: deserialized manifest can replay placement without re-deriving it.
    edits: Dict[str, object] = {"inserted": [], "rewires": {}, "outputs": []}

    def insert(op: str, base: str, inputs: List[str], attrs: dict) -> str:
        name = _fresh_name(graph, base)
        out = graph.add_node(op, name, inputs, attrs=attrs)
        edits["inserted"].append({
            "op": op, "name": name, "inputs": list(inputs),
            "output": out, "attrs": attrs})
        return out

    def gather(t: str) -> str:
        """The replicated view of sharded tensor ``t`` (memoized)."""
        if t in gathered:
            return gathered[t]
        axes = part[t]
        prod = graph.producer(t)
        out = insert(
            "all_gather", f"{prod.name if prod else t}.gather", [t],
            {"axis": list(axes), "dim": -1,
             "axis_size": _axes_size(axes, mesh)})
        part[out] = ()
        gathered[t] = out
        return out

    for node in list(graph.toposort()):
        orig_inputs = list(node.inputs)
        node.inputs = [alias.get(t, t) for t in node.inputs]
        op = node.op
        ins_part = [part.get(t, ()) for t in node.inputs]
        out = node.output

        if op in COLLECTIVE_OPS:
            # Hand-inserted collective: trust its declared effect.
            if op == "reduce_scatter":
                part[out] = axis_names(node)
            elif op == "ppermute":
                part[out] = ins_part[0]
            else:
                part[out] = ()
        elif op == "dense":
            if ins_part[0]:
                # Row parallel: the contraction runs over a sharded
                # channel dim, so each shard holds a partial sum — a
                # psum closes it and every later consumer reads the
                # reduced value.
                axes = ins_part[0]
                red = insert(
                    "psum", f"{node.name}.psum", [out],
                    {"axis": list(axes),
                     "axis_size": _axes_size(axes, mesh)})
                part[out] = ()
                part[red] = ()
                alias[out] = red
            elif (model_size > 1
                    and specs[out].shape[-1] % model_size == 0
                    and node.epilogue != "softmax"
                    and "orig_cout" not in node.attrs):
                # Column parallel: shard cout (the kernel splits for
                # free — weights are compile-time constants).  Padded
                # (orig_cout) and softmax-epilogue denses stay whole:
                # slicing/softmax need the full channel dim.
                part[out] = model_axes
            else:
                part[out] = ()
        elif op == "activation":
            if node.attrs.get("fn") == "softmax" and ins_part[0]:
                node.inputs[0] = gather(node.inputs[0])
            part[out] = part.get(node.inputs[0], ())
        elif op in PRESERVE_LAST:
            part[out] = ins_part[0]
        elif op in ("add", "mul"):
            if ins_part[0] != ins_part[1]:
                node.inputs = [gather(t) if part.get(t) else t
                               for t in node.inputs]
            part[out] = part.get(node.inputs[0], ())
        elif op == "concat":
            rank = len(specs[out].shape)
            same = all(p == ins_part[0] for p in ins_part)
            if node.attrs["axis"] == rank - 1 or not same:
                node.inputs = [gather(t) if part.get(t) else t
                               for t in node.inputs]
            part[out] = part.get(node.inputs[0], ())
        else:
            # Conservative default (convs, flatten, reshape, softmax,
            # decode_attention, plug-ins): these need the channel dim
            # whole — gather any sharded input, output replicated.
            node.inputs = [gather(t) if part.get(t) else t
                           for t in node.inputs]
            part[out] = ()

        if node.inputs != orig_inputs:
            edits["rewires"][node.name] = list(node.inputs)

    # Graph outputs are the public contract: always whole.
    graph.outputs = [alias.get(t, t) for t in graph.outputs]
    graph.outputs = [gather(t) if part.get(t) else t for t in graph.outputs]
    edits["outputs"] = list(graph.outputs)

    inserted = len(edits["inserted"])
    if inserted:
        graph.nodes = graph.toposort()
    graph.rebuild_index()

    specs = graph.infer_shapes()
    shardings: Dict[str, list] = {}
    batch_entry = list(batch_axes) if batch_axes else None
    for t, spec in specs.items():
        entry: List[Optional[list]] = [batch_entry] + [None] * len(spec.shape)
        if spec.shape and part.get(t):
            entry[-1] = list(part[t])
        shardings[t] = entry
    dist["shardings"] = _normalize_shardings(shardings)
    dist["edits"] = edits
    return {"sharded": True, "reused": False, "collectives": inserted}


def _replay(graph: Graph, dist: dict, resolved: dict) -> Dict[str, object]:
    """Re-apply a serialized placement: insert the recorded collectives,
    rewire the recorded inputs, restore the recorded outputs, and adopt
    the stored spec table — no propagation logic runs.  Ends with the
    same node list and ``graph.dist`` as the original compile, so the
    persistent-cache key matches and the warm cache hits."""
    edits = resolved.get("edits") or {"inserted": [], "rewires": {},
                                      "outputs": list(graph.outputs)}
    for nd in edits["inserted"]:
        graph.add_node(nd["op"], nd["name"], nd["inputs"],
                       output=nd["output"], attrs=nd["attrs"])
    by_name = {n.name: n for n in graph.nodes}
    for name, new_inputs in edits["rewires"].items():
        node = by_name.get(name)
        if node is None:
            raise ShardingError(
                f"sharding manifest rewires unknown node {name!r}")
        node.inputs = list(new_inputs)
    graph.outputs = list(edits["outputs"])
    if edits["inserted"]:
        graph.nodes = graph.toposort()
    graph.rebuild_index()
    dist["shardings"] = _normalize_shardings(resolved["shardings"])
    dist["edits"] = {"inserted": [dict(d) for d in edits["inserted"]],
                     "rewires": {k: list(v)
                                 for k, v in edits["rewires"].items()},
                     "outputs": list(edits["outputs"])}
    return {"sharded": True, "reused": True,
            "collectives": len(edits["inserted"])}


def check_shardings(graph: Graph) -> None:
    """Pipeline-verifier hook: validate ``graph.dist`` against the graph.

    Cheap invariants, re-checked after every pass like shape inference:
    collective nodes name real mesh axes, and — once ``shardings`` is
    resolved — every live tensor has a spec whose rank matches its
    (batch-inclusive) shape and whose axes exist on the mesh.  Raises
    :class:`ShardingError`.
    """
    dist = getattr(graph, "dist", None)
    if not dist:
        return
    mesh = MeshSpec.coerce(dist["mesh"])
    names = set(mesh.names)
    for node in graph.nodes:
        if node.op in COLLECTIVE_OPS:
            for ax in axis_names(node):
                if ax not in names:
                    raise ShardingError(
                        f"collective {node.name!r} ({node.op}) names mesh "
                        f"axis {ax!r}; mesh has {sorted(names)}")
    shardings = dist.get("shardings")
    if shardings is None:
        return
    specs = graph.infer_shapes()
    for t, spec in specs.items():
        entry = shardings.get(t)
        if entry is None:
            raise ShardingError(f"tensor {t!r} has no resolved sharding")
        if len(entry) != len(spec.shape) + 1:
            raise ShardingError(
                f"tensor {t!r}: sharding rank {len(entry)} != "
                f"batch-inclusive rank {len(spec.shape) + 1}")
        for e in entry:
            for ax in (e or ()):
                if ax not in names:
                    raise ShardingError(
                        f"tensor {t!r} sharded over unknown mesh axis "
                        f"{ax!r}; mesh has {sorted(names)}")


def collective_summary(graph: Graph, mesh=None,
                       batch_size: int = 1) -> Dict[str, object]:
    """Static per-axis collective counts and bytes-moved estimates.

    Ring-algorithm estimates per collective over ``k`` devices on
    ``n``-byte tensors: psum moves ``2n(k-1)/k`` (reduce-scatter +
    all-gather), all_gather / reduce_scatter ``n(k-1)/k``, ppermute
    ``n/k`` (one shard hop).  Multi-axis collectives split the estimate
    evenly across their axes.
    """
    dist = getattr(graph, "dist", None)
    if mesh is None and dist:
        mesh = MeshSpec.coerce(dist["mesh"])
    mesh = MeshSpec.coerce(mesh) if mesh is not None else None
    specs = graph.infer_shapes()
    counts: Dict[str, int] = {}
    per_axis: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for node in graph.nodes:
        if node.op not in COLLECTIVE_OPS:
            continue
        counts[node.op] = counts.get(node.op, 0) + 1
        axes = axis_names(node)
        if mesh is not None:
            k = _axes_size(axes, mesh)
        else:
            k = int(node.attrs.get("axis_size", 1))
        n = specs[node.output].nbytes * max(batch_size, 1)
        if k <= 1:
            moved = 0.0
        elif node.op == "psum":
            moved = 2.0 * n * (k - 1) / k
        elif node.op == "ppermute":
            moved = n / k
        else:
            moved = n * (k - 1) / k
        total += moved
        for ax in axes:
            slot = per_axis.setdefault(ax, {"count": 0, "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += moved / max(len(axes), 1)
    return {"counts": counts, "per_axis": per_axis,
            "total_bytes": int(total)}
