"""Logical-axis sharding rules (MaxText-style).

The port of ``repro.distributed.sharding``.  Model code annotates
tensors with *logical* axis names; the rules table maps them to mesh
axes of whatever mesh is active.  The graph compiler's propagation pass
(``repro_torch.dist.propagate``) reads the same table.  With no mesh
every annotation is a no-op, so the same model code runs everywhere.

The active mesh is a :class:`repro_torch.dist.collectives.LiveMesh` (one
process a device).  :func:`logical` returns its tensor and
:func:`named_sharding` describes where a tensor's parts would live; the
partitioned compute is written out in the models, where the reference's
constraints let GSPMD split it.  Two programs split it, each a
:func:`use_mesh` with ``local_batch`` and a ``gather`` (the params'
gathers at use):

* the mesh train step (``training.train.make_mesh_train_step``) and the
  partitioned serving program (``launch.cells.serve_program``, the
  reference's prefill and decode cells): each rank holds only its
  ``batch`` rows, and over ``model`` everything the reference's
  constraints put there (``heads``, ``kv_heads``, ``mlp``, ``vocab``):
  a rank computes its attention heads (and the KV heads they read), its
  MLP columns, its channels of the RG-LRU and its vocab rows of the
  embedding and the logits, and, in training, the cross-entropy
  (:func:`model_part`: the contiguous units ``[⌈r·n/k⌉, ⌈(r+1)·n/k⌉)``
  of ``n`` on rank ``r`` of ``k``).  Mamba2's mixer, MLA's down
  projections and the MoE router stay whole; the routed experts are
  expert-parallel.  The train step's loss averages over the global
  batch and it reduces each gradient over the ``batch`` axes;
* the serving program holds its cache as the reference's placement
  does (``kv_seq`` over ``model``: flash-decoding, each rank attending
  over its part of the sequence; where ``model`` does not divide the
  sequence, ``heads`` over ``model`` or whole), each cache leaf held in
  part marked as :func:`held_part` says (:func:`held_range`);
* the serve scheduler, on a mesh with a ``model`` axis but no
  ``gather``, splits only the row- and column-parallel projections under
  ``tp_psum`` and the expert-parallel MoE, as the reference's
  ``shard_map`` branches; on one device nothing is split.

Model code marks each weight it cuts with :func:`split_param`, and the
programs read those marks from a forward on the meta device
(:func:`recording_splits`), so the rule lives where the cut is made.

The params' placement is the reference's: :func:`placements`
(``_divisible_sharding``: a logical axis is kept only where its mesh
axes divide the dim) of the param axes, a rank holding its part of each
leaf (:func:`part_of`).  Both programs gather the parts at use (the
``gather`` a :func:`use_mesh` carries, which ``models.common`` calls
for each layer); a weight whose ``model`` part is the range compute
consumes (the split divides the units evenly) stays that part
(:func:`held_part`, :func:`whole_dim`); any other cut weight is gathered
whole and sliced.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

#: logical axis -> mesh axis (or tuple of mesh axes).  "batch" composes
#: pod×data so a multi-pod mesh is pure DP across pods by default.  A
#: copy of the reference's table, entry for entry.
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,             # sequence kept replicated by default ...
    "seq_shard": "data",     # ... except where context parallelism is on
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_capacity": None,
    "vocab": "model",
    # Decode KV caches shard the SEQUENCE dim over "model"
    # (flash-decoding layout).
    "kv_seq": "model",
    "conv": None,
    "state": None,
    "frames": None,
    # Parameter-only axes: "fsdp" shards the weight fan-in dim over the
    # data axis; "layers" is the stacked-layer dim.
    "fsdp": "data",
    "layers": None,
}

_local = threading.local()


def current_rules() -> Dict[str, AxisVal]:
    """The rules of the innermost :func:`use_mesh`, else DEFAULT_RULES."""
    return getattr(_local, "rules", DEFAULT_RULES)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` (a ``LiveMesh``), or
    None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, AxisVal]] = None,
             local_batch: bool = False, gather=None):
    """Activate a mesh (a ``LiveMesh`` or None) and rules (merged over
    DEFAULT_RULES) for model-code annotations, on this thread.
    ``local_batch``: each rank's inputs are only its ``batch`` rows (the
    mesh train step), so no layer splits rows again, and the loss is
    the global batch's.  ``gather``: the mesh step's gathers of the
    stacked layer leaves it holds in part (:func:`current_gather`)."""
    prev_mesh = getattr(_local, "mesh", None)
    prev_rules = getattr(_local, "rules", None)
    prev_local = getattr(_local, "local_batch", False)
    prev_gather = getattr(_local, "gather", None)
    _local.mesh = mesh
    _local.rules = {**DEFAULT_RULES, **(rules or {})}
    _local.local_batch = bool(local_batch) and mesh is not None
    _local.gather = gather if mesh is not None else None
    try:
        yield
    finally:
        _local.mesh = prev_mesh
        _local.local_batch = prev_local
        _local.gather = prev_gather
        if prev_rules is None:
            if hasattr(_local, "rules"):
                del _local.rules
        else:
            _local.rules = prev_rules


def current_context():
    """This thread's mesh, rules, ``local_batch`` and gather, for
    :func:`use_context` on another thread (autograd's backward runs a
    recomputed layer on a device thread of its own)."""
    return (getattr(_local, "mesh", None), getattr(_local, "rules", None),
            getattr(_local, "local_batch", False),
            getattr(_local, "gather", None))


@contextlib.contextmanager
def use_context(ctx):
    """Activate what :func:`current_context` returned, on this thread."""
    mesh, rules, local, gather = ctx
    with use_mesh(mesh, rules, local_batch=local, gather=gather):
        yield


def current_gather():
    """The active mesh step's gathers, or None: an object whose
    ``owns(t)`` says whether ``t`` is a stacked leaf held in part,
    ``layers(t, n)`` cuts such a leaf into its layers' parts, and
    ``at_use(args)`` gathers the layers' parts in a layer body's
    arguments whole (``models.common.layer_views`` / ``maybe_remat``)."""
    return getattr(_local, "gather", None)


#: The mesh axes the ``batch`` rows split over (``DEFAULT_RULES``).
BATCH_AXES = ("pod", "data")


def local_batch():
    """(the mesh, parts, this rank's part) of the ``batch`` rows when the
    active mesh holds each rank's rows alone and they are split; else
    None."""
    mesh = current_mesh()
    if mesh is None or not getattr(_local, "local_batch", False):
        return None
    k, i = mesh.split(BATCH_AXES)
    return None if k == 1 else (mesh, k, i)


@contextlib.contextmanager
def recording_splits():
    """Record, on this thread, every tensor model code cuts to this
    rank's part with :func:`split_param`: (its root tensor, the param
    leaf a layer's view was taken from; the dim cut, counted from the
    end; whether the range is the rank's equal part; the range ``(lo,
    hi)``).  Yields the list."""
    prev = getattr(_local, "splits", None)
    _local.splits = []
    try:
        yield _local.splits
    finally:
        _local.splits = prev


def _root(w):
    return w if w._base is None else w._base


def held_part(w) -> Optional[Tuple[int, int]]:
    """(the dim counted from the end, parts) where ``w`` (or the tensor
    it is a view of) is already this rank's ``model`` part of a weight
    whose compute ``model`` splits along that dim: the mesh step gathers
    such a leaf over its other axes only.  None for a whole weight."""
    held = getattr(w, "held_part", None)
    return held if held is not None or w._base is None \
        else getattr(w._base, "held_part", None)


def held_span(w) -> Optional[Tuple[int, int, int, int]]:
    """(the dim counted from the end, lo, hi, the whole dim's size) where
    ``w`` (or the tensor it is a view of) is already the range ``[lo,
    hi)`` of a weight's dim that compute consumes, gathered from each
    rank's equal part (the serving program's ranges that are no equal
    part: ``dist.collectives.gather_span``).  None otherwise."""
    span = getattr(w, "held_span", None)
    return span if span is not None or w._base is None \
        else getattr(w._base, "held_span", None)


def whole_dim(w, dim: int) -> int:
    """The size of ``w``'s whole along ``dim``: ``w.shape[dim]``, times
    the parts where ``w`` holds only its ``model`` part along it, or the
    whole dim's where it holds a range of it (:func:`held_span`)."""
    held = held_part(w)
    neg = dim - w.ndim if dim >= 0 else dim
    n = w.shape[dim]
    if held is not None and held[0] == neg:
        n *= held[1]
    span = held_span(w)
    if span is not None and span[0] == neg:
        n = span[3]
    return n


def unit_range(n: int, k: int, i: int) -> Tuple[int, int]:
    """The split rule: rank ``i`` of ``k`` takes the contiguous units
    ``[⌈i·n/k⌉, ⌈(i+1)·n/k⌉)`` of ``n`` whole units (heads, MLP columns,
    vocab rows).  Rank 0 takes ⌈n/k⌉, the most any rank takes; where
    ``k`` divides ``n`` each range is :func:`part_of`'s part."""
    return -(-i * n // k), -(-(i + 1) * n // k)


class Part(NamedTuple):
    """This rank's range ``[lo, hi)`` of a dim of ``n`` (rank ``i`` of
    ``k`` on ``model``)."""
    lo: int
    hi: int
    n: int
    k: int
    i: int

    @property
    def size(self) -> int:
        return self.hi - self.lo

    @property
    def even(self) -> bool:
        """Whether the range is the rank's equal part of the dim, the part
        :func:`part_of` places on it."""
        return (self.n % self.k == 0 and self.size == self.n // self.k
                and self.lo == self.i * self.size)

    def times(self, unit: int) -> "Part":
        """The range in elements, a unit being ``unit`` of them (a head's
        ``head_dim`` columns)."""
        return Part(self.lo * unit, self.hi * unit, self.n * unit, self.k,
                    self.i)


def equal_part(n: int, k: int, i: int) -> Part:
    """Part ``i`` of ``k`` equal parts of a dim of ``n`` (``k`` divides
    ``n``): :func:`part_of`'s part."""
    return Part(i * (n // k), (i + 1) * (n // k), n, k, i)


def model_split():
    """(the mesh, parts, this rank's part) of the ``model`` axis where
    compute is partitioned over it: in the mesh train step or the
    partitioned serving program (a :func:`use_mesh` with ``local_batch``
    and a ``gather``) on a mesh whose ``model`` axis splits; else
    None."""
    mesh = current_mesh()
    if mesh is None or not getattr(_local, "local_batch", False) or \
            getattr(_local, "gather", None) is None:
        return None
    k, i = mesh.split(("model",))
    return None if k == 1 else (mesh, k, i)


def held_range(t, dim: int) -> Optional[Part]:
    """This rank's range of ``t``'s dim ``dim`` where ``t`` (or the
    tensor it is a view of) holds only its ``model`` part along it
    (:func:`held_part`) and compute is split over ``model``: the equal
    part of the whole dim (:func:`whole_dim`).  None where ``t`` is whole
    along ``dim``."""
    held = held_part(t)
    split = model_split()
    if held is None or split is None or \
            held[0] != (dim - t.ndim if dim >= 0 else dim):
        return None
    return equal_part(whole_dim(t, dim), split[1], split[2])


def kv_ranges(n_heads: int, n_kv: int, k: int) -> List[Tuple[int, int]]:
    """The range of KV heads each of ``k`` ranks reads: those of its
    query heads (:func:`unit_range` of ``n_heads``), ``n_heads //
    n_kv`` query heads to a KV head.  Two ranks' ranges overlap where a
    KV head's query heads fall on both."""
    g = n_heads // n_kv
    out = []
    for r in range(k):
        lo, hi = unit_range(n_heads, k, r)
        out.append((lo // g, -(-hi // g)))
    return out


def psum_parts(tp_psum: bool, dims) -> Optional[list]:
    """Serving's split over ``model`` (the reference's ``shard_map``
    branches): under ``tp_psum`` on a live mesh whose ``model`` axis
    splits and divides every one of ``dims``, this rank's equal part of
    each (:func:`equal_part`); else None."""
    mesh = current_mesh() if tp_psum else None
    if mesh is None:
        return None
    k, i = mesh.split(("model",))
    if k == 1 or any(d % k for d in dims):
        return None
    return [equal_part(d, k, i) for d in dims]


def model_part(n: int, unit: int = 1) -> Optional[Part]:
    """This rank's range of ``n`` units (:func:`unit_range`), in elements
    of ``unit`` each, where compute is partitioned over ``model``
    (:func:`model_split`); else None (every unit).  A dim of fewer units
    than ``model`` has ranks is computed whole on every rank (None), as
    the reference's divisibility rule drops such a constraint, so no
    rank gets an empty range."""
    split = model_split()
    if split is None:
        return None
    _, k, i = split
    if n < k:
        return None
    return Part(*unit_range(n, k, i), n, k, i).times(unit)


def split_param(w, dim: int, part: Part):
    """The range ``part`` of the weight ``w`` along ``dim``: a rank's
    share of a weight whose compute the ``model`` axis splits, recorded
    with whether it is the rank's equal part (:func:`recording_splits`).
    A weight that is that part already (:func:`held_part`) is returned as
    it is."""
    neg = dim - w.ndim if dim >= 0 else dim
    splits = getattr(_local, "splits", None)
    if splits is not None:
        splits.append((_root(w), neg, part.even, (part.lo, part.hi)))
    span = held_span(w)
    if span is not None and span[:3] == (neg, part.lo, part.hi):
        return w
    held = held_part(w)
    if held is not None and held == (neg, part.k):
        if not part.even:
            raise ValueError(f"a weight held as its equal part along dim "
                             f"{neg} cannot give the range {part}")
        return w
    return w.narrow(dim, part.lo, part.size)


def spec_for(*logical_axes: Optional[str]) -> tuple:
    """The partition spec for a tuple of logical axis names, as a plain
    tuple (an entry per dim: None, a mesh axis name, or a tuple of
    names), deduplicating mesh axes: a mesh axis may appear at most
    once in a spec."""
    rules = current_rules()
    used = set()
    parts = []
    for ax in logical_axes:
        val = rules.get(ax) if ax else None
        if val is None:
            parts.append(None)
            continue
        axes = (val,) if isinstance(val, str) else tuple(val)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
            used.add(axes[0])
        else:
            parts.append(axes)
            used.update(axes)
    return tuple(parts)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of ``mesh``: a ``LiveMesh``, a ``MeshSpec`` or a
    ``DeviceMesh``."""
    spec = getattr(mesh, "spec", mesh)
    if hasattr(spec, "names"):
        return tuple(spec.names)
    return tuple(mesh.mesh_dim_names)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of ``mesh`` (1 with no mesh or no such
    axis)."""
    if mesh is None:
        return 1
    spec = getattr(mesh, "spec", mesh)
    return dict(spec.axes).get(name, 1)


def _keep(spec: tuple, names) -> tuple:
    """``spec`` with the mesh axes ``names`` lacks dropped (the
    reference's ``keep``: "pod" on a 2-D mesh); one axis left of a
    tuple is the bare name, as a ``PartitionSpec`` holds it."""
    def keep(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept[0] if len(kept) == 1 else (kept or None)
    return tuple(keep(v) for v in spec)


class Placement(NamedTuple):
    """The port's ``NamedSharding``: a partition spec (an entry per dim:
    None, a mesh axis, or a tuple of axes) on a mesh."""
    mesh: object
    spec: tuple


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of ``mesh`` (a ``LiveMesh`` or ``MeshSpec``)."""
    spec = getattr(mesh, "spec", mesh)
    return dict(spec.axes)


def divisible_placement(mesh, shape, axes) -> tuple:
    """The partition spec of one leaf of ``shape`` with logical ``axes``
    on ``mesh`` (a ``LiveMesh`` or ``MeshSpec``), keeping a logical axis
    only where its mesh axes evenly divide the dim (vocab=122753 or
    kv_heads=8 on a 16-way axis stay replicated): the reference's
    ``_divisible_sharding(...).spec``, candidate for candidate (the
    whole tuple first, then each single axis), a mesh axis used once."""
    rules = current_rules()
    sizes = mesh_sizes(mesh)
    parts = []
    used = set()
    for dim, ax in zip(shape, tuple(axes) + (None,) * len(shape)):
        val = rules.get(ax) if ax else None
        if val is None:
            parts.append(None)
            continue
        cand = (val,) if isinstance(val, str) else tuple(val)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        pick = None
        options = [cand] + [(a,) for a in cand] if len(cand) > 1 \
            else [cand]
        for opt in options:
            if not opt:
                continue
            size = math.prod(sizes[a] for a in opt)
            if size > 1 and dim % size == 0:
                pick = opt
                break
        if pick is None:
            parts.append(None)
        else:
            parts.append(pick[0] if len(pick) == 1 else pick)
            used.update(pick)
    return tuple(parts)


def placements(mesh, axes_tree, shapes_tree):
    """:func:`divisible_placement` of every leaf (the reference's
    ``_shardings``): ``axes_tree`` and ``shapes_tree`` (tensors or
    shapes) are nested dicts with the same keys."""
    from ..models.common import tree_flatten, tree_unflatten
    axes = dict(tree_flatten(axes_tree))
    return tree_unflatten(
        [p for p, _ in tree_flatten(shapes_tree)],
        [divisible_placement(mesh, tuple(getattr(t, "shape", t)), axes[p])
         for p, t in tree_flatten(shapes_tree)])


def spec_cuts(mesh, spec) -> List[Tuple[int, Tuple[str, ...]]]:
    """The dims a partition spec cuts on ``mesh``: ``[(dim, mesh axes)]``,
    the axes of size 1 left out (a dim they alone name is whole)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if axes:
            out.append((dim, axes))
    return out


def part_shape(mesh, shape, cuts) -> Tuple[int, ...]:
    """The shape of one rank's part of a leaf of ``shape`` cut by
    ``cuts`` (:func:`spec_cuts`)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for dim, axes in cuts:
        out[dim] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def part_of(whole, cuts, mesh):
    """This rank's part of ``whole`` (a tensor or numpy array) on the live
    ``mesh``: along each cut dim, the part :meth:`LiveMesh.split` gives
    the rank (row-major over the dim's axes in mesh order).  Views."""
    for dim, axes in cuts:
        k, i = mesh.split(axes)
        n = whole.shape[dim] // k
        if hasattr(whole, "narrow"):
            whole = whole.narrow(dim, i * n, n)
        else:
            index = [slice(None)] * whole.ndim
            index[dim] = slice(i * n, (i + 1) * n)
            whole = whole[tuple(index)]
    return whole


def logical(x, *logical_axes: Optional[str]):
    """The sharding constraint by logical axis names: ``x`` itself, with
    or without an active mesh (the models write the split it implies
    out: module docstring)."""
    return x


def named_sharding(mesh, *logical_axes: Optional[str]) -> Placement:
    """The placement of a tensor with these logical axes on ``mesh`` (a
    ``LiveMesh``, ``MeshSpec`` or ``DeviceMesh``): the partition spec
    under the current rules, the mesh's missing axes dropped."""
    names = set(mesh_axis_names(mesh))
    return Placement(mesh, _keep(spec_for(*logical_axes), names))
