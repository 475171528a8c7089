"""Collectives as first-class graph ops, and the live mesh they run on.

The port of ``repro.dist.collectives``.  ``psum`` / ``all_gather`` /
``reduce_scatter`` / ``ppermute`` register through the ordinary plug-in
op machinery (``register_op`` + ``register_shape_rule`` +
``@register_lowering``), so every target handles them and
``cost_summary()`` counts them like any other node.

Their *value* semantics are the reference's:

* ``psum``, ``all_gather`` and ``reduce_scatter`` are logical
  identities: they mark the points where the propagated placement
  changes.  In the reference XLA's SPMD partitioner then moves the
  data; here each rank holds the *local* form of every tensor — the
  slice of its last dim that ``graph.dist["shardings"]`` gives this
  rank's coordinates on the live mesh — and a collective's lowering
  turns its input's local form into its output's: ``all_gather``
  gathers over the axis's subgroup (``DeviceMesh.get_group(axis)``),
  ``reduce_scatter`` keeps this rank's slice of a whole tensor, and
  ``psum`` passes an already-reduced value on (a row-parallel dense
  all-reduces its own partial sums before its epilogue; see
  ``core/lowering.py``).
* ``ppermute`` rolls the tensor by whole shards along ``dim``:
  ``shift`` shard-blocks of ``size/axis_size`` elements.  With
  ``axis_size`` 1 (no mesh, or a degenerate axis) the roll is a full
  revolution — the identity — so the same graph runs everywhere.

With no live mesh (no mesh, a single-device mesh, or an axis of size 1)
every collective is the identity and nothing talks to another process.
On a live mesh a collective of a CUDA tensor over a gloo group is staged
through the host (gloo's collectives take host tensors), as
``LiveMesh.stages`` decides for each tensor's device;
``cost_summary()["sharding"]`` reports it for the mesh's device.

Model code that autograd records (the mesh train step) uses the
conjugate pairs :func:`copy_to_model`, :func:`reduce_from_model`,
:func:`gather_rows`, :func:`gather_part` and :func:`split_to_model`,
whose backward is the collective the forward's placement implies;
:func:`all_reduce_` is a plain sum in place and :func:`all_max` a max
outside autograd.  The mesh step's params are held in part:
:func:`gather_param` gathers a leaf whole at use, and its backward is
:func:`reduce_scatter`, this rank's part of the reduced gradient; where
autograd does not record (the partitioned serving program) it is the
gather alone.  Serving's cache moves through :func:`gather_units` (the
ranks' ranges of a dim, which may overlap, made whole) and
:func:`exchange` (an all-to-all).

A collective of a tensor on the meta device moves nothing: its result
is one of the right shape (the mesh step reads which weights compute
cuts from a forward on the meta device).

Attrs:

    psum            axis            mesh axis (or list of axes) reduced over
    all_gather      axis, dim      gather ``dim`` back from ``axis``
    reduce_scatter  axis, dim      scatter ``dim`` across ``axis``
    ppermute        axis, shift    roll by ``shift`` shards along ``dim``
                                   (optional attrs: dim=-1, axis_size)
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.graph import register_op, register_shape_rule
from ..core.lowering import register_lowering

#: op name -> required attrs, as registered with the graph IR.
COLLECTIVE_OPS = {
    "psum": ("axis",),
    "all_gather": ("axis", "dim"),
    "reduce_scatter": ("axis", "dim"),
    "ppermute": ("axis", "shift"),
}

for _op, _attrs in COLLECTIVE_OPS.items():
    register_op(_op, _attrs)


def _identity_spec(node, input_specs, graph):
    """Collectives never change the logical tensor: same shape/dtype."""
    return input_specs[0]


for _op in COLLECTIVE_OPS:
    register_shape_rule(_op)(_identity_spec)


def axis_names(node) -> tuple:
    """The mesh axis (or axes) a collective node names, as a tuple."""
    ax = node.attrs["axis"]
    return (ax,) if isinstance(ax, str) else tuple(ax)


def declared_axis_size(node, ctx) -> int:
    """Static size of the collective's mesh axis: an explicit
    ``axis_size`` attr wins, else the mesh spec the lowering context
    carries, else 1 (no mesh: the degenerate, identity case)."""
    if "axis_size" in node.attrs:
        return int(node.attrs["axis_size"])
    sizes = getattr(ctx, "mesh_axis_sizes", None) or {}
    n = 1
    for ax in axis_names(node):
        n *= int(sizes.get(ax, 1))
    return n


class LiveMesh:
    """A mesh of more than one device, bound to the default process
    group: the ``DeviceMesh``, this rank's coordinates, a process group
    for every set of axes a collective may span, and whether collectives
    of ``device``'s tensors are staged through the host.

    Every rank must build its LiveMesh at the same point of its program:
    the groups of two or more axes (a mesh of three or more axes) are
    made here, and making a group takes every rank."""

    def __init__(self, spec, device: torch.device) -> None:
        import torch.distributed as dist
        self.spec = spec
        self.device_mesh = spec.build()
        self.sizes: Dict[str, int] = dict(spec.axes)
        coord = self.device_mesh.get_coordinate()
        self.coords: Dict[str, int] = dict(zip(spec.names, coord))
        self.backend = dist.get_backend()
        self.device = torch.device(device)
        self._groups = {(name,): self.device_mesh.get_group(name)
                        for name in spec.names}
        names = spec.names
        for r in range(2, len(names) + 1):
            for axes in itertools.combinations(names, r):
                self._groups[axes] = (dist.group.WORLD if r == len(names)
                                      else self._new_group(axes))

    def stages(self, device) -> bool:
        """True when a collective of a tensor on ``device`` goes through a
        host copy: a CUDA tensor over gloo, whose collectives take host
        tensors.  Not over NCCL, nor over the ``fake`` backend of a
        dry-run, which stands for one card a rank over NCCL."""
        return (torch.device(device).type == "cuda"
                and self.backend not in ("nccl", "fake"))

    @property
    def staged(self) -> bool:
        """Whether collectives of this mesh's device's tensors are staged
        through the host (:meth:`stages`)."""
        return self.stages(self.device)

    def _new_group(self, axes):
        """The subgroups spanning ``axes`` (the other axes fixed), made
        on every rank; returns this rank's."""
        import torch.distributed as dist
        ranks = torch.arange(self.spec.size).reshape(self.spec.shape)
        keep = [self.spec.names.index(a) for a in axes]
        rest = [i for i in range(len(self.spec.names)) if i not in keep]
        ranks = ranks.permute(*rest, *keep).reshape(-1, math.prod(
            self.sizes[a] for a in axes))
        mine, _ = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in ranks])
        return mine

    def canonical(self, axes: Iterable[str]) -> Tuple[str, ...]:
        """``axes`` that split anything (size > 1), in mesh order."""
        axes = set(axes)
        return tuple(a for a in self.spec.names
                     if a in axes and self.sizes[a] > 1)

    def split(self, axes: Iterable[str]) -> Tuple[int, int]:
        """(how many parts ``axes`` cut a dim into, this rank's part):
        row-major over the axes in mesh order, which is the order of a
        group's ranks."""
        k, i = 1, 0
        for a in self.canonical(axes):
            k *= self.sizes[a]
            i = i * self.sizes[a] + self.coords[a]
        return k, i

    def group(self, axes: Sequence[str]):
        return self._groups[self.canonical(axes)]

    def rank_of(self, axes: Iterable[str], part: int) -> int:
        """The global rank of the member of this rank's ``axes`` group
        that holds part ``part`` (the inverse of :meth:`split`)."""
        coords = dict(self.coords)
        for a in reversed(self.canonical(axes)):
            coords[a] = part % self.sizes[a]
            part //= self.sizes[a]
        rank = 0
        for name in self.spec.names:
            rank = rank * self.sizes[name] + coords[name]
        return rank


def local_part(x: torch.Tensor, k: int, i: int, dim: int = -1
               ) -> torch.Tensor:
    """Part ``i`` of ``k`` equal parts of ``x`` along ``dim``."""
    n = x.shape[dim]
    if n % k:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {k} equal parts")
    return x.narrow(dim, i * (n // k), n // k)


def _split(mesh: Optional[LiveMesh], axes) -> Tuple[int, int]:
    """(parts, this rank's part) of ``axes`` on ``mesh``; (1, 0) with no
    live mesh."""
    return (1, 0) if mesh is None else mesh.split(axes)


def _host(x: torch.Tensor, mesh: LiveMesh) -> bool:
    return mesh.stages(x.device)


def _summed(x: torch.Tensor, axes, mesh: LiveMesh, op=None
            ) -> torch.Tensor:
    """A new tensor: the sum (or ``op``, a ``ReduceOp``) of ``x`` over
    the ranks of ``axes``."""
    import torch.distributed as dist
    if x.device.type == "meta":
        return x.detach().clone()
    host = _host(x, mesh)
    buf = x.detach().to("cpu", copy=True) if host \
        else x.detach().contiguous().clone()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=mesh.group(axes))
    return buf.to(x.device) if host else buf


def _gathered(x: torch.Tensor, axes, mesh: LiveMesh, dim: int
              ) -> torch.Tensor:
    """A new tensor: the parts held by the ranks of ``axes``
    concatenated along ``dim`` in the ranks' order."""
    import torch.distributed as dist
    if x.device.type == "meta":
        return torch.cat([x.detach()] * mesh.split(axes)[0], dim=dim)
    host = _host(x, mesh)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.split(axes)[0])]
    dist.all_gather(parts, src, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


def all_reduce(x: torch.Tensor, axes, mesh: Optional[LiveMesh]
               ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, a new tensor (x
    itself with no live mesh or axes of size 1)."""
    if mesh is None or mesh.split(axes)[0] == 1:
        return x
    return _summed(x, axes, mesh)


def all_max(x: torch.Tensor, axes, mesh: Optional[LiveMesh]
            ) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``, a new
    tensor outside autograd (x, detached, with no live mesh)."""
    if mesh is None or mesh.split(axes)[0] == 1:
        return x.detach()
    import torch.distributed as dist
    return _summed(x, axes, mesh, dist.ReduceOp.MAX)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axes, ctx.mesh), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _summed(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim, sum_grad):
        ctx.axes, ctx.mesh, ctx.dim, ctx.sum_grad = axes, mesh, dim, sum_grad
        return _gathered(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = _summed(g, ctx.axes, ctx.mesh)
        part = local_part(g, *ctx.mesh.split(ctx.axes), ctx.dim)
        return part.contiguous(), None, None, None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return local_part(x, *mesh.split(axes), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


def _ranges(n: int, axes, mesh: LiveMesh):
    from ..distributed.sharding import unit_range
    k = mesh.split(axes)[0]
    return [unit_range(n, k, r) for r in range(k)]


def _pad_to(x: torch.Tensor, dim: int, most: int) -> torch.Tensor:
    """``x`` padded with zeros to ``most`` along ``dim`` (a rank's range
    to the largest, so the ranks' parts gather side by side)."""
    if x.shape[dim] >= most:
        return x
    dim = dim % x.ndim
    return torch.nn.functional.pad(
        x, [0, 0] * (x.ndim - 1 - dim) + [0, most - x.shape[dim]])


class _GatherPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim, n):
        ctx.axes, ctx.mesh, ctx.dim, ctx.n = axes, mesh, dim, n
        return gather_units(x, axes, mesh, dim, _ranges(n, axes, mesh), n)

    @staticmethod
    def backward(ctx, g):
        g = _summed(g, ctx.axes, ctx.mesh)
        lo, hi = _ranges(ctx.n, ctx.axes, ctx.mesh)[
            ctx.mesh.split(ctx.axes)[1]]
        return (g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None,
                None, None)


def gather_units(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
                 dim: int, ranges: Sequence[Tuple[int, int]],
                 n: int) -> torch.Tensor:
    """The whole of a dim of ``n`` units from the ranks' ranges of it
    (``ranges[r]`` is rank ``r``'s ``[lo, hi)``; ``x`` is this rank's):
    each part padded to the largest and gathered, every unit taken from
    the first rank whose range holds it.  Ranges may overlap (the KV
    heads two ranks' query heads share).  No autograd."""
    if _split(mesh, axes)[0] == 1:
        return x
    dim = dim % x.ndim
    most = max(hi - lo for lo, hi in ranges)
    return _owners(_gathered(_pad_to(x, dim, most), axes, mesh, dim), dim,
                   ranges, n, most)


def _owners(parts: torch.Tensor, dim: int, ranges, n: int, most: int
            ) -> torch.Tensor:
    """Units ``0..n`` along ``dim`` of ``parts``, the ranks' ranges laid
    side by side ``most`` units apart: each from the first rank whose
    range holds it.  The ranges run in order (each starts at or before
    the end of those before it, as the split rule makes them)."""
    runs, covered = [], 0
    for r, (lo, hi) in enumerate(ranges):
        if lo > covered:
            raise ValueError(f"the ranges {ranges} leave a gap at {covered}")
        if hi > covered:
            runs.append(parts.narrow(dim, r * most + covered - lo,
                                     hi - covered))
            covered = hi
    if covered != n:
        raise ValueError(f"the ranges {ranges} do not cover {n} units")
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim=dim)


def take(t: torch.Tensor, dim: int, idx: Sequence[int]) -> torch.Tensor:
    """``t.index_select(dim, idx)`` for host ints ``idx``.  On the meta
    device (the forward that reads which weights compute cuts runs there,
    under the dry-run's ``FakeTensorMode``, where an index made from host
    ints is no fake tensor) the same as narrowed runs of ``idx``."""
    idx = list(idx)
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return t.narrow(dim, idx[0], len(idx))
    if t.device.type != "meta":
        return t.index_select(dim, torch.tensor(idx, device=t.device))
    runs, start = [], 0
    for j in range(1, len(idx) + 1):
        if j == len(idx) or idx[j] != idx[j - 1] + 1:
            runs.append(t.narrow(dim, idx[start], j - start))
            start = j
    return torch.cat(runs, dim=dim)


def exchange(x: torch.Tensor, axes, mesh: Optional[LiveMesh], split_dim: int,
             cat_dim: int, ranges: Sequence[Tuple[int, int]],
             n: int) -> torch.Tensor:
    """An all-to-all over the ranks of ``axes``: ``x`` cut into equal
    parts along ``split_dim``, part ``r`` sent to rank ``r``; what each
    rank sent this rank laid along ``cat_dim``, where each rank holds its
    range ``ranges[r]`` of a dim of ``n`` units (as :func:`gather_units`
    takes them): the parts padded to the largest range, each unit taken
    from the first rank that holds it.  No autograd."""
    import torch.distributed as dist
    k = _split(mesh, axes)[0]
    if k == 1:
        return x
    split_dim, cat_dim = split_dim % x.ndim, cat_dim % x.ndim
    most = max(hi - lo for lo, hi in ranges)
    x = _pad_to(x, cat_dim, most)
    size = x.shape[split_dim]
    if size % k:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split into {k} equal parts")
    # parts first: (k, ...) with dim split_dim the part's
    shape = list(x.shape)
    shape[split_dim:split_dim + 1] = [k, size // k]
    src = x.reshape(shape).movedim(split_dim, 0)
    if x.device.type == "meta":
        got = src.detach().clone()
    else:
        host = _host(x, mesh)
        src = (src.detach().cpu() if host else src.detach()).contiguous()
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=mesh.group(axes))
        if host:
            got = got.to(x.device)
    # got[r] is rank r's part for this rank: lay the k along cat_dim
    out = torch.cat(torch.unbind(got, 0), dim=cat_dim)
    return _owners(out, cat_dim, ranges, n, most)


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# Megatron's conjugate pairs over a mesh axis group.  Each is x itself
# with no live mesh or axes of size 1; where autograd does not record x
# each is its forward alone (serving's numerics, no extra copy).
def copy_to_model(x: torch.Tensor, axes, mesh: Optional[LiveMesh]
                  ) -> torch.Tensor:
    """The identity; its backward sums the gradient over ``axes``.  The
    input of a computation that the ranks of ``axes`` split (each rank
    sees only its part's gradient of the whole ``x``)."""
    if _split(mesh, axes)[0] == 1 or not _recorded(x):
        return x
    return _CopyToModel.apply(x, tuple(axes), mesh)


def reduce_from_model(x: torch.Tensor, axes, mesh: Optional[LiveMesh]
                      ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``; its backward passes
    the gradient on unchanged.  The output of a split computation that
    every rank of ``axes`` then uses whole, the same way (never
    ``torch.distributed.nn``'s all-reduce, whose backward sums again)."""
    if _split(mesh, axes)[0] == 1:
        return x
    if not _recorded(x):
        return _summed(x, axes, mesh)
    return _ReduceFromModel.apply(x, tuple(axes), mesh)


def gather_rows(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
                dim: int = 0, sum_grad: bool = False) -> torch.Tensor:
    """The parts of ``x`` held by the ranks of ``axes`` concatenated
    along ``dim``; its backward keeps this rank's part of the gradient
    (every rank uses the gathered tensor whole, the same way), or with
    ``sum_grad`` this rank's part of the gradient summed over ``axes``
    (a reduce-scatter: each rank's loss reads the gathered tensor its own
    way, as a rank's share of the loss does in the mesh train step)."""
    if _split(mesh, axes)[0] == 1:
        return x
    if not _recorded(x):
        return _gathered(x, axes, mesh, dim)
    return _GatherRows.apply(x, tuple(axes), mesh, dim, sum_grad)


def gather_part(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
                dim: int, n: int) -> torch.Tensor:
    """The whole of a dim of ``n`` from each rank's range of it
    (``sharding.unit_range``; ``x`` is this rank's), concatenated along
    ``dim``; its backward sums the gradient over ``axes`` and keeps this
    rank's range (a reduce-scatter: each rank reads the whole its own
    way, as the RG-LRU's gates read every channel for their own)."""
    if _split(mesh, axes)[0] == 1:
        return x
    if not _recorded(x):
        return gather_units(x, axes, mesh, dim, _ranges(n, axes, mesh), n)
    return _GatherPart.apply(x, tuple(axes), mesh, dim, n)


def split_to_model(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
                   dim: int = -1) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim``; its backward gathers the
    parts' gradients over ``axes``, so a whole ``x`` that every rank
    computed gets its whole gradient on every rank."""
    k, i = _split(mesh, axes)
    if k == 1:
        return x
    if not _recorded(x):
        return local_part(x, k, i, dim)
    return _SplitToModel.apply(x, tuple(axes), mesh, dim)


def all_reduce_(x: torch.Tensor, axes, mesh: Optional[LiveMesh]
                ) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axes`` in place (no autograd) and
    return it; x itself, untouched, with no live mesh or axes of size 1.
    Every rank of the group ends with the same bits."""
    if _split(mesh, axes)[0] == 1:
        return x
    import torch.distributed as dist
    if _host(x, mesh) or not x.is_contiguous():
        x.copy_(_summed(x, axes, mesh))
    else:
        dist.all_reduce(x, group=mesh.group(axes))
    return x


class ParamPlan(NamedTuple):
    """How the mesh step gathers one param leaf (or one layer of a
    stacked leaf) it holds in part, and reduces its gradient: the cut
    dims it gathers over (``sharding.spec_cuts``; a ``model`` part that
    compute consumes left out), the axes its gradient sums over, the
    ``batch`` parts the sum is divided by, and the ``model`` part it
    keeps for compute (``sharding.held_part``: (dim from the end,
    parts), or None).  ``span`` (the serving program's): (the dim from
    the end, every ``model`` rank's ``[lo, hi)`` of it) where compute
    consumes a range that is no equal part: it is gathered from the
    ranks' equal parts (:func:`gather_span`), not whole."""
    gather: Tuple[Tuple[int, Tuple[str, ...]], ...]
    reduce: Tuple[str, ...]
    rows: int
    held: Optional[Tuple[int, int]]
    span: Optional[Tuple[int, Tuple[Tuple[int, int], ...]]] = None

    def layer(self) -> "ParamPlan":
        """The plan of one layer of a stacked leaf (the ``L`` dim, never
        cut, dropped)."""
        assert all(d > 0 for d, _ in self.gather), self.gather
        return self._replace(gather=tuple((d - 1, a)
                                          for d, a in self.gather))


def reduce_scatter(g: torch.Tensor, plan: ParamPlan,
                   mesh: LiveMesh) -> torch.Tensor:
    """This rank's part of a whole gradient: ``g`` summed in f32 over
    ``plan.reduce``'s ranks, cut along ``plan.gather``'s dims and
    divided by ``plan.rows``.  Gloo has no reduce-scatter,
    so the sum is an all-reduce of the whole (host-staged for a CUDA
    tensor), which moves what the whole leaf's reduce moved before."""
    g = g.float()
    if mesh.split(plan.reduce)[0] > 1:
        g = _summed(g, plan.reduce, mesh)
    for dim, axes in plan.gather:
        g = local_part(g, *mesh.split(axes), dim)
    return (g / plan.rows if plan.rows > 1 else g).contiguous()


def _gather_whole(x: torch.Tensor, plan: ParamPlan,
                  mesh: LiveMesh) -> torch.Tensor:
    for dim, axes in plan.gather:
        x = _gathered(x, axes, mesh, dim)
    if plan.span is not None:
        x = gather_span(x, ("model",), mesh, *plan.span)
    return x


def gather_span(x: torch.Tensor, axes, mesh: LiveMesh, dim: int,
                ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This rank's range ``ranges[i]`` of a dim that the ranks of
    ``axes`` hold in equal parts (``x`` is this rank's): an all-to-all
    in which each rank sends each other the rows of its part that the
    other's range holds (the ranges may overlap, and differ in size).
    No autograd."""
    import torch.distributed as dist
    k, i = mesh.split(axes)
    p = x.shape[dim]

    def overlap(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    mine = (i * p, (i + 1) * p)
    send = [overlap(mine, r) for r in ranges]
    recv = [overlap((r * p, (r + 1) * p), ranges[i]) for r in range(k)]
    sizes_in = [max(0, hi - lo) for lo, hi in send]
    sizes_out = [max(0, hi - lo) for lo, hi in recv]
    src = x.movedim(dim, 0)
    shape = (sum(sizes_out),) + tuple(src.shape[1:])
    if x.device.type == "meta":
        return torch.empty(shape, dtype=x.dtype,
                           device=x.device).movedim(0, dim)
    host = _host(x, mesh)
    src = torch.cat([src[lo - mine[0]:hi - mine[0]]
                     for (lo, hi), n in zip(send, sizes_in) if n]
                    or [src[:0]])
    src = (src.detach().cpu() if host else src.detach()).contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=src.device)
    dist.all_to_all_single(out, src, sizes_out, sizes_in,
                           group=mesh.group(axes))
    out = out.to(x.device) if host else out
    return out.movedim(0, dim)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, src, whole, plan, mesh):
        ctx.plan, ctx.mesh = plan, mesh
        if whole is not None:
            return whole.view_as(whole)
        return _gather_whole(part if src is None else src, plan, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.plan, ctx.mesh), None, None, None, None


def gather_param(part: torch.Tensor, plan: ParamPlan, mesh: LiveMesh,
                 src: Optional[torch.Tensor] = None,
                 whole: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole of a param leaf this rank holds ``part`` of, gathered
    along ``plan.gather``'s dims (a ``model`` part that compute consumes
    stays the part, marked ``held_part``); its backward is
    :func:`reduce_scatter`, so ``part`` gets its part of the reduced
    gradient, in f32.  ``src`` is what to gather in ``part``'s place
    (its bf16 copy), ``whole`` what was gathered of it already (once a
    step); either way the gradient is ``part``'s.  Where autograd does
    not record (serving) it is the gather alone."""
    if whole is None and not plan.gather and plan.span is None:
        whole = part if src is None else src
    if not torch.is_grad_enabled():
        out = whole.view_as(whole) if whole is not None else \
            _gather_whole(part if src is None else src, plan, mesh)
    else:
        out = _GatherParam.apply(part, src, whole, plan, mesh)
    if plan.held is not None:       # on the tensor its views are taken of
        for t in (out, out._base):
            if t is not None:
                t.held_part = plan.held
    if plan.span is not None:
        dim, ranges = plan.span
        lo, hi = ranges[mesh.split(("model",))[1]]
        out.held_span = (dim, lo, hi, part.shape[dim] * len(ranges))
    return out


def destroy_process_group() -> None:
    """Tear down the default process group and every group made from
    it.  Garbage that still holds a group (a finished scheduler's
    LiveMesh in a reference cycle) is collected first, so each group is
    freed here: a gloo group freed only at interpreter exit can abort
    the process there."""
    import gc
    import torch.distributed as dist
    gc.collect()
    dist.destroy_process_group()


def all_gather(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
               dim: int = -1) -> torch.Tensor:
    """The parts of ``x`` held by the ranks of ``axes``, concatenated
    along ``dim`` in the ranks' order (x itself with no live mesh)."""
    if mesh is None or mesh.split(axes)[0] == 1:
        return x
    return _gathered(x, axes, mesh, dim)


def broadcast(x: torch.Tensor, axes, mesh: Optional[LiveMesh],
              part: int) -> torch.Tensor:
    """The ``x`` of the rank that holds part ``part`` along ``axes``, on
    every rank of that group (x itself with no live mesh)."""
    if mesh is None or mesh.split(axes)[0] == 1 or x.device.type == "meta":
        return x
    import torch.distributed as dist
    host = _host(x, mesh)
    buf = x.detach().to("cpu", copy=True) if host \
        else x.detach().contiguous().clone()
    dist.broadcast(buf, src=mesh.rank_of(axes, part), group=mesh.group(axes))
    return buf.to(x.device) if host else buf


def relayout(x: torch.Tensor, have, want, mesh: Optional[LiveMesh]
             ) -> torch.Tensor:
    """Turn the local form of a tensor whose last dim is split over the
    axes ``have`` into its local form split over ``want``: gather what
    ``have`` split, keep this rank's part of what ``want`` splits."""
    if mesh is None:
        return x
    have, want = mesh.canonical(have or ()), mesh.canonical(want or ())
    if have == want:
        return x
    if have:
        x = all_gather(x, have, mesh)
    if want:
        x = local_part(x, *mesh.split(want)).contiguous()
    return x


def communicates(node, ctx) -> bool:
    """True when the node's lowering talks to other ranks on ``ctx``'s
    live mesh (which forbids capturing it into a CUDA graph over gloo)."""
    if node.op == "dense":
        return bool(ctx.split_axes(node.inputs[0]))
    if node.op not in COLLECTIVE_OPS:
        return False
    have = ctx.split_axes(node.inputs[0])
    return bool(have) and (have != ctx.split_axes(node.output)
                           or node.op == "ppermute")


def _lower_relayout(node, ins, ctx):
    """psum / all_gather / reduce_scatter: the identity on the logical
    value; the local form changes from the input's placement to the
    output's."""
    return relayout(ins[0], ctx.split_axes(node.inputs[0]),
                    ctx.split_axes(node.output), ctx.mesh)


for _op in ("psum", "all_gather", "reduce_scatter"):
    register_lowering(_op)(_lower_relayout)


@register_lowering("ppermute")
def _lower_ppermute(node, ins, ctx):
    x = relayout(ins[0], ctx.split_axes(node.inputs[0]), None, ctx.mesh)
    dim = int(node.attrs.get("dim", -1))
    size = x.shape[dim]
    k = max(declared_axis_size(node, ctx), 1)
    block = size // k
    shift = (int(node.attrs["shift"]) * block) % max(size, 1)
    if shift:
        x = torch.roll(x, shift, dims=dim)
    return relayout(x, None, ctx.split_axes(node.output), ctx.mesh)
