"""Train-step factory: microbatched gradient accumulation, gradient
compression with error feedback, AdamW — the port of
``repro.training.train``, on one device or over a mesh of ranks.

The step runs eagerly: the loss, ``torch.autograd.grad`` over the param
leaves, then AdamW.  The reference's ``lax.scan`` over microbatches is
a Python loop here, each microbatch's graph freed after its backward;
its donated state is an update in place (``donate=True``: every state
tensor keeps its storage).  Params are stacked ``(L, ...)`` leaves, so
an optimizer step is one update per leaf, about 15 leaves of work.

Gradient compression: cross-microbatch gradients are carried in bf16
with an f32 error-feedback accumulator (the round-off is fed back into
the next microbatch's gradient before quantization), so the persistent
accumulator is half-width while the update stays unbiased in
expectation.

**The mesh step** (a mesh of more than one device: one process a rank
of a ``torch.distributed`` group that the mesh fills) computes what the
reference's GSPMD program computes on that mesh:

* *rows*: each rank is given only its rows of the global batch
  (:func:`rank_rows`, :func:`local_batch`), in the reference's
  grouping: microbatch ``i`` is global rows ``[i·B/n, (i+1)·B/n)``, and
  its rows are split over the ``batch`` axes (``pod``, ``data``);
  ``model`` ranks of one row part hold the same rows;
* *the loss*: each rank's cross-entropy divides by the global
  microbatch's share of unmasked labels, so the mean over the ``batch``
  ranks is the global mean.  A MoE on a mesh with a ``model`` axis
  routes each row part alone (capacity and aux loss the part's own, as
  the reference's ``shard_map`` does), the reported loss holding the
  first part's aux loss (``Model.loss``); on a mesh without one it
  routes the whole microbatch, as the reference's GSPMD program does
  (``moe.whole_microbatch``);
* *split compute*: the ``tp_psum`` projections and the expert-parallel
  MoE run their ``model`` collectives through autograd-aware conjugate
  pairs (``dist.collectives``), so every leaf whose compute ``model``
  does not split gets its whole gradient on every ``model`` rank;
* *the gradient reduce*, leaf by leaf, after the microbatches (and
  after ``compress_grads``' bf16 accumulator, per rank): a mean over
  the ``batch`` axes, plus a sum over ``model`` for the leaves that
  ``model`` splits in compute and the rank holds whole: the weights
  model code cut with ``sharding.split_param`` in this step's own
  forward (``step.cut_leaves`` names them).  A leaf a rank holds only
  its part of (the routed experts cut by :func:`shard_params`, as
  :class:`StateLayout` says) needs no ``model`` sum; its squares are
  summed over ``model`` for ``grad_norm``;
* *the update*: every rank applies AdamW to the same gradients, so the
  params and moments stay bit-equal across their replicas.

Collectives go through gloo (staged through the host for CUDA tensors),
so ranks may share a card; NCCL and a step captured as CUDA graphs are
later work.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import BATCH_AXES, recording_splits, use_mesh
from ..models.api import Model
from ..models.common import tree_flatten, tree_unflatten
from . import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optim.OptConfig = dataclasses.field(default_factory=optim.OptConfig)
    microbatches: int = 1           # grad-accumulation steps
    compress_grads: bool = False    # bf16 accumulator + error feedback
    cast_params: bool = False       # compute layers on a bf16 copy of the
                                    # f32 masters, made once a step
    pregather_params: bool = False  # the reference's placement of that
                                    # copy; the port holds tensors whole,
                                    # so it changes nothing


def init_state(model: Model, seed: int = 0, device="cuda",
               mesh=None) -> Dict[str, Any]:
    """Params drawn from ``seed`` on ``device`` and a fresh AdamW state;
    on a live ``mesh`` the rank's part of them (:func:`shard_params`),
    the moments made for that part only."""
    params = model.init(seed, device)
    if mesh is not None:
        params = shard_params(model, params, mesh)
    return {"params": params, "opt": optim.adamw_init(params)}


def state_axes(model: Model) -> Dict[str, Any]:
    axes = model.param_axes()
    return {"params": axes, "opt": optim.opt_state_axes(axes)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------
def _grad_fn(model: Model, tc: TrainConfig, params, batch, record: bool
             ) -> Tuple[torch.Tensor, List[torch.Tensor], List[bool]]:
    """(loss, the gradient of each param leaf in flatten order, in the
    leaf's dtype, and whether model code cut the leaf to this rank's
    part: ``record`` only).  Under ``cast_params`` the loss runs on a
    bf16 copy of every f32 leaf with two or more dims, and the copy's
    gradient, cast back to f32, is the master's: the reference's
    gradient through the cast."""
    paths, leaves = zip(*tree_flatten(params))
    inputs = []
    for p in leaves:
        if tc.cast_params and p.dtype == torch.float32 and p.ndim >= 2:
            p = p.to(torch.bfloat16)
        inputs.append(p.detach().requires_grad_())
    with torch.enable_grad():
        with (recording_splits() if record
              else contextlib.nullcontext([])) as cut:
            loss = model.loss(tree_unflatten(list(paths), inputs), batch)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                    materialize_grads=True)
    cut = {id(t) for t in cut}
    return (loss.detach(), [g.to(p.dtype) for g, p in zip(grads, leaves)],
            [id(x) in cut for x in inputs])


def _accumulate(model: Model, tc: TrainConfig, params, batch,
                record: bool = False):
    """(loss, gradients, cut flags) of ``batch`` over ``tc.microbatches``:
    the gradients of one pass in each leaf's dtype, or the f32 mean of
    the microbatches' (through the bf16 accumulator under
    ``compress_grads``)."""
    n = tc.microbatches
    if n == 1:
        return _grad_fn(model, tc, params, batch, record)
    for v in batch.values():
        assert v.shape[0] % n == 0, (v.shape[0], n)
    leaves = [p for _, p in tree_flatten(params)]
    gdtype = torch.bfloat16 if tc.compress_grads else torch.float32
    acc = [torch.zeros(p.shape, dtype=gdtype, device=p.device)
           for p in leaves]
    err = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves] if tc.compress_grads else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    cut = [False] * len(leaves)
    for i in range(n):
        # one region a microbatch: the dry-run's op counter takes what
        # one more microbatch adds from it (launch/op_analysis.py)
        with torch.profiler.record_function("microbatch"):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, grads, mb_cut = _grad_fn(model, tc, params, mb, record)
            cut = [a or b for a, b in zip(cut, mb_cut)]
            for j, g in enumerate(grads):
                if tc.compress_grads:
                    # quantize with error feedback: e <- (g+e) - bf16(g+e)
                    corrected = g.float() + err[j]
                    q = corrected.to(torch.bfloat16)
                    err[j] = corrected - q.float()
                    acc[j] = acc[j] + q
                else:
                    acc[j] = acc[j] + g.float()
            loss_sum = loss_sum + loss
    return loss_sum / n, [a.float() / n for a in acc], cut


def _as_tree(params, flat):
    return tree_unflatten([p for p, _ in tree_flatten(params)], flat)


def make_train_step(model: Model, tc: TrainConfig,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)`` on one
    device, metrics ``{"loss", "lr", "grad_norm"}`` as 0-d tensors on
    the state's device.  ``batch`` holds numpy arrays or tensors;
    ``donate`` updates the state in place and returns it."""

    def step(state, batch):
        batch = _on_device(batch, state["opt"]["step"].device)
        loss, grads, _ = _accumulate(model, tc, state["params"], batch)
        params, opt, m = optim.adamw_update(
            tc.opt, state["params"], _as_tree(state["params"], grads),
            state["opt"], inplace=donate)
        metrics = {"loss": loss, **m}
        return (state if donate else {"params": params, "opt": opt}), metrics

    return step


# ---------------------------------------------------------------------------
# A mesh of ranks
# ---------------------------------------------------------------------------
def _spec(mesh):
    from ..dist.mesh import MeshSpec
    return MeshSpec.coerce(getattr(mesh, "spec", mesh))


def rank_rows(global_batch: int, microbatches: int, mesh
              ) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` ranges of the global batch's rows this rank of
    the live ``mesh`` holds, in order: its part of each microbatch
    (microbatch ``i`` is rows ``[i·B/n, (i+1)·B/n)``, split over the
    ``batch`` axes), so the step's own microbatch split of the rank's
    rows keeps the reference's grouping."""
    k, part = mesh.split(BATCH_AXES)
    n = microbatches
    if global_batch % (n * k):
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {n} microbatches over {k} row parts")
    per = global_batch // (n * k)
    return [(i * (global_batch // n) + part * per,
             i * (global_batch // n) + (part + 1) * per) for i in range(n)]


def local_batch(batch, microbatches: int, mesh) -> Dict[str, Any]:
    """This rank's rows of a global ``batch`` (numpy arrays or tensors,
    rows first), as the mesh step takes them (:func:`rank_rows`)."""
    out = {}
    for key, v in batch.items():
        parts = [v[lo:hi] for lo, hi in rank_rows(v.shape[0], microbatches,
                                                 mesh)]
        out[key] = (torch.cat(parts) if isinstance(v, torch.Tensor)
                    else np.concatenate(parts))
    return out


def shard_params(model: Model, params, mesh):
    """The rank's part of whole ``params`` on a live ``mesh``: each MoE
    layer's routed experts cut to this rank's (``moe.local_experts``:
    its experts, or its part of each one's hidden width), copied so the
    whole can be freed; every other leaf as it is.  A rank then holds
    only its experts' params and moments."""
    from ..models.moe import local_experts

    def walk(t):
        if not isinstance(t, dict):
            return t
        if "router" in t and model.cfg.n_experts:
            cut = local_experts(t, model.cfg, mesh)
            return {k: v if v is t[k] else v.clone() for k, v in cut.items()}
        return {k: walk(v) for k, v in t.items()}
    return walk(params)


class StateLayout:
    """Where a mesh rank's train state lives: which leaves are the rank's
    part (dim, parts, part) of the whole, as :func:`shard_params` cuts
    them (shapes from the meta device).  The mesh step reads it for
    ``grad_norm``; the checkpointer gathers those leaves over ``model``
    before global rank 0 writes the reference's whole layout, and cuts
    them again on restore.  The other leaves are the same on every
    rank."""

    def __init__(self, model: Model, mesh) -> None:
        import torch.distributed as dist
        self.mesh = mesh
        whole = dict(tree_flatten(model.init(0, "meta")))
        local = tree_flatten(shard_params(model, model.init(0, "meta"),
                                          mesh))
        #: param path -> the shape this rank holds
        self.shapes = {path: tuple(t.shape) for path, t in local}
        k, i = mesh.split(("model",))
        self.parts = {}
        for path, t in local:
            diff = [d for d, (a, b) in enumerate(zip(t.shape,
                                                     whole[path].shape))
                    if a != b]
            if diff:
                self.parts.update({f"{pre}{path}": (diff[0], k, i) for pre
                                   in ("params/", "opt/m/", "opt/v/")})
        self.writer = dist.get_rank() == 0

    def part(self, path: str) -> Optional[Tuple[int, int, int]]:
        return self.parts.get(path)

    def check(self, params) -> None:
        """Raise unless ``params`` has the leaves this layout holds."""
        for path, leaf in tree_flatten(params):
            if tuple(leaf.shape) != self.shapes.get(path):
                raise ValueError(
                    f"param {path} is {tuple(leaf.shape)}, not this rank's "
                    f"{self.shapes.get(path)}: give the mesh step the state "
                    f"init_state(..., mesh=) or shard_params makes")

    def whole_leaves(self, tree) -> Optional[List[torch.Tensor]]:
        """The state's leaves whole, in flatten order, on the writer
        (None on the other ranks, which take part in the gathers)."""
        from ..dist.collectives import all_gather
        out = []
        for path, leaf in tree_flatten(tree):
            part = self.part(path)
            if part is not None:
                leaf = all_gather(leaf, ("model",), self.mesh, part[0])
            out.append(leaf)
        return out if self.writer else None

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()


def _grad_norm(grads: Sequence[torch.Tensor], parted: Sequence[bool],
               mesh) -> torch.Tensor:
    """The global f32 norm of the reduced gradients, the same bits on
    every rank: the leaves held whole locally, plus the squares of the
    leaves held in part summed over ``model``."""
    from ..dist.collectives import all_reduce_

    def squares(gs):
        if not gs:
            return torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
        return torch.sum(torch.stack(
            [torch.sum(torch.square(g.float())) for g in gs]))
    whole = squares([g for g, p in zip(grads, parted) if not p])
    if not any(parted):
        return torch.sqrt(whole)
    part = all_reduce_(squares([g for g, p in zip(grads, parted) if p]),
                       ("model",), mesh)
    return torch.sqrt(whole + part)


def make_mesh_train_step(model: Model, tc: TrainConfig, mesh,
                         donate: bool = True, device="cuda") -> Callable:
    """The train step of one rank of a live ``mesh`` (module docstring):
    ``step(state, batch)`` with ``batch`` this rank's rows
    (:func:`local_batch`) and ``state`` the rank's part
    (:func:`init_state` with ``mesh``, or :func:`shard_params`; a state
    of other shapes raises ``ValueError``).  Every rank of the group
    calls it together.  The metrics are the same on every rank.  The
    step carries its mesh (``step.mesh``), its :class:`StateLayout`
    (``step.layout``) and the paths of the leaves whose gradients its
    last call summed over ``model`` (``step.cut_leaves``).  A spec is
    bound to the default process group, which must hold exactly its
    ranks (``MeshUnavailableError`` when it holds fewer), on ``device``
    (a ``LiveMesh`` carries its own): ``"cuda"`` without a card raises
    rather than run on the CPU."""
    from ..dist.collectives import LiveMesh, all_reduce_
    if isinstance(mesh, LiveMesh):
        live = mesh
    else:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh train step is on 'cuda' but torch.cuda."
                "is_available() is False; pass device='cpu' to train on "
                "the CPU")
        live = LiveMesh(_spec(mesh), device)
    layout = StateLayout(model, live)
    k_rows = live.split(BATCH_AXES)[0]

    def step(state, batch):
        layout.check(state["params"])
        batch = _on_device(batch, state["opt"]["step"].device)
        with use_mesh(live, local_batch=True):
            loss, grads, cut = _accumulate(model, tc, state["params"], batch,
                                           record=True)
        paths = [path for path, _ in tree_flatten(state["params"])]
        step.cut_leaves = tuple(p for p, c in zip(paths, cut) if c)
        parted = [layout.part("params/" + p) is not None for p in paths]
        for g, c in zip(grads, cut):
            all_reduce_(g, BATCH_AXES + (("model",) if c else ()), live)
            if k_rows > 1:
                g.div_(k_rows)
        loss = all_reduce_(loss.clone(), BATCH_AXES, live) / k_rows
        params, opt, m = optim.adamw_update(
            tc.opt, state["params"], _as_tree(state["params"], grads),
            state["opt"], inplace=donate,
            grad_norm=_grad_norm(grads, parted, live))
        metrics = {"loss": loss, **m}
        return (state if donate else {"params": params, "opt": opt}), metrics

    step.mesh, step.layout, step.cut_leaves = live, layout, ()
    return step


def make_jitted_train_step(model: Model, tc: TrainConfig, mesh=None,
                           donate: bool = True, device="cuda") -> Callable:
    """The train step for ``mesh``: None or a 1-device mesh is one
    device; a larger mesh (a ``LiveMesh``, ``MeshSpec`` or its spelling)
    is :func:`make_mesh_train_step` over the default process group,
    which must have exactly the mesh's ranks (``MeshUnavailableError``
    when it has fewer).  The name is the reference's; the step runs
    eagerly (capturing it as CUDA graphs is later work).  ``donate``
    updates the state in place, the reference's donated buffers.
    ``device`` is the mesh step's (:func:`make_mesh_train_step`); one
    device's step runs where its state is."""
    if mesh is None or _spec(mesh).size == 1:
        return make_train_step(model, tc, donate=donate)
    return make_mesh_train_step(model, tc, mesh, donate=donate,
                                device=device)
