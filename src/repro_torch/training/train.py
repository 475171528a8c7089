"""Train-step factory: microbatched gradient accumulation, gradient
compression with error feedback, AdamW — the port of
``repro.training.train``, on one device or over a mesh of ranks.

The step is the loss, ``torch.autograd.grad`` over the param leaves,
then AdamW: :func:`make_train_step` runs it eagerly, and on one device
:func:`make_jitted_train_step` captures it as CUDA graphs on the card
(:class:`CapturedTrainStep`), the reference's one jitted program.  The
reference's ``lax.scan`` over microbatches is a Python loop here, each
microbatch's graph freed after its backward; its donated state is an
update in place (``donate=True``: every state tensor keeps its
storage).  Params are stacked ``(L, ...)`` leaves, so
an optimizer step is one update per leaf, about 15 leaves of work.

Gradient compression: cross-microbatch gradients are carried in bf16
with an f32 error-feedback accumulator (the round-off is fed back into
the next microbatch's gradient before quantization), so the persistent
accumulator is half-width while the update stays unbiased in
expectation.

**The mesh step** (a mesh of more than one device: one process a rank
of a ``torch.distributed`` group that the mesh fills) computes what the
reference's GSPMD program computes on that mesh, with the reference's
placement of the train state:

* *the state*: every param leaf and both its moments are held in part,
  placed as the reference's jitted step places them
  (``state_axes(model)`` under the rules, ``sharding.placements``:
  ``fsdp`` over ``data``; ``mlp``, ``heads``, ``kv_heads``, ``vocab`` and
  ``experts`` over ``model``, each where its mesh axes divide the dim):
  :func:`shard_state`, :class:`StateLayout`;
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
* *gathered at use* (``dist.collectives.gather_param``): each layer of
  a stacked ``(L, ...)`` leaf inside that layer's checkpointed body
  (``models.common.maybe_remat``), so a recompute gathers again, as the
  reference's scan does; every other leaf (embedding, final norm, head)
  once a step; under ``cast_params`` the bf16 copy of the parts is made
  once a step and gathered, and with ``pregather_params`` every leaf's
  bf16 copy is gathered once a step (the reference's ZeRO-1 layout).  A
  weight whose ``model`` part is what compute consumes (the routed
  experts, ``moe.local_experts``; a split projection whose range is the
  rank's equal part, ``sharding.split_param``) is gathered over its
  other axes only; any other weight compute cuts is gathered whole and
  sliced.  The step reads which from a forward on the meta device
  (``step.cut_leaves``);
* *split compute*: on a mesh with a ``model`` axis each rank computes
  its range of the attention heads (and the KV heads they read), of the
  MLP columns, of the RG-LRU's channels and of the vocab (embedding,
  logits, a vocab-parallel cross-entropy), where the reference's
  constraints let GSPMD split them (``sharding.model_part``;
  ``models.common``); the expert-parallel MoE runs its experts.  The
  ``model`` collectives go through autograd-aware conjugate pairs
  (``dist.collectives``), so every leaf whose compute ``model`` does not
  split (norms, the router, MLA's down projections, mamba2's mixer) gets
  its whole gradient on every ``model`` rank;
* *the gradient reduce*, the backward of each gather, in every
  microbatch: the whole gradient summed over the ``batch`` axes (and
  over ``model`` for a weight compute cut from its whole), divided by
  the row parts, and this rank's part kept (``reduce_scatter``), so the
  microbatches' accumulators and ``compress_grads``' error feedback are
  part-sized and hold the global gradient, as the reference's do;
* *the update*: AdamW on the parts (elementwise, so each part's update
  is the slice of the whole one); ``grad_norm`` sums the parts' squares
  over the mesh, the same bits on every rank.

Collectives go through gloo (staged through the host for CUDA tensors),
so ranks may share a card, and the mesh step runs eagerly; NCCL and a
mesh step captured as CUDA graphs are later work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import (BATCH_AXES, current_rules, part_of,
                                    part_shape, placements, recording_splits,
                                    spec_cuts, use_mesh)
from ..core.program import GraphPool, capture, replay
from ..models.api import Model
from ..models.common import tree_flatten, tree_leaves, tree_unflatten
from . import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optim.OptConfig = dataclasses.field(default_factory=optim.OptConfig)
    microbatches: int = 1           # grad-accumulation steps
    compress_grads: bool = False    # bf16 accumulator + error feedback
    cast_params: bool = False       # compute layers on a bf16 copy of the
                                    # f32 masters, made once a step
                                    # (halves the gathers' bytes)
    pregather_params: bool = False  # on a mesh, gather that copy of every
                                    # leaf ONCE a step (ZeRO-1 layout),
                                    # not each layer at use


def init_state(model: Model, seed: int = 0, device="cuda",
               mesh=None) -> Dict[str, Any]:
    """Params drawn from ``seed`` on ``device`` and a fresh AdamW state;
    on a live ``mesh`` the rank's part of them (:func:`shard_state`),
    the moments made for that part only."""
    params = model.init(seed, device)
    if mesh is not None:
        params = shard_state(model, params, mesh)
    return {"params": params, "opt": optim.adamw_init(params)}


def state_axes(model: Model) -> Dict[str, Any]:
    axes = model.param_axes()
    return {"params": axes, "opt": optim.opt_state_axes(axes)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------
def _grad_fn(model: Model, tc: TrainConfig, params, batch, gather=None
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of each param leaf in flatten order, in the
    leaf's dtype).  Under ``cast_params`` the loss runs on a bf16 copy
    of every f32 leaf with two or more dims, and the copy's gradient,
    cast back to f32, is the master's: the reference's gradient through
    the cast.  On a mesh ``gather`` (:class:`_Gathers`) feeds the loss
    the leaves gathered from the rank's parts, and the gradients are the
    parts' of the reduced gradients."""
    paths, leaves = zip(*tree_flatten(params))
    inputs = []
    for p in leaves:
        if (gather is None and tc.cast_params and p.dtype == torch.float32
                and p.ndim >= 2):
            p = p.to(torch.bfloat16)
        inputs.append(p.detach().requires_grad_())
    with torch.enable_grad():
        feed = inputs if gather is None else gather.feed(paths, inputs)
        loss = model.loss(tree_unflatten(list(paths), feed), batch)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), [g.to(p.dtype) for g, p in zip(grads, leaves)]


def _accumulate(model: Model, tc: TrainConfig, params, batch, gather=None):
    """(loss, gradients) of ``batch`` over ``tc.microbatches``: the
    gradients of one pass in each leaf's dtype, or the f32 mean of the
    microbatches' (through the bf16 accumulator under
    ``compress_grads``)."""
    n = tc.microbatches
    if n == 1:
        return _grad_fn(model, tc, params, batch, gather)
    for v in batch.values():
        assert v.shape[0] % n == 0, (v.shape[0], n)
    leaves = [p for _, p in tree_flatten(params)]
    gdtype = torch.bfloat16 if tc.compress_grads else torch.float32
    acc = [torch.zeros(p.shape, dtype=gdtype, device=p.device)
           for p in leaves]
    err = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves] if tc.compress_grads else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(n):
        # one region a microbatch: the dry-run's op counter takes what
        # one more microbatch adds from it (launch/op_analysis.py)
        with torch.profiler.record_function("microbatch"):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, grads = _grad_fn(model, tc, params, mb, gather)
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
    return loss_sum / n, [a.float() / n for a in acc]


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
        loss, grads = _accumulate(model, tc, state["params"], batch)
        params, opt, m = optim.adamw_update(
            tc.opt, state["params"], _as_tree(state["params"], grads),
            state["opt"], inplace=donate)
        metrics = {"loss": loss, **m}
        return (state if donate else {"params": params, "opt": opt}), metrics

    return step


#: The device type whose states :class:`CapturedTrainStep` captures on
#: (the CPU tests emulate a capture on the host by setting it to "cpu").
CAPTURE_DEVICE = "cuda"


class _TrainGraph:
    """One batch signature's captured step: ``body`` over static batch
    tensors, recorded into ``pool`` (see :class:`CapturedTrainStep`);
    ``out`` is what the recording returned, ``order`` the batch's
    element count (the pool's size key)."""

    def __init__(self, body: Callable, batch: Dict[str, torch.Tensor],
                 pool: GraphPool, warmup: Optional[Callable]) -> None:
        with torch.no_grad():
            self.batch = {k: v.clone() for k, v in batch.items()}
        self.body = body
        self.pool = pool
        self.order = sum(t.numel() for t in self.batch.values())
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        #: Bytes the latest capture added to the pool.
        self.pool_bytes = 0
        self.recapture(warmup)

    def recapture(self, warmup: Optional[Callable] = None) -> None:
        """Record the step; ``warmup`` (default: nothing, the step has
        run before) runs first on the side stream."""
        self.graph, self.out, self.pool_bytes = capture(
            lambda: self.body(self.batch), self.pool.device, self.pool,
            warmup=warmup or (lambda: None), inference=False)

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None

    def __call__(self, batch: Dict[str, torch.Tensor],
                 copy_in: Callable[[], None] = lambda: None) -> Any:
        """Copy ``batch`` (and what ``copy_in`` copies) in, replay, and
        return copies of the recording's outputs."""
        if self.graph is None:            # its recapture failed
            self.recapture()

        def fill():
            copy_in()
            for name, t in self.batch.items():
                t.copy_(batch[name])

        return replay(self.pool, self.graph, self.pool.device, fill,
                      lambda: _clone_tree(self.out))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


class CapturedTrainStep:
    """The one-device train step captured as CUDA graphs, the counterpart
    of the reference's jitted step (``make_jitted_train_step``): one
    graph per batch signature, each over static batch tensors, recording
    the loss, ``torch.autograd.grad``, the microbatch loop and AdamW
    (:attr:`eager`, the step run op by op), its metrics 0-d static
    tensors returned as copies; every graph in one
    :class:`~repro_torch.core.program.GraphPool`, a larger batch laying
    it out again (``GraphPool.place``).  A state on the CPU runs
    :attr:`eager` itself.

    ``donate=True``: the graphs read and write the state's own tensors,
    the reference's donated buffers.  A batch signature's first call on
    a state's tensors runs :attr:`eager` on them as the capture's
    warm-up, on the side stream: that warm-up is the call's real step
    (no scratch copy of the state need fit beside it), and the capture
    records the next step without running it.  Later calls on the same
    tensors copy the batch in and replay.  A call on other tensors (a
    restored state, a new one) drops the graphs and captures again the
    same way, so no call reads stale addresses.  The step holds only
    weak references to the state: a state the caller drops is freed.

    ``donate=False``: the graphs read a static copy of the state, made
    at the first call, and write the new state into the pool; every call
    copies the given state and batch in, replays, and returns copies, so
    the given state is never written.  Its warm-up runs on the static
    copy and writes nothing, so the first call is a replay too."""

    def __init__(self, model: Model, tc: TrainConfig,
                 donate: bool = True) -> None:
        self.donate = donate
        #: The step run op by op: what each graph records.
        self.eager = make_train_step(model, tc, donate=donate)
        self.graphs: Dict[tuple, _TrainGraph] = {}
        self.pool: Optional[GraphPool] = None
        #: Host ms of the latest eager first step (donated: the capture's
        #: warm-up, synchronised).
        self.warm_ms: Optional[float] = None
        self._paths: Optional[List[str]] = None
        self._refs: List[Any] = []      # donated: the state's leaves
        self._static = None             # not donated: the state's copy

    @property
    def captured(self) -> bool:
        """True when a graph is captured for some batch."""
        return any(g.graph is not None for g in self.graphs.values())

    def release(self) -> None:
        """Drop every graph, the pool and the state copy; the next call
        captures again."""
        for g in self.graphs.values():
            g.release()
        self.graphs, self.pool, self._static = {}, None, None
        self._refs = []

    def __call__(self, state, batch):
        device = state["opt"]["step"].device
        if device.type != CAPTURE_DEVICE:
            return self.eager(state, batch)
        batch = _on_device(batch, device)
        flat = tree_flatten(state)
        leaves = [t for _, t in flat]
        if self.donate and not (
                len(self._refs) == len(leaves)
                and all(r() is t for r, t in zip(self._refs, leaves))):
            self.release()
            self._paths = [p for p, _ in flat]
            self._refs = [weakref.ref(t) for t in leaves]
        if self.pool is None:
            self.pool = GraphPool(device)
        key = tuple(sorted((k, tuple(v.shape), v.dtype)
                           for k, v in batch.items()))
        graph = self.graphs.get(key)
        if self.donate:
            if graph is None:
                return self._first(key, state, batch)
            return state, graph(batch)
        if self._static is None:
            with torch.no_grad():
                self._static = _clone_tree(state)
        static = tree_leaves(self._static)
        if [(t.shape, t.dtype) for t in leaves] != \
                [(t.shape, t.dtype) for t in static]:
            raise ValueError("the state's leaves differ in shape or dtype "
                             "from those this train step was captured for")
        if graph is None:
            eager, static_tree = self.eager, self._static
            graph = self._place(key, lambda b: eager(static_tree, b), batch,
                                None)

        def copy_in():
            for s, t in zip(static, leaves):
                s.copy_(t)
        return graph(batch, copy_in)

    def _place(self, key, body, batch, warmup) -> _TrainGraph:
        graph = self.pool.place(
            lambda: _TrainGraph(body, batch, self.pool, warmup),
            sum(t.numel() for t in batch.values()),
            list(self.graphs.values()))
        self.graphs[key] = graph
        return graph

    def _first(self, key, state, batch):
        """A donated batch signature's first call: the real step as the
        capture's warm-up, then the capture of the next."""
        out = []

        def warmup():
            t0 = time.perf_counter()
            out.append(self.eager(state, batch))
            torch.cuda.current_stream(self.pool.device).synchronize()
            self.warm_ms = (time.perf_counter() - t0) * 1e3

        self._place(key, _DonatedBody(self.eager, self._paths, self._refs),
                    batch, warmup)
        return out[0]


class _DonatedBody:
    """A donated graph's body: the step over the state its weak
    references name (no reference to the :class:`CapturedTrainStep`, so
    a step the caller drops is freed at once, never by the cyclic
    collector in the middle of another capture)."""

    def __init__(self, eager: Callable, paths: List[str], refs: List[Any]):
        self.eager, self.paths, self.refs = eager, paths, refs

    def __call__(self, batch):
        leaves = [r() for r in self.refs]
        if any(t is None for t in leaves):
            raise RuntimeError("the state this train step was captured "
                               "over has been freed")
        return self.eager(tree_unflatten(self.paths, leaves), batch)[1]


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


def shard_state(model: Model, params, mesh):
    """The rank's part of whole ``params`` on a live ``mesh``: every leaf
    cut to its placement (:class:`StateLayout`), copied so the whole can
    be freed; a leaf placed on no axis as it is."""
    layout = StateLayout(model, mesh)
    flat = tree_flatten(params)
    return tree_unflatten([p for p, _ in flat], [
        layout.local("params/" + p, t).clone(
            memory_format=torch.contiguous_format)
        if layout.part("params/" + p) else t for p, t in flat])


class StateLayout:
    """Where a mesh rank's train state lives, the reference's placement:
    each leaf's partition spec over every mesh axis (``specs``, keyed
    ``params/...``, ``opt/m/...``, ``opt/v/...``; ``sharding.placements``
    of :func:`state_axes` under the current rules), the dims it cuts
    (``parts``: the leaves held in part, ``[(dim, mesh axes)]``) and the
    shape the rank holds of each param (``shapes``).
    The mesh step reads it for its gathers and ``grad_norm``; the
    checkpointer gathers every part before global rank 0 writes the
    reference's whole layout, and cuts each leaf again on restore."""

    def __init__(self, model: Model, mesh) -> None:
        import torch.distributed as dist
        self.mesh = mesh
        # a MoE's axes are those of this mesh's ``model`` axis; the rules
        # are the caller's
        with use_mesh(mesh, current_rules()):
            axes = state_axes(model)["params"]
        whole = model.init(0, "meta")
        specs = dict(tree_flatten(placements(mesh, axes, whole)))
        axes = dict(tree_flatten(axes))
        self.specs: Dict[str, tuple] = {"opt/step": ()}
        self.parts: Dict[str, list] = {}
        #: param path -> the shape this rank holds
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        #: the param paths stacked on a leading ``layers`` dim
        self.stacked = {p for p, ax in axes.items() if ax[:1] == ("layers",)}
        for path, t in tree_flatten(whole):
            cuts = spec_cuts(mesh, specs[path])
            self.shapes[path] = part_shape(mesh, tuple(t.shape), cuts)
            for pre in ("params/", "opt/m/", "opt/v/"):
                self.specs[pre + path] = specs[path]
                if cuts:
                    self.parts[pre + path] = cuts
        self.writer = dist.get_rank() == 0

    def part(self, path: str) -> Optional[list]:
        """The cuts of state leaf ``path`` (None: held whole)."""
        return self.parts.get(path)

    def local(self, path: str, whole):
        """This rank's part (views) of state leaf ``path``'s ``whole``."""
        return part_of(whole, self.part(path) or (), self.mesh)

    def check(self, params) -> None:
        """Raise unless ``params`` has the leaves this layout holds."""
        for path, leaf in tree_flatten(params):
            if tuple(leaf.shape) != self.shapes.get(path):
                raise ValueError(
                    f"param {path} is {tuple(leaf.shape)}, not this rank's "
                    f"{self.shapes.get(path)}: give the mesh step the state "
                    f"init_state(..., mesh=) or shard_state makes")

    def gathered(self, tree) -> List[torch.Tensor]:
        """The leaves of ``tree`` (keyed like the state) whole, in flatten
        order, on every rank: each part gathered over its axes."""
        from ..dist.collectives import all_gather
        out = []
        for path, leaf in tree_flatten(tree):
            for dim, axes in self.part(path) or ():
                leaf = all_gather(leaf, axes, self.mesh, dim)
            out.append(leaf)
        return out

    def whole_leaves(self, tree) -> Optional[List[torch.Tensor]]:
        """The state's leaves whole, in flatten order, on the writer
        (None on the other ranks, which take part in the gathers)."""
        out = self.gathered(tree)
        return out if self.writer else None

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()


#: Tokens a row in the meta-device forward that finds the weights model
#: code cuts (:func:`compute_cuts`; the image tokens come first).
_PROBE_SEQ = 16


class _WholeLeaves:
    """The gathers of :func:`compute_cuts`' forward on the meta device:
    every leaf is whole there (``sharding.current_gather``)."""

    def owns(self, t) -> bool:
        return False


def compute_cuts(model: Model, mesh, probe=None
                 ) -> Dict[str, Tuple[int, bool]]:
    """{param path: (the dim, counted from the end, that model code cuts
    to this rank's range over ``model``, whether that range is the
    rank's equal part)} on the live ``mesh``: the ``split_param``
    records of one forward of the loss on the meta device (nothing is
    allocated or sent) under the mesh step's context, one row a rank.
    ``probe(model, params)`` runs another forward in the loss's place
    (the serving program's prefill and decode step)."""
    from ..configs import ShapeSpec, input_specs
    params = model.init(0, "meta")
    paths = {id(t): p for p, t in tree_flatten(params)}
    seq = _PROBE_SEQ + (model.cfg.num_image_tokens or 0)
    batch = input_specs(model.cfg, ShapeSpec("probe", seq, 1, "train"))
    with torch.no_grad(), recording_splits() as cut, \
            use_mesh(mesh, current_rules(), local_batch=True,
                     gather=_WholeLeaves()):
        if probe is None:
            model.loss(params, batch)
        else:
            probe(model, params)
    out: Dict[str, Tuple[int, bool]] = {}
    for root, dim, even, _ in cut:
        if id(root) in paths:
            path = paths[id(root)]
            out[path] = (dim, even and out.get(path, (dim, True))[1])
    return out


def compute_ranges(model: Model, mesh, probe
                   ) -> Dict[str, Tuple[int, Tuple[Tuple[int, int], ...]]]:
    """{param path: (the dim, counted from the end, that model code cuts
    over ``model``, every ``model`` rank's ``[lo, hi)`` of it)} for the
    leaves ``probe`` cuts to one range a rank: ``probe`` run on the meta
    device as each ``model`` rank in turn (the mesh's coordinates
    changed; collectives of meta tensors talk to no one)."""
    import copy
    params = model.init(0, "meta")
    paths = {id(t): p for p, t in tree_flatten(params)}
    seen: Dict[str, List[set]] = {}
    k = mesh.split(("model",))[0]
    for i in range(k):
        as_i = copy.copy(mesh)
        as_i.coords = {**mesh.coords, "model": i}
        with torch.no_grad(), recording_splits() as cut, \
                use_mesh(as_i, current_rules(), local_batch=True,
                         gather=_WholeLeaves()):
            probe(model, params)
        for root, dim, _, rng in cut:
            if id(root) in paths:
                entry = seen.setdefault(paths[id(root)],
                                        [set() for _ in range(k)])
                entry[i].add((dim, rng))
    out = {}
    for path, per in seen.items():
        if all(len(s) == 1 for s in per) and \
                len({next(iter(s))[0] for s in per}) == 1:
            dim = next(iter(per[0]))[0]
            out[path] = (dim, tuple(next(iter(s))[1] for s in per))
    return out


def param_plans(model: Model, mesh, layout: StateLayout, probe=None,
                spans: bool = False):
    """{param path: its ``dist.collectives.ParamPlan``}: each leaf is
    gathered over the axes it is cut on, except a ``model`` part that
    compute consumes (:func:`compute_cuts`, of the loss or of ``probe``:
    the rank's equal part, where its placement cuts the same dim over
    ``model`` alone); its gradient is summed over the ``batch`` axes,
    and over ``model`` where compute cuts its range from the whole.
    With ``spans`` (the serving program: no gradient) a range that is no
    equal part of a dim placed over ``model`` is gathered from the
    ranks' parts alone (``ParamPlan.span``, :func:`compute_ranges`)."""
    from ..dist.collectives import ParamPlan
    cut = compute_cuts(model, mesh, probe)
    ranges = compute_ranges(model, mesh, probe) if spans else {}
    rows = mesh.split(BATCH_AXES)[0]
    k_model = mesh.split(("model",))[0]
    plans = {}
    for path, shape in layout.shapes.items():
        cuts = layout.part("params/" + path) or []
        held, reduce, span = None, BATCH_AXES, None
        if path in cut:
            dim, even = cut[path]
            keep = [c for c in cuts if c[1] == ("model",)
                    and c[0] - len(shape) == dim]
            if keep and even:
                held, cuts = (dim, k_model), [c for c in cuts
                                              if c not in keep]
            elif keep and ranges.get(path, (None,))[0] == dim:
                span, cuts = ranges[path], [c for c in cuts
                                            if c not in keep]
            else:
                reduce = BATCH_AXES + ("model",)
        plans[path] = ParamPlan(tuple(cuts), reduce, rows, held, span)
    return plans, tuple(p for p in layout.shapes if p in cut)


class _Gathers:
    """One mesh step's gathers (``sharding.current_gather``): made once a
    step from the rank's params, the bf16 copies of their parts under
    ``cast_params`` and the leaves gathered once a step (every leaf not
    stacked on a ``layers`` dim; every leaf with ``pregather_params``);
    then, for each microbatch, :meth:`feed` gives the loss its params
    and ``models.common`` gathers each stacked leaf's layer at use."""

    def __init__(self, plans, stacked, params, tc: TrainConfig,
                 mesh) -> None:
        from ..dist.collectives import gather_param
        self.plans, self.mesh = plans, mesh
        self.src: Dict[str, torch.Tensor] = {}
        self.whole: Dict[str, torch.Tensor] = {}
        once = tc.cast_params and tc.pregather_params
        with torch.no_grad():
            for path, p in tree_flatten(params):
                if (tc.cast_params and p.dtype == torch.float32
                        and p.ndim >= 2):
                    self.src[path] = p.to(torch.bfloat16)
                if once or path not in stacked:
                    # (an alias: a mark on what is gathered never reaches
                    # the state's own tensor)
                    self.whole[path] = gather_param(
                        p.detach(), plans[path], mesh,
                        src=self.src.get(path))
        self._stacked: Dict[int, Tuple[torch.Tensor, str]] = {}
        self._layers: Dict[int, tuple] = {}

    def feed(self, paths, inputs) -> List[torch.Tensor]:
        """The loss's param leaves for the parts ``inputs`` (which
        autograd records): a leaf gathered once a step as it is, through
        ``gather_param`` so its part gets its gradient; a stacked leaf
        as its part, for :meth:`layers`."""
        from ..dist.collectives import gather_param
        self._stacked.clear()
        self._layers.clear()
        out = []
        for path, x in zip(paths, inputs):
            if path in self.whole:
                x = gather_param(x, self.plans[path], self.mesh,
                                 whole=self.whole[path])
            else:
                self._stacked[id(x)] = (x, path)
            out.append(x)
        return out

    def owns(self, t) -> bool:
        hit = self._stacked.get(id(t))
        return hit is not None and hit[0] is t

    def layers(self, t, n: int) -> List[torch.Tensor]:
        """The ``n`` layers' parts of a stacked part ``t`` (one unbind),
        each gathered by :meth:`at_use` in its layer's body."""
        path = self._stacked[id(t)][1]
        plan, src = self.plans[path].layer(), self.src.get(path)
        views = torch.unbind(t, 0)
        assert len(views) == n, (len(views), n)
        for i, v in enumerate(views):
            self._layers[id(v)] = (v, None if src is None else src[i], plan)
        return list(views)

    def at_use(self, args):
        """``args`` with every layer part of :meth:`layers` gathered whole
        (dicts, lists and tuples walked)."""
        from ..dist.collectives import gather_param

        def walk(a):
            if isinstance(a, dict):
                return {k: walk(v) for k, v in a.items()}
            if isinstance(a, (list, tuple)):
                return type(a)(walk(v) for v in a)
            hit = self._layers.get(id(a))
            if hit is None or hit[0] is not a:
                return a
            return gather_param(a, hit[2], self.mesh, src=hit[1])
        return walk(args)


def _grad_norm(grads: Sequence[torch.Tensor], paths: Sequence[str],
               layout: StateLayout) -> torch.Tensor:
    """The global f32 norm of the reduced gradients' parts, the same bits
    on every rank: each leaf's sum of squares from the ranks whose
    coordinate is 0 on every axis the leaf is not cut over (one replica
    of each part), summed over the mesh in one all-reduce."""
    from ..dist.collectives import all_reduce_
    mesh = layout.mesh
    sums = []
    for path, g in zip(paths, grads):
        cut = {a for _, axes in layout.part("params/" + path) or ()
               for a in axes}
        s = torch.sum(torch.square(g.float()))
        first = all(mesh.coords[a] == 0 for a in mesh.spec.names
                    if a not in cut)
        sums.append(s if first else torch.zeros_like(s))
    total = all_reduce_(torch.stack(sums), mesh.spec.names, mesh)
    return torch.sqrt(torch.sum(total))


def make_mesh_train_step(model: Model, tc: TrainConfig, mesh,
                         donate: bool = True, device="cuda") -> Callable:
    """The train step of one rank of a live ``mesh`` (module docstring):
    ``step(state, batch)`` with ``batch`` this rank's rows
    (:func:`local_batch`) and ``state`` the rank's part
    (:func:`init_state` with ``mesh``, or :func:`shard_state`; a state
    of other shapes raises ``ValueError``).  Every rank of the group
    calls it together.  The metrics are the same on every rank.  The
    step carries its mesh (``step.mesh``), its :class:`StateLayout`
    (``step.layout``) and the paths of the leaves model code cuts over
    ``model`` in compute (``step.cut_leaves``).  A spec is bound to the
    default process group, which must hold exactly its ranks
    (``MeshUnavailableError`` when it holds fewer), on ``device`` (a
    ``LiveMesh`` carries its own): ``"cuda"`` without a card raises
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
    plans, cut_leaves = param_plans(model, live, layout)
    k_rows = live.split(BATCH_AXES)[0]

    def step(state, batch):
        layout.check(state["params"])
        batch = _on_device(batch, state["opt"]["step"].device)
        gather = _Gathers(plans, layout.stacked, state["params"], tc, live)
        with use_mesh(live, local_batch=True, gather=gather):
            loss, grads = _accumulate(model, tc, state["params"], batch,
                                      gather)
        del gather
        loss = all_reduce_(loss.clone(), BATCH_AXES, live) / k_rows
        paths = [path for path, _ in tree_flatten(state["params"])]
        params, opt, m = optim.adamw_update(
            tc.opt, state["params"], _as_tree(state["params"], grads),
            state["opt"], inplace=donate,
            grad_norm=_grad_norm(grads, paths, layout))
        metrics = {"loss": loss, **m}
        return (state if donate else {"params": params, "opt": opt}), metrics

    step.mesh, step.layout, step.cut_leaves = live, layout, cut_leaves
    return step


def make_jitted_train_step(model: Model, tc: TrainConfig, mesh=None,
                           donate: bool = True, device="cuda") -> Callable:
    """The train step for ``mesh``, the reference's jitted step: None or
    a 1-device mesh is one device, a :class:`CapturedTrainStep` (CUDA
    graphs on the card, :func:`make_train_step`'s step on the CPU); a
    larger mesh (a ``LiveMesh``, ``MeshSpec`` or its spelling) is
    :func:`make_mesh_train_step` over the default process group, which
    must have exactly the mesh's ranks (``MeshUnavailableError`` when it
    has fewer), and runs eagerly: its collectives go through gloo on the
    host, and capture across ranks needs NCCL with one card per rank.
    ``donate`` updates the state in place, the reference's donated
    buffers.  ``device`` is the mesh step's; one device's step runs
    where its state is."""
    if mesh is None or _spec(mesh).size == 1:
        return CapturedTrainStep(model, tc, donate=donate)
    return make_mesh_train_step(model, tc, mesh, donate=donate,
                                device=device)
