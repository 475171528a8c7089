"""Cell lowering: one (arch × shape × mesh) -> this rank's counted program.

The port of ``repro.launch.cells``, the machinery behind the dry-run.
The reference lowers a cell to one XLA program over abstract
``ShapeDtypeStruct``s; the port has no such program to lower.  It
traces the program one rank of the mesh runs, on fake tensors
(``FakeTensorMode``) of the rank's shapes on the cell's device, so no
parameter, cache or batch tensor is ever allocated, and counts its ops
(:mod:`repro_torch.launch.op_analysis`):

* **train**: ``make_jitted_train_step(..., mesh=)``'s step on the rank's
  state (``init_state(..., mesh=)``: its part of every leaf, the
  reference's placement, as
  :class:`~repro_torch.training.train.StateLayout` says) and its rows of
  the global batch (``rank_rows``), in ``microbatches`` microbatches,
  its compute split over ``model`` where the reference's constraints
  split it (the rank's heads, MLP columns and vocab rows:
  ``distributed.sharding.model_part``);
* **prefill** and **decode**: :func:`serve_program`'s steps, the
  counterpart of the reference's prefill and decode branches of
  ``lower_cell``, which real tensors run too (tests, ``chip_smoke.py``).
  A rank holds its part of the params, placed as the reference places
  them (``fsdp`` over ``data``; ``heads``, ``kv_heads``, ``mlp``,
  ``vocab`` over ``model``) and gathered at use, layer by layer, as the
  train step gathers them; its rows of the batch (``batch`` over
  ``pod``, ``data`` where they divide it; long_500k's one row is whole on
  every rank); and its part of the cache, placed by ``cache_axes`` under
  :func:`divisible_placement` (``kv_seq`` over ``model``, the recurrent
  states' ``mlp`` channels over ``model``).  The models split compute
  over ``model`` as in the train step, and a decode step attends over
  the rank's part of the sequence in the flash-decoding form
  (``models.common.decode_attention_jnp``).  A step returns the rank's
  vocab part of the logits of its rows, as the reference's
  ``logical(y, ..., "vocab")`` leaves them
  (:meth:`ServeProgram.gather_logits` makes them whole).

A cell is traced at a few depths (:func:`depth_points`) and weighed to
its own (:func:`repro_torch.launch.op_analysis.weigh`).

The record (:func:`analyze`) has the reference's keys where their
meaning carries over, per rank: "per device" is this rank's measured
program, not the global count over the chips, so ``useful_flops_ratio``
shows the compute a rank repeats: only what the reference's constraints
leave whole on ``model`` (MLA's down projections, the MoE router,
mamba2's mixer, a KV head shared by two ranks' heads, a dim of fewer
units than ``model`` has ranks), and rank 0's range being the largest
(⌈n/k⌉ units).  :func:`divisible_placement` and :func:`placements`
(``distributed.sharding``) are the reference's placement rules: what a
rank holds follows them in every cell, so ``argument_size_in_bytes``
equals ``argument_size_if_placed``, the arguments' bytes under them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from ..configs import ArchConfig, ShapeSpec, input_specs
from ..distributed import sharding as shd
from ..distributed.sharding import divisible_placement, mesh_sizes, placements
from ..models import get_model
from ..models.common import tree_flatten, tree_leaves
from . import op_analysis as oa


# ---------------------------------------------------------------------------
# Placement (the reference's rules)
# ---------------------------------------------------------------------------
def batch_placement(mesh, specs: Mapping[str, Any]) -> Dict[str, tuple]:
    """Dim 0 over the ``batch`` axes (pod, data) where they divide it,
    else replicated (the reference's ``_batch_sharding``)."""
    return {k: divisible_placement(mesh, tuple(v.shape), ("batch",))
            for k, v in specs.items()}


def cache_placement(mesh, shape, axes) -> tuple:
    """The spec of one cache leaf: its logical axes placed as named, the
    ``batch`` axis dropped where the request batch does not divide the
    batch axes (long_500k's B=1; the reference's ``_cache_sharding``)."""
    sizes = mesh_sizes(mesh)
    n_batch = math.prod(sizes.get(a, 1) for a in shd.BATCH_AXES)
    fixed = [None if ax == "batch" and dim % n_batch else ax
             for dim, ax in zip(shape, axes)]
    return shd.named_sharding(mesh, *fixed).spec


def placed_bytes(mesh, t, spec) -> int:
    """The bytes of ``t``'s part on one device under ``spec``."""
    sizes = mesh_sizes(mesh)
    parts = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            parts *= sizes[a]
    return t.numel() * t.element_size() // parts


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D; decode counts one
    token per sequence (the reference's formula)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# The fake group a dry-run's rank lives in
# ---------------------------------------------------------------------------
def check_device(device) -> None:
    """Raise unless ``device`` can hold fake tensors here: a fake CUDA
    tensor needs a CUDA build and a card (on a CPU-only build its
    backward aborts the process), so the CPU is asked for by name."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry-run traces on 'cuda' but torch.cuda.is_available() is "
            "False; pass --device cpu (device='cpu') to trace on the CPU")


@contextlib.contextmanager
def dry_group(spec, rank: int = 0, device="cuda") -> Iterator[Any]:
    """A fake process group of ``spec.size`` ranks with this process as
    ``rank``, and the :class:`~repro_torch.dist.collectives.LiveMesh` of
    ``spec`` on ``device`` over it; destroyed on exit.  Its collectives
    move nothing.  Raises if a process group exists already: the fake
    group must be the process's only one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from ..dist.collectives import LiveMesh, destroy_process_group
    from ..dist.mesh import MeshSpec
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; a dry-run's "
                           "fake group must be the process's only one")
    spec = MeshSpec.coerce(spec)
    if not 0 <= rank < spec.size:
        raise ValueError(f"rank {rank} outside the {spec.size} ranks of "
                         f"{spec.describe()}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=spec.size)
    try:
        yield LiveMesh(spec, torch.device(device))
    finally:
        destroy_process_group()


def _live(mesh, device):
    """A ``LiveMesh`` of more than one device, or None (no mesh, or one
    device); a spec is bound to the default process group."""
    from ..dist.collectives import LiveMesh
    from ..dist.mesh import MeshSpec
    if mesh is None or isinstance(mesh, LiveMesh):
        return mesh
    spec = MeshSpec.coerce(mesh)
    return None if spec.size == 1 else LiveMesh(spec, torch.device(device))


# ---------------------------------------------------------------------------
# Depths: the kinds of layer a config repeats, and the depths traced
# ---------------------------------------------------------------------------
def depth_kinds(cfg: ArchConfig) -> Dict[str, int]:
    """How many layers of each kind ``cfg`` has.  A transformer's local
    (sliding-window) and global layers are two kinds where it has both
    (gemma3's 5:1); recurrentgemma's super-blocks of three and its
    trailing recurrent layers; whisper's encoder and decoder layers.
    deepseek-v3's first layers are MoE layers here, as in the reference
    (its config models them uniformly), and its MTP head runs once."""
    if cfg.family == "hybrid":
        from ..models.rglru import n_superblocks
        nb, tail = n_superblocks(cfg)
        return {k: v for k, v in (("block", nb), ("tail", tail)) if v}
    if cfg.family == "audio":
        return {"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
    if cfg.family == "ssm":
        return {"layer": cfg.num_layers}
    from ..models.transformer import layer_windows
    w = layer_windows(cfg)
    local, glob = int((w > 0).sum()), int((w == 0).sum())
    if local and glob:
        return {"local": local, "global": glob}
    return {"layer": cfg.num_layers}


def _at_depth(cfg: ArchConfig, counts: Mapping[str, int]) -> ArchConfig:
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=3 * counts.get("block", 0) + counts.get("tail", 0))
    if cfg.family == "audio":
        return dataclasses.replace(cfg, encoder_layers=counts["encoder"],
                                   num_layers=counts["decoder"])
    return dataclasses.replace(cfg, num_layers=counts["layer"])


def depth_points(cfg: ArchConfig) -> List[Tuple[Dict[str, int],
                                                ArchConfig]]:
    """The depths a cell of ``cfg`` is traced at, each (its layer counts,
    the config cut to it): one of every kind, then one more of each kind
    the config has more than one of.  gemma3's pattern has a global
    layer only from six layers on (fewer are all local, which is a ring
    cache, another program), so its depths are one and two global
    layers (the all-global pattern, whose layers and cache are gemma3's
    global ones) and its first six layers."""
    full = depth_kinds(cfg)
    if set(full) == {"local", "global"}:
        glob = lambda n: dataclasses.replace(cfg, pattern="global",
                                             num_layers=n)
        return [({"local": 0, "global": 1}, glob(1)),
                ({"local": 0, "global": 2}, glob(2)),
                ({"local": 5, "global": 1},
                 dataclasses.replace(cfg, num_layers=6))]
    base = {k: 1 for k in full}
    points = [dict(base)]
    for k in full:
        if full[k] > 1:
            points.append({**base, k: 2})
    return [(p, _at_depth(cfg, p)) for p in points]


def _varied(points: List[Dict[str, int]], full: Mapping[str, int]
            ) -> Dict[str, int]:
    """The kinds whose count differs between the traced depths (the
    others are the same everywhere, and part of the constant)."""
    return {k: v for k, v in full.items()
            if len({p[k] for p in points}) > 1}


# ---------------------------------------------------------------------------
# Tracing one rank's program
# ---------------------------------------------------------------------------
def _fake(tree, device):
    """A fake tensor (under the active ``FakeTensorMode``) of each meta
    leaf's shape and dtype on ``device``."""
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _batch(cfg, shape, rows: int) -> Dict[str, torch.Tensor]:
    """The cell's inputs for ``rows`` rows, on the meta device."""
    specs = input_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def _train_rows(shape, n: int, live) -> int:
    """The rows of one microbatch this rank holds."""
    if live is None:
        if shape.global_batch % n:
            raise ValueError(f"a global batch of {shape.global_batch} rows "
                             f"does not split into {n} microbatches")
        return shape.global_batch // n
    from ..training.train import rank_rows
    lo, hi = rank_rows(shape.global_batch, n, live)[0]
    return hi - lo


class ServeProgram:
    """One rank's serving program of ``cfg`` on a mesh (module
    docstring), or one device's (``mesh`` None or of one device): what
    the rank holds and the two steps it runs.

    * :meth:`shard_params` / :meth:`init_params`: the rank's part of the
      params (``training.train.shard_state``'s placement, ``layout``);
    * :meth:`init_cache`: the rank's part of a cache of ``global_batch``
      rows and ``max_len`` positions, zeros, each leaf cut over ``model``
      marked ``held_part`` (``sharding.held_range``);
    * :meth:`rows` / :meth:`local_batch`: the rank's rows of the global
      batch, which every step takes;
    * :meth:`prefill` and :meth:`decode`: ``Model.prefill`` and
      ``Model.decode_step`` under ``use_mesh(live, rules,
      local_batch=True, gather=)`` with no autograd, the params gathered
      at use (``training.train._Gathers``); each returns (the rank's
      vocab part of its rows' logits, the cache, written in place);
    * :meth:`gather_logits` and :meth:`gather_cache`: the whole of each,
      on every rank (every rank calls them together).

    Every rank of the group builds the program and calls its steps in
    the same order."""

    def __init__(self, cfg: ArchConfig, mesh=None, rules=None,
                 device="cuda") -> None:
        self.cfg, self.model = cfg, get_model(cfg)
        self.device = torch.device(device)
        self.live = _live(mesh, self.device)
        self.rules = rules
        self.layout = None
        self._plans = None
        if self.live is not None:
            from ..training.train import StateLayout
            with shd.use_mesh(self.live, rules):
                self.layout = StateLayout(self.model, self.live)

    # -- what the rank holds --------------------------------------------
    def param_shapes(self) -> Dict[str, Any]:
        """The rank's params as meta tensors (its parts' shapes)."""
        from ..models.common import tree_unflatten
        whole = self.model.init(0, "meta")
        if self.layout is None:
            return whole
        flat = tree_flatten(whole)
        return tree_unflatten([p for p, _ in flat], [
            torch.empty(self.layout.shapes[p], dtype=t.dtype, device="meta")
            for p, t in flat])

    def shard_params(self, params):
        """The rank's part of whole ``params`` (copies; the whole may be
        freed), or ``params`` on one device."""
        if self.layout is None:
            return params
        from ..training.train import shard_state
        return shard_state(self.model, params, self.live)

    def init_params(self, seed: int = 0):
        """The rank's part of the params drawn from ``seed`` on the
        program's device (drawn whole, then cut)."""
        return self.shard_params(self.model.init(seed, self.device))

    def cache_specs(self, global_batch: int, max_len: int
                    ) -> Dict[str, tuple]:
        """Each cache leaf's partition spec on the mesh: ``cache_axes``
        under :func:`divisible_placement`, as the reference's
        ``lower_cell`` places the cache."""
        whole = self.model.init_cache(global_batch, max_len, "meta")
        axes = self.model.cache_axes()
        with shd.use_mesh(self.live, self.rules):
            return {k: divisible_placement(self.live, tuple(v.shape),
                                           axes[k])
                    for k, v in whole.items()}

    def init_cache(self, global_batch: int, max_len: int, device=None
                   ) -> Dict[str, torch.Tensor]:
        """The rank's part of a zero cache of ``global_batch`` rows and
        ``max_len`` positions on ``device`` (default the program's); a
        leaf cut over ``model`` carries ``held_part``."""
        device = self.device if device is None else device
        whole = self.model.init_cache(global_batch, max_len, "meta")
        if self.live is None:
            return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                    for k, v in whole.items()}
        k_model = self.live.split(("model",))[0]
        out = {}
        for key, spec in self.cache_specs(global_batch, max_len).items():
            leaf = whole[key]
            cuts = shd.spec_cuts(self.live, spec)
            t = torch.zeros(shd.part_shape(self.live, tuple(leaf.shape),
                                           cuts),
                            dtype=leaf.dtype, device=device)
            for dim, axes in cuts:
                if axes == ("model",):
                    t.held_part = (dim - t.ndim, k_model)
            out[key] = t
        return out

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """The rank's ``[lo, hi)`` of the global batch's rows: its part
        over the ``batch`` axes where they divide the rows, else all of
        them (the reference's ``_batch_sharding``)."""
        if self.live is None:
            return 0, global_batch
        k, i = self.live.split(shd.BATCH_AXES)
        if global_batch % k:
            return 0, global_batch
        n = global_batch // k
        return i * n, (i + 1) * n

    def local_batch(self, batch) -> Dict[str, Any]:
        """The rank's rows of a global ``batch`` (rows first)."""
        out = {}
        for key, v in batch.items():
            lo, hi = self.rows(v.shape[0])
            out[key] = v[lo:hi]
        return out

    # -- the steps --------------------------------------------------------
    @property
    def plans(self):
        """The params' gathers (``training.train.param_plans``), read
        from the serving forward's cuts on the meta device."""
        if self._plans is None:
            from ..training.train import param_plans
            with shd.use_mesh(self.live, self.rules):
                self._plans = param_plans(self.model, self.live,
                                          self.layout, probe=_serve_probe,
                                          spans=True)
        return self._plans

    def _run(self, fn, params):
        if self.live is None:
            with torch.no_grad(), shd.use_mesh(None, self.rules):
                return fn(params)
        from ..training.train import TrainConfig, _Gathers
        from ..models.common import tree_unflatten
        self.layout.check(params)
        plans = self.plans[0]
        with torch.no_grad():
            gather = _Gathers(plans, self.layout.stacked, params,
                              TrainConfig(), self.live)
            flat = tree_flatten(params)
            paths = [p for p, _ in flat]
            fed = tree_unflatten(paths, gather.feed(paths,
                                                    [t for _, t in flat]))
            with shd.use_mesh(self.live, self.rules, local_batch=True,
                              gather=gather):
                return fn(fed)

    def prefill(self, params, batch, cache):
        """The rank's prefill of its rows ``batch`` into ``cache``: (the
        rank's vocab part of the last position's logits, the cache)."""
        return self._run(lambda p: self.model.prefill(p, batch, cache),
                         params)

    def decode(self, params, cache, tokens):
        """One decode step of the rank's rows ``tokens`` (B, 1): (the
        rank's vocab part of the logits, the cache)."""
        return self._run(lambda p: self.model.decode_step(p, cache, tokens),
                         params)

    # -- whole, on every rank ---------------------------------------------
    def gather_logits(self, logits, global_batch: int) -> torch.Tensor:
        """The logits of every row and every vocab entry from each
        rank's part (the vocab ranges ``sharding.unit_range`` gives,
        then the rows)."""
        if self.live is None:
            return logits
        from ..dist.collectives import all_gather, gather_part
        k = self.live.split(("model",))[0]
        if k > 1 and self.cfg.vocab >= k:
            logits = gather_part(logits, ("model",), self.live, -1,
                                 self.cfg.vocab)
        lo, hi = self.rows(global_batch)
        if hi - lo < global_batch:
            logits = all_gather(logits, shd.BATCH_AXES, self.live, 0)
        return logits

    def gather_cache(self, cache, global_batch: int, max_len: int
                     ) -> Dict[str, torch.Tensor]:
        """The whole cache from each rank's part."""
        if self.live is None:
            return cache
        from ..dist.collectives import all_gather
        out = {}
        for key, spec in self.cache_specs(global_batch, max_len).items():
            t = cache[key]
            for dim, axes in shd.spec_cuts(self.live, spec):
                t = all_gather(t, axes, self.live, dim)
            out[key] = t
        return out


def _serve_probe(model, params) -> None:
    """The serving forward whose cuts the program's gathers follow
    (``training.train.compute_cuts``): a prefill of one row and a decode
    step after it, on the meta device."""
    from ..training.train import _PROBE_SEQ
    seq = _PROBE_SEQ + (model.cfg.num_image_tokens or 0)
    batch = input_specs(model.cfg, ShapeSpec("probe", seq, 1, "prefill"))
    cache = model.init_cache(1, seq + 1, "meta")
    model.prefill(params, batch, cache)
    model.decode_step(params, cache,
                      torch.zeros((1, 1), dtype=torch.int32, device="meta"))


def serve_program(cfg: ArchConfig, mesh=None, rules=None,
                  device="cuda") -> ServeProgram:
    """The rank's serving program of ``cfg`` on ``mesh`` (a ``LiveMesh``,
    a spec bound to the default process group, or None: one device):
    the counterpart of the prefill and decode branches of the
    reference's ``lower_cell`` (:class:`ServeProgram`).  Tensors live on
    ``device``: ``"cuda"`` without a card raises rather than run on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the serving program is on 'cuda' but torch.cuda.is_available() "
            "is False; pass device='cpu' to serve on the CPU")
    return ServeProgram(cfg, mesh, rules, device)


def _mesh_context(live, rules):
    if live is None:
        return shd.use_mesh(None, rules)
    return shd.use_mesh(live, rules, local_batch=True)


def trace_program(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                  train_cfg=None, microbatches: Optional[int] = None,
                  rules: Optional[Dict[str, Any]] = None,
                  device="cuda") -> oa.OpTrace:
    """Trace this rank's program of the cell at ``cfg``'s own depth, on
    fake tensors on ``device`` (module docstring), whole: its
    :class:`~repro_torch.launch.op_analysis.OpTrace`.  A train cell's
    rows are those of ``train_cfg``'s microbatches, run as
    ``microbatches`` of them (default: all)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..training.train import TrainConfig
    check_device(device)
    live = _live(mesh, device)
    tc = train_cfg or TrainConfig()
    n = tc.microbatches if microbatches is None else microbatches
    model = get_model(cfg)
    with FakeTensorMode():
        if shape.kind == "train":
            from ..training.train import init_state, make_jitted_train_step
            with shd.use_mesh(live, rules):     # the state's placement
                state = _fake(init_state(model, 0, "meta", mesh=live),
                              device)
                fn = make_jitted_train_step(
                    model, dataclasses.replace(tc, microbatches=n),
                    mesh=live, donate=True)
                # one device's step is CUDA graphs on the card: count the
                # body they record, run op by op (a replay issues no op)
                fn = getattr(fn, "eager", fn)
            rows = _train_rows(shape, tc.microbatches, live) * n
            args = (state, _fake(_batch(cfg, shape, rows), device))
            run = lambda *a: _in_context(fn, live, rules, *a)
        else:
            prog = ServeProgram(cfg, live, rules, device)
            if live is not None:
                prog.plans      # the meta probe, before the count starts
            params = _fake(prog.param_shapes(), device)
            cache = prog.init_cache(shape.global_batch, shape.seq_len)
            lo, hi = prog.rows(shape.global_batch)
            batch = _fake(_batch(cfg, shape, hi - lo), device)
            if shape.kind == "prefill":
                run = lambda p, b, c: prog.prefill(p, b, c)
                args = (params, batch, cache)
            else:
                run = lambda p, t, c: prog.decode(p, c, t)
                args = (params, batch["tokens"], cache)
        return oa.analyze_trace(run, *args)[1]


def _in_context(fn, live, rules, *args):
    with _mesh_context(live, rules):
        return fn(*args)


@dataclasses.dataclass
class LoweredCell:
    """One rank's program of a cell, counted: the weighted
    :class:`~repro_torch.launch.op_analysis.OpCost` of the whole cell,
    the bytes of its arguments, outputs and donated (aliased) arguments
    at the cell's own depth, the peak's excess over the arguments
    (extrapolated from the traced depths: a peak is not a sum, so an
    estimate), the cell's depth and microbatches, what was traced, the
    device of the fake tensors."""

    cost: oa.OpCost
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    placed_argument_bytes: int
    depth: Dict[str, int]
    microbatches: int
    traced: List[Dict[str, Any]]
    rank: int
    device: str


def _placed(mesh, tree, axes_tree) -> int:
    """The bytes of ``tree``'s leaves on one device of ``mesh`` under the
    reference's placement (:func:`placements`)."""
    specs = dict(tree_flatten(placements(mesh, axes_tree, tree)))
    return sum(placed_bytes(mesh, t, specs[p]) for p, t in tree_flatten(tree))


def _arguments(cfg, shape, live, tc, rules) -> Tuple[int, int, int]:
    """(argument bytes, donated bytes, argument bytes under the
    reference's placement) of the cell at its own depth, from meta
    shapes: a train cell's state and rows, a serving cell's params, its
    part of the cache and its rows."""
    from ..training.train import init_state, state_axes
    model = get_model(cfg)
    with shd.use_mesh(live, rules):
        if shape.kind == "train":
            held = init_state(model, 0, "meta", mesh=live)
            rows = _train_rows(shape, tc.microbatches, live) * tc.microbatches
            whole, whole_axes = init_state(model, 0, "meta"), \
                state_axes(model)
        else:
            prog = ServeProgram(cfg, live, rules, "meta")
            cache = prog.init_cache(shape.global_batch, shape.seq_len)
            held = {"params": prog.param_shapes(), "cache": cache}
            lo, hi = prog.rows(shape.global_batch)
            rows = hi - lo
            whole = {"params": model.init(0, "meta"), "cache": model.init_cache(
                shape.global_batch, shape.seq_len, "meta")}
            whole_axes = {"params": model.param_axes(),
                          "cache": model.cache_axes()}
        batch = _batch(cfg, shape, rows)
        whole_batch = _batch(cfg, shape, shape.global_batch)
        if shape.kind == "decode":
            batch, whole_batch = ({"tokens": b["tokens"]}
                                  for b in (batch, whole_batch))
        donated = _nbytes(held if shape.kind == "train" else cache)
        args = _nbytes(held) + _nbytes(batch)
        if live is None:
            return args, donated, args
        placed = _placed(live, whole, whole_axes) + sum(
            placed_bytes(live, t, s) for t, s in zip(
                whole_batch.values(),
                batch_placement(live, whole_batch).values()))
        return args, donated, placed


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
               train_cfg=None, rules: Optional[Dict[str, Any]] = None,
               device="cuda") -> LoweredCell:
    """Count this rank's program of one cell on ``mesh`` (a ``LiveMesh``
    over the default process group, a spec bound to it, or None: one
    device), traced on fake tensors on ``device`` (module docstring) at
    :func:`depth_points`' depths and weighed to the cell's.  Train cells
    run ``train_cfg`` (default ``TrainConfig()``), traced at two
    microbatches when the cell has more (each further one adds what the
    trace's ``microbatch`` regions cost).  ``rules`` overrides
    logical-axis mappings, as the reference's: they steer the placements
    the record reports, a train cell's state and serving's cache
    placement; the models' own
    split compute (a train step's over ``model``, ``tp_psum``, the
    expert-parallel MoE) is the same under any rules."""
    from ..training.train import TrainConfig
    check_device(device)
    live = _live(mesh, device)
    tc = train_cfg or TrainConfig()
    n_full = tc.microbatches if shape.kind == "train" else 1
    n = min(n_full, 2)
    full = depth_kinds(cfg)
    points = depth_points(cfg)
    kinds = _varied([p for p, _ in points], full)
    traces = [trace_program(pcfg, shape, live, tc, n, rules, device)
              for _, pcfg in points]
    w = oa.depth_weights([{k: p[k] for k in kinds} for p, _ in points],
                         kinds)
    if n == n_full:
        cost = oa.weigh([t.cost for t in traces], w)
    else:
        per, rest = [], []
        for t in traces:
            if len(t.regions) != n or any(
                    r.counters() != t.regions[0].counters()
                    for r in t.regions):
                raise ValueError("the traced microbatches differ: a "
                                 "microbatch's counts must not depend on "
                                 "its index")
            per.append(t.regions[0])
            rest.append(t.cost - sum(t.regions[1:], t.regions[0]))
        cost = oa.weigh(rest, w) + oa.weigh(per, w).scaled(n_full)
    temp = oa.weigh_value([t.peak_bytes - t.argument_bytes
                           for t in traces], w)
    args, donated, placed = _arguments(cfg, shape, live, tc, rules)
    import torch.distributed as dist
    return LoweredCell(
        cost=cost, argument_bytes=args,
        output_bytes=donated + traces[-1].output_bytes,
        alias_bytes=donated, temp_bytes=temp, placed_argument_bytes=placed,
        depth=full, microbatches=n_full,
        traced=[{"depth": p, "microbatches": n, "ops": t.cost.ops,
                 "seconds": t.seconds} for (p, _), t in zip(points, traces)],
        rank=dist.get_rank() if live is not None else 0,
        device=torch.device(device).type)


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------
def analyze(lowered: LoweredCell, cfg: ArchConfig, shape: ShapeSpec,
            mesh=None) -> Dict[str, Any]:
    """The roofline terms of one counted cell, per rank, against one
    card's peaks (``launch/mesh.py``: the H100's bf16 FLOP/s, HBM and
    NVLink bytes/s).  The reference's XLA-only keys (``xla_raw_flops``,
    ``xla_raw_bytes``, ``unresolved_whiles``,
    ``generated_code_size_in_bytes``) have no counterpart and are left
    out."""
    from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    spec = getattr(mesh, "spec", mesh)
    sizes = dict(spec.axes) if spec is not None else {}
    chips = math.prod(sizes.values()) if sizes else 1
    c = lowered.cost
    coll = dict(c.collective_bytes)
    coll["total"] = c.collective_total
    terms = {"compute_s": c.flops / PEAK_FLOPS_BF16,
             "memory_s": c.hbm_bytes / HBM_BW,
             "collective_s": coll["total"] / NVLINK_BW}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    mflops = model_flops(cfg, shape)
    measured_global = c.flops * chips
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": sizes, "chips": chips,
        "rank": lowered.rank, "device": lowered.device,
        "flops_per_device": c.flops,
        "bytes_per_device": c.hbm_bytes,
        "collective_bytes_per_device": coll,
        "ops_per_device": c.ops,
        "memory_analysis": {
            "argument_size_in_bytes": lowered.argument_bytes,
            "output_size_in_bytes": lowered.output_bytes,
            "alias_size_in_bytes": lowered.alias_bytes,
            "temp_size_in_bytes": lowered.temp_bytes,
        },
        "argument_size_if_placed": lowered.placed_argument_bytes,
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / measured_global
                               if measured_global else 0.0),
        "step_time_bound_s": bound,
        "roofline_fraction": ((mflops / chips / PEAK_FLOPS_BF16) / bound
                              if bound > 0 else 0.0),
        "depth": lowered.depth,
        "microbatches": lowered.microbatches,
        "traced": lowered.traced,
    }
