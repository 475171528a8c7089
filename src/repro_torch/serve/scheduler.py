"""Continuous-batching request scheduler over a compiled model.

The port of ``repro.serve.scheduler``.  The step loop rebatches every
decode step:

    1. admit — while capacity is free and requests wait, pick one (FCFS,
       shortest-prompt, or earliest-deadline), prefill it — whole-prompt
       at admission, or one ``prefill_chunk`` per step interleaved with
       decode so long prompts never block in-flight decodes — splice its
       cache row into the batched cache and sample its first token;
    2. decode — ONE batched decode step advances every active slot: a
       :class:`~repro_torch.serve.step.DecodeStep` over the first rows
       of the persistent batched cache, updated in place.  On a CUDA
       device every step is one replay of a CUDA graph captured per
       batch bucket (the reference's AOT-compiled program per bucket
       with the cache donated), so steady-state decode allocates
       nothing and moves no buffer;
    3. sample + evict — per-slot sampling, EOS / length retirement frees
       slots for the next iteration's admissions.

Prefill runs through the counterparts of the reference's compiled
prefill programs (``serve/step.py``): one chunk program whose ``start``
and ``length`` are device scalars, built and captured at construction,
or one padded-prefill program per length bucket, captured largest first
in the background like the decode buckets.  On a CUDA device each is a
CUDA graph in the scheduler's one graph pool, on the CPU the same
functions run eagerly.  A scheduler with neither prefills through one
whole-prompt program per prompt length, captured at the length's first
admission, as the reference retraces its prefill per prompt length;
``summary()["engines"]`` says which programs are captured.

Requests whose prompts share a common head (the "system prompt"
scenario) prefill that head once: with ``prefix_cache`` enabled the
scheduler snapshots the head's KV rows at a chunk boundary and later
requests splice a copy, prefilling only their tail — bit-identical to
unshared prefill (see :mod:`repro_torch.serve.prefix`).

``submit`` is thread-safe and non-blocking, so a producer can feed the
queue while another thread drives ``step`` / ``run``.  Per-request
metrics (TTFT, decode tok/s, queue depth at submit, deadline/SLO
outcome) and aggregate counters come from an injected clock, so tests
assert exact numbers.

Every tensor the scheduler makes or writes is made and written under
``torch.inference_mode()`` (the executable's and the capture's mode): a
cache made there cannot be written outside it.  The serving loop never
synchronises the device, only its stream (a sampled token's ``.item()``
and the token copy): a device-wide synchronise while a bucket is
captured in the background fails that capture.

Mesh serving (``SchedulerOptions.mesh``) runs one scheduler per rank of
a ``torch.distributed`` group, every rank fed the same requests in the
same order.  It is placement, never math, as in the reference: the
params stay whole on every rank, prefill runs whole on every rank, and
each rank stores its part of the batched cache (``serve/slots.py``) and
decodes its own rows.  So that every rank makes the same scheduling
decision, rank 0 picks each request to admit and the others follow it
(their clocks and deadlines may differ); a slot's tokens are sampled
by the ranks that store it and all-gathered over the ``batch`` axes
after each step, so every rank's bookkeeping sees every slot.
``summary()["sharding"]`` counts the collectives the decode steps
issue, per mesh axis; ``summary()["faults"]`` records a
``MeshUnavailableError`` raised when the visible devices shrink.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import extra_input_specs
from ..core.program import GraphPool
from ..dist.collectives import LiveMesh, all_gather, broadcast
from ..dist.mesh import (MeshUnavailableError, available_devices,
                         ensure_mesh_available)
from ..dist.propagate import merged_rules
from ..inference.fold_norms import fold_norms
from ..models import common as C
from ..runtime.buckets import Bucket, BucketPolicy
from ..runtime.engine_cache import EngineCache
from ..runtime.spans import span
from .metrics import RequestMetrics, SchedulerMetrics
from .options import SchedulerOptions
from .prefix import PrefixCache, common_prefix_len
from .slots import CachePlacement, SlotManager, SlotState
from .step import (ChunkProgram, DecodeStep, PrefillProgram,
                   WholePrefillProgram)


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens, budget, sampling knobs,
    optional extra model inputs and an optional first-token SLO."""

    uid: int
    prompt: np.ndarray            # (s,) int32
    max_new_tokens: int = 32
    eos_id: int = -1              # -1 = never
    temperature: float = 0.0      # 0 = greedy
    #: Additional named model inputs consumed at prefill (the model
    #: signature's non-token inputs: ``frames`` for audio families,
    #: ``patches`` for VLMs).  Arrays may carry the leading batch dim
    #: (of 1) or omit it.  Missing extras are zero-filled; names the
    #: model does not declare are rejected at ``submit``.
    inputs: Optional[Dict[str, np.ndarray]] = None
    #: First-token SLO in milliseconds (relative to submit).  Sets the
    #: request's absolute deadline on the scheduler clock; the
    #: ``"deadline"`` admission policy schedules earliest-deadline-first
    #: and ``summary()`` counts ``slo_violations``.  None = no SLO.
    slo_ms: Optional[float] = None


@dataclasses.dataclass
class _PrefillTask:
    """One in-flight chunked prefill: a request whose prompt is being
    fed through the chunk program ``prefill_chunk`` tokens per step.
    Counts against slot capacity so a free slot is guaranteed when the
    final chunk lands and the task activates."""

    req: Request
    prompt: np.ndarray                    # (plen,) int32
    cache: Any                            # single-row cache, filled in place
    offset: int = 0                       # tokens prefilled so far
    logits: Any = None                    # last-token logits, latest chunk
    snapshot_at: Optional[int] = None     # chunk boundary to snapshot
    snapshot_key: Optional[bytes] = None  # pending PrefixCache key


@dataclasses.dataclass
class Completion:
    """Finished request: generated tokens and why generation stopped."""

    uid: int
    tokens: List[int]
    finish_reason: str = "length"   # "eos" | "length"


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when ``SchedulerOptions.max_queue`` is hit."""


class TemperatureSampler:
    """Default sampler: greedy at temperature 0, categorical otherwise.

    The sampler protocol is ``sample(logits, temperature, *, uid, index)
    -> int`` with ``logits`` of shape (1, vocab) and ``index`` the
    number of tokens already generated for that request — tests inject
    fakes that script tokens per request.  On a CUDA device ``logits``
    may be a row of the decode step's static output, valid until the
    next step: a sampler that keeps it must copy it.

    Greedy is ``argmax``, which takes the first maximum, as
    ``jnp.argmax`` does.  Temperature sampling draws each token from a
    CPU ``torch.Generator`` seeded from ``(seed, uid, index)``, so a
    request's draws depend on neither the device, the order the
    scheduler samples its slots in, nor which rank of a mesh samples
    them; its bits are not ``jax.random``'s.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)

    def __call__(self, logits: torch.Tensor, temperature: float, *,
                 uid: int, index: int) -> int:
        if temperature <= 0.0:
            return int(torch.argmax(logits, dim=-1)[0])
        mask = (1 << 64) - 1
        key = np.random.SeedSequence(
            [self.seed & mask, int(uid) & mask, int(index) & mask])
        gen = torch.Generator().manual_seed(
            int(key.generate_state(1, np.uint64)[0]))
        probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen)[0, 0])


class CollectiveLog:
    """Collectives a serving rank issued: count per op, and count, result
    bytes and host ms per mesh axis (a collective over several axes
    counts once on each and splits its bytes and ms evenly)."""

    def __init__(self, axes: Sequence[str] = ()) -> None:
        self.counts: Dict[str, int] = {}
        self.per_axis = {a: {"count": 0, "bytes": 0.0, "ms": 0.0}
                         for a in axes}

    def record(self, op: str, axes: Sequence[str], nbytes: int,
               ms: float) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        for a in axes:
            entry = self.per_axis[a]
            entry["count"] += 1
            entry["bytes"] += nbytes / len(axes)
            entry["ms"] += ms / len(axes)

    def summary(self) -> dict:
        return {"counts": dict(self.counts),
                "per_axis": {a: dict(v) for a, v in self.per_axis.items()},
                "total_bytes": int(sum(v["bytes"]
                                       for v in self.per_axis.values()))}


def _device_count(devices) -> int:
    """A ``device_source`` reading: a count, or a sequence of devices."""
    return devices if isinstance(devices, int) else len(devices)


class Scheduler:
    """Drive a compiled model under concurrent multi-request load, on
    the device its params are on."""

    def __init__(self, model, params, options: SchedulerOptions, *,
                 sampler: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 engine_worker: str = "thread",
                 device_source: Optional[Callable] = None,
                 precision_info: Optional[dict] = None) -> None:
        self.model = model
        self.cfg = model.cfg
        self.options = options
        # Audit record from the compiled executable (repro_torch.serve
        # fills it in): active precision + per-site decision counts,
        # surfaced verbatim in summary()["precision"].
        self.precision_info = dict(precision_info) if precision_info \
            else None
        if options.fold:
            params, self.fold_report = fold_norms(self.cfg, params)
        else:
            self.fold_report = {"folds": 0}
        self.params = params
        self.device = params["embed"].device
        self.sampler = sampler or TemperatureSampler(options.seed)
        self.clock = clock

        # data×model-parallel serving: bind the mesh (one process a
        # device) before any step is built.  ``device_source`` is the
        # fault-injection seam: it returns the visible devices (a count
        # or a sequence), and a shrink raises a typed MeshUnavailableError
        # in the step loop (recorded in ``summary()["faults"]``).
        self.mesh: Optional[LiveMesh] = None
        self._faults: List[dict] = []
        self._device_source = device_source or available_devices
        placement = None
        self.collectives = CollectiveLog()
        if options.mesh is not None:
            ensure_mesh_available(options.mesh,
                                  _device_count(self._device_source()))
            if not options.mesh.is_single_device:
                self.mesh = LiveMesh(options.mesh, self.device)
                placement = CachePlacement(self.mesh,
                                           self._rule_axes("batch"),
                                           self._rule_axes("kv_seq"))
                self.collectives = CollectiveLog(
                    self.mesh.canonical(self.mesh.spec.names))
                # small host-side exchanges ride the group's own device
                self._wire = torch.device(
                    "cpu" if self.mesh.backend == "gloo" else self.device)

        self.slot_manager = SlotManager(model, options.slots,
                                        options.max_len, self.device,
                                        placement, self.collectives)
        self._lock = threading.Lock()
        self._queue: List[Request] = []
        self.done: List[Completion] = []
        self._pending: List[Completion] = []  # finished, not yet popped
        self.generated: Dict[int, List[int]] = {}
        self.request_metrics: Dict[int, RequestMetrics] = {}
        self.metrics = SchedulerMetrics()
        self.last_token = np.zeros((options.slots, 1), np.int32)
        # The decode steps' static input: this rank's rows of last_token
        # are copied in before each step.
        with torch.inference_mode():
            self._tokens = torch.zeros(
                (self.slot_manager.local_slots, 1), dtype=torch.int32,
                device=self.device)
        # One graph pool for every bucket's captured step, laid out by
        # the full-slots step, which is captured first.
        self._pool = GraphPool(self.device) \
            if self.device.type == "cuda" else None
        # every decode step built, one per distinct count of local rows
        self._steps: List[DecodeStep] = []
        self._steps_lock = threading.Lock()

        # shape-polymorphic serving (repro_torch.runtime): a warm step
        # per batch bucket, background captures.  None = fixed shape.
        self._decode_engine = None
        self._prefill_engine = None
        # chunked prefill + shared-prefix snapshots (both optional)
        self._chunk_engine = None
        self._prefix_cache: Optional[PrefixCache] = None
        self._prefilling: List[_PrefillTask] = []
        if options.prefill_chunk is not None:
            self._init_chunking(engine_worker)
        if options.buckets is not None:
            self._init_bucketing(engine_worker)
        # With neither chunks nor length buckets: one whole-prompt
        # program per prompt length, built at its first admission.
        self._whole: Optional[Dict[int, WholePrefillProgram]] = None
        if self._chunk_engine is None and self._prefill_engine is None:
            self._init_whole_prefill()
        # Fixed shape: the one full-slots step, captured now (load time,
        # not latency).
        self._decode = (self._build_step(options.slots)
                        if self._decode_engine is None else None)

    def _build_step(self, batch: int) -> DecodeStep:
        """The step of bucket ``batch``.  On a mesh two buckets may give
        this rank the same rows (all of its slots, or none): they share
        one step, so the graph pool holds one capture of it."""
        local = self.slot_manager.local_rows(batch)
        with self._steps_lock:
            for step in self._steps:
                if step.local == local:
                    return step
        step = DecodeStep(self.model, self.params, self.slot_manager,
                          self._tokens, batch, self._pool)
        with self._steps_lock:
            self._steps.append(step)
        return step

    # -- mesh ----------------------------------------------------------
    def _rule_axes(self, logical: str):
        """Mesh axes the logical-axis rule maps to, filtered to axes
        this mesh has (``batch`` → data axes, ``kv_seq`` → the model
        axes of the flash-decoding KV layout)."""
        names = set(self.mesh.spec.names)
        return tuple(a for a in merged_rules().get(logical, ())
                     if a in names)

    def _check_mesh(self) -> None:
        """Step-loop fault check: raise (and record) a typed
        :class:`MeshUnavailableError` naming the unfillable axes when
        the visible device set shrank below what the mesh needs."""
        if self.options.mesh is None:
            return
        try:
            ensure_mesh_available(self.options.mesh,
                                  _device_count(self._device_source()))
        except MeshUnavailableError as e:
            self._faults.append({
                "at": self.clock(), "mesh": e.spec.describe(),
                "needed": e.needed, "available": e.available,
                "missing_axes": list(e.missing_axes)})
            raise

    def _rows_split(self) -> bool:
        """True when ranks store different slots (on a mesh whose
        ``batch`` axes divide them): tokens are exchanged."""
        return self.slot_manager.row_split[0] > 1

    def _follow_rank0(self, uid: Optional[int]) -> Optional[int]:
        """Rank 0's admission choice (a uid, or None), on every rank."""
        t = torch.tensor([-1 if uid is None else uid], dtype=torch.int64,
                         device=self._wire)
        got = int(broadcast(t, self.mesh.spec.names, self.mesh, 0)[0])
        return None if got < 0 else got

    def _share_first_token(self, slot: int, tok: Optional[int]) -> int:
        """The first token of ``slot``, sampled by the ranks that store
        the slot, on every rank of their ``batch`` group."""
        sm = self.slot_manager
        t = torch.tensor([-1 if tok is None else tok], dtype=torch.int64,
                         device=self._wire)
        return int(broadcast(t, sm.placement.batch, self.mesh,
                             slot // sm.local_slots)[0])

    def _exchange(self, toks: Dict[int, int], active: List[int]
                  ) -> Dict[int, int]:
        """Every active slot's sampled token: this rank's ``toks`` and
        the other ranks' own, all-gathered over the ``batch`` axes."""
        sm = self.slot_manager
        if not self._rows_split():
            return toks
        local = torch.full((sm.local_slots,), -1, dtype=torch.int32,
                           device=self._wire)
        for slot, tok in toks.items():
            local[slot - sm.row0] = tok
        axes = sm.placement.batch
        t0 = time.perf_counter()
        every = all_gather(local, axes, self.mesh, dim=0)
        self.collectives.record("all-gather", self.mesh.canonical(axes),
                                every.numel() * every.element_size(),
                                (time.perf_counter() - t0) * 1e3)
        every = every.tolist()
        return {slot: every[slot] for slot in active}

    # -- bucketed engines ----------------------------------------------
    def _cache_spec(self, max_len: int) -> Dict[str, Any]:
        """The single-row cache's leaves on the meta device."""
        return self.model.init_cache(1, max_len, "meta")

    def _cache_grows_with_max_len(self) -> bool:
        """False for ring caches (all-sliding-window models), whose
        capacity is the window, and for state caches (SSM), whose size
        does not depend on ``max_len``.  Padded prefill would roll real
        tokens out of a ring, so length bucketing is only sound when the
        cache actually holds ``max_len`` positions."""
        a = C.tree_flatten(self._cache_spec(self.options.max_len))
        b = C.tree_flatten(self._cache_spec(self.options.max_len + 1))
        return any(x.shape != y.shape for (_, x), (_, y) in zip(a, b))

    def _init_bucketing(self, worker: str) -> None:
        opts = self.options
        policy = opts.buckets.clip(max_batch=opts.slots,
                                   max_len=opts.max_len)
        len_ok = (policy.len_buckets
                  and "pos" in self._cache_spec(opts.max_len)
                  and self._cache_grows_with_max_len())

        # Every bucket's step runs over the first rows of the one batched
        # cache, in place (see serve/step.py).
        self._decode_engine = EngineCache(
            BucketPolicy(batch_buckets=policy.batch_buckets),
            lambda bucket: self._build_step(bucket.batch),
            worker=worker, clock=self.clock)
        # the full-slots step covers every batch, so capturing it
        # synchronously here (load time, not latency) guarantees the
        # decode path never stalls, and it lays the graph pool out for
        # the smaller buckets, which fill in behind it.  Steps that
        # gather the cache over a mesh capture nothing and are all built
        # here: every rank must pick the same bucket, its gathers' size.
        self._decode_engine.warm_up([Bucket(opts.slots)], block=True)
        self._decode_engine.warm_up(
            block=bool(self.slot_manager.seq_axes))

        # chunked prefill supersedes padded whole-prompt prefill: every
        # prompt runs through the (single-bucket) chunk program instead
        if not len_ok or self._chunk_engine is not None:
            return
        # one single-row cache and one set of extra inputs that every
        # bucket's program fills: a call's cache is spliced into its slot
        # before the next call
        with torch.inference_mode():
            cache = self._new_cache()
            extras = {name: torch.zeros(shape, dtype=C.torch_dtype(dt),
                                        device=self.device)
                      for name, (shape, dt) in
                      extra_input_specs(self.cfg).items()}
        self._prefill_engine = EngineCache(
            BucketPolicy(batch_buckets=(1,),
                         len_buckets=policy.len_buckets),
            lambda bucket: PrefillProgram(
                self.model, self.params, bucket.length, cache, extras,
                self.device, self._pool),
            worker=worker, clock=self.clock)
        # largest length bucket first: it covers every admissible
        # prompt, so fallback coverage arrives as early as possible
        self._prefill_engine.warm_up(
            tuple(reversed(self._prefill_engine.policy.enumerate_buckets())))

    def _init_chunking(self, worker: str) -> None:
        """Set up chunked prefill — one length bucket of exactly
        ``prefill_chunk`` tokens, built synchronously at construction —
        plus the optional shared-prefix snapshot cache.

        Families without incremental prefill keep whole-prompt prefill
        silently (MLA latent caches, vlm/audio extra inputs, ring and
        state caches whose size is not ``max_len``) — surfaced in
        ``summary()["chunked_prefill"]["enabled"]``.
        """
        opts = self.options
        supports = getattr(self.model, "supports_chunked_prefill", None)
        if not (supports is not None and supports()
                and "pos" in self._cache_spec(opts.max_len)
                and self._cache_grows_with_max_len()):
            return
        # captured now (a failed capture raises): every chunk replays it
        self._chunk_engine = EngineCache(
            BucketPolicy(batch_buckets=(1,),
                         len_buckets=(opts.prefill_chunk,)),
            lambda bucket: ChunkProgram(self.model, self.params,
                                        bucket.length, opts.max_len,
                                        self.device, self._pool),
            worker=worker, clock=self.clock)
        self._chunk_engine.warm_up(block=True)
        if opts.prefix_cache > 0:
            self._prefix_cache = PrefixCache(opts.prefix_cache)

    def _init_whole_prefill(self) -> None:
        """The whole-prompt programs' shared single-row cache and extra
        inputs (a call's cache is spliced into its slot before the next
        call) and, on a CUDA device, their pool: a pool of their own,
        because prompt lengths arrive in any order and a longer one lays
        it out again (``GraphPool.place``), which must not touch the
        decode steps.  On a mesh they are captured as on one device: the
        scheduler prefills whole on every rank, talking to no other
        rank."""
        self._whole = {}
        with torch.inference_mode():
            self._whole_cache = self._new_cache()
            self._whole_extras = {
                name: torch.zeros(shape, dtype=C.torch_dtype(dt),
                                  device=self.device)
                for name, (shape, dt) in extra_input_specs(self.cfg).items()}
        self._whole_pool = GraphPool(self.device) \
            if self.device.type == "cuda" else None

    def _whole_program(self, length: int) -> WholePrefillProgram:
        """The whole-prompt program of ``length`` tokens, built (and on
        the card captured) at its first call, as the reference traces
        its prefill once per prompt length."""
        prog = self._whole.get(length)
        if prog is None:
            make = lambda: WholePrefillProgram(
                self.model, self.params, length, self._whole_cache,
                self._whole_extras, self.device, self._whole_pool)
            prog = make() if self._whole_pool is None else \
                self._whole_pool.place(make, length,
                                       list(self._whole.values()))
            self._whole[length] = prog
        return prog

    def whole_prefill_programs(self) -> List[WholePrefillProgram]:
        """The whole-prompt programs built so far, shortest first (none
        where chunks or length buckets prefill)."""
        return [self._whole[n] for n in sorted(self._whole or {})]

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until every scheduled background build has landed
        (True) or the timeout expires.  No-op without bucketing."""
        ok = True
        for eng in (self._decode_engine, self._prefill_engine,
                    self._chunk_engine):
            if eng is not None:
                ok = eng.wait_warm(timeout) and ok
        return ok

    def shutdown(self) -> None:
        """Stop the background capture workers (daemon threads — safe
        to skip, but tests join them for determinism)."""
        for eng in (self._decode_engine, self._prefill_engine,
                    self._chunk_engine):
            if eng is not None:
                eng.shutdown()

    # -- queue ---------------------------------------------------------
    def submit(self, req: Request) -> RequestMetrics:
        """Enqueue a request (thread-safe, non-blocking).

        Raises :class:`QueueFullError` under admission control and
        ``ValueError`` if the prompt alone exceeds ``max_len``.
        """
        plen = int(np.asarray(req.prompt).shape[-1])
        if plen >= self.options.max_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit max_len="
                f"{self.options.max_len} (uid={req.uid})")
        if req.inputs:
            allowed = extra_input_specs(self.cfg)
            unknown = sorted(set(req.inputs) - set(allowed))
            if unknown:
                raise ValueError(
                    f"unknown inputs {unknown} for {self.cfg.name!r} "
                    f"(family {self.cfg.family!r}); accepted extras: "
                    f"{sorted(allowed) or 'none'} (uid={req.uid})")
            # Shapes are rejected HERE, not at admission: by admission
            # time the request is out of the queue and a raise would
            # kill the step loop with other requests in flight.
            for name, a in req.inputs.items():
                shape = allowed[name][0]
                got = tuple(a.shape)
                if got not in (shape, shape[1:]):
                    raise ValueError(
                        f"input {name!r}: expected {shape} (or the "
                        f"batch-less {shape[1:]}), got {got} "
                        f"(uid={req.uid})")
        with self._lock:
            if (self.options.max_queue is not None
                    and len(self._queue) >= self.options.max_queue):
                self.metrics.rejected += 1
                raise QueueFullError(
                    f"queue full ({self.options.max_queue}); "
                    f"rejecting uid={req.uid}")
            if req.uid in self.request_metrics:
                raise ValueError(f"duplicate request uid={req.uid}")
            depth = len(self._queue)
            self._queue.append(req)
            self.metrics.submitted += 1
            self.metrics.peak_queue_depth = max(
                self.metrics.peak_queue_depth, len(self._queue))
            m = RequestMetrics(uid=req.uid, prompt_tokens=plen,
                               submitted_at=self.clock(),
                               queue_depth_at_submit=depth)
            if req.slo_ms is not None:
                m.deadline = m.submitted_at + req.slo_ms / 1e3
            self.request_metrics[req.uid] = m
            return m

    def queue_depth(self) -> int:
        """Requests waiting for admission (thread-safe snapshot)."""
        with self._lock:
            return len(self._queue)

    def num_active(self) -> int:
        """Slots currently generating."""
        return self.slot_manager.num_active()

    def _blocked(self, req: Request) -> bool:
        """True while an in-flight prefill is about to snapshot a head
        this request's prompt starts with: admitting it NOW would
        re-prefill the shared head; waiting the few steps until the
        snapshot lands turns it into a prefix hit."""
        if self._prefix_cache is None:
            return False
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        for t in self._prefilling:
            h = t.snapshot_at
            if (t.snapshot_key is not None and h is not None
                    and h < len(prompt)
                    and prompt[:h].tobytes() == t.snapshot_key):
                return True
        return False

    def _choose(self) -> Optional[int]:
        """The queue index the admission policy picks next (None: none)."""
        if not self._queue:
            return None
        cand = range(len(self._queue))
        if self._prefix_cache is not None and self._prefilling:
            cand = [j for j in cand
                    if not self._blocked(self._queue[j])]
            if not cand:
                return None    # every waiter gains by waiting
        if self.options.admission == "shortest":
            return min(cand, key=lambda j: (len(self._queue[j].prompt), j))
        if self.options.admission == "deadline":
            # earliest deadline first; no-SLO requests after every
            # deadline, FCFS among themselves
            def urgency(j):
                d = self.request_metrics[self._queue[j].uid].deadline
                return (0, d, j) if d is not None else (1, 0.0, j)
            return min(cand, key=urgency)
        return next(iter(cand))                     # fcfs

    def _pop_next(self) -> Optional[Request]:
        """The next request to admit, out of the queue.  On a mesh rank
        0's choice, on every rank."""
        with self._lock:
            i = self._choose()
            if self.mesh is None:
                return None if i is None else self._queue.pop(i)
            uid = None if i is None else self._queue[i].uid
        uid = self._follow_rank0(uid)
        if uid is None:
            return None
        with self._lock:
            for i, req in enumerate(self._queue):
                if req.uid == uid:
                    return self._queue.pop(i)
        raise RuntimeError(
            f"rank 0 admitted uid={uid}, which this rank's queue does not "
            f"hold: every rank of a mesh must submit the same requests")

    # -- admission -----------------------------------------------------
    def _prefill_batch(self, prompt: np.ndarray,
                       extras: Optional[Dict[str, Any]] = None,
                       device=None) -> Dict[str, torch.Tensor]:
        """The named multi-input prefill batch on ``device`` (the
        scheduler's by default; the host for a prefill program, which
        copies it in): tokens plus the model signature's extra inputs —
        request-supplied where given (batch dim added if omitted),
        zero-filled otherwise."""
        device = self.device if device is None else device
        batch = {"tokens": torch.as_tensor(np.asarray(prompt, np.int32),
                                           device=device)}
        extras = extras or {}
        for name, (shape, dtype) in extra_input_specs(self.cfg).items():
            dt = C.torch_dtype(dtype)
            if name in extras:
                a = torch.as_tensor(extras[name], dtype=dt, device=device)
                if a.ndim == len(shape) - 1:
                    a = a[None]
                if tuple(a.shape) != shape:
                    raise ValueError(
                        f"input {name!r}: expected {shape} "
                        f"(or the batch-less {shape[1:]}), got "
                        f"{tuple(a.shape)}")
                batch[name] = a
            else:
                batch[name] = torch.zeros(shape, dtype=dt, device=device)
        return batch

    def _new_cache(self) -> Dict[str, Any]:
        """A fresh single-row cache for one request's prefill."""
        return self.model.init_cache(1, self.options.max_len, self.device)

    def _admit_free_slots(self) -> None:
        if self._chunk_engine is not None:
            self._admit_chunked()
            return
        for slot in self.slot_manager.free_slots():
            req = self._pop_next()
            if req is None:
                return
            m = self.request_metrics[req.uid]
            m.admitted_at = self.clock()
            self.metrics.admitted += 1
            if self.metrics.started_at is None:
                self.metrics.started_at = m.admitted_at

            prompt = np.asarray(req.prompt, np.int32)[None, :]
            with span("prefill", req.uid):
                if self._prefill_engine is not None:
                    # the bucket's program: its cache is the programs'
                    # shared one, spliced into the slot by _activate
                    # before the next
                    plen = prompt.shape[1]
                    entry, bucket, _ = self._prefill_engine.get(1, plen)
                    padded = np.zeros((1, bucket.length), np.int32)
                    padded[:, :plen] = prompt
                    logits, one = entry(
                        self._prefill_batch(padded, req.inputs, "cpu"),
                        plen)
                else:
                    # the length's program: its cache is the whole-prompt
                    # programs' shared one, spliced into the slot by
                    # _activate before the next
                    logits, one = self._whole_program(prompt.shape[1])(
                        self._prefill_batch(prompt, req.inputs, "cpu"))
            self._activate(slot, req, logits[:, -1], one)

    def _admit_chunked(self) -> None:
        """Chunked admission: a popped request becomes a
        :class:`_PrefillTask` (advanced one chunk per step) instead of
        being prefilled inline.  Tasks count against slot capacity so a
        slot is free when each one completes; shared heads are taken
        from / planned into the prefix cache here."""
        opts = self.options
        while (len(self._prefilling) + self.slot_manager.num_active()
               < opts.slots):
            req = self._pop_next()
            if req is None:
                return
            m = self.request_metrics[req.uid]
            m.admitted_at = self.clock()
            self.metrics.admitted += 1
            if self.metrics.started_at is None:
                self.metrics.started_at = m.admitted_at
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            task = _PrefillTask(req=req, prompt=prompt, cache=None)
            if self._prefix_cache is not None:
                hit = self._prefix_cache.take(prompt)
                if hit is not None:
                    task.offset, task.cache = hit
            if task.cache is None:
                task.cache = self._new_cache()
                if self._prefix_cache is not None:
                    self._plan_snapshot(task)
            self._prefilling.append(task)

    def _plan_snapshot(self, task: _PrefillTask) -> None:
        """On a prefix miss: if waiting prompts share a head with this
        one, mark the chunk boundary where this prefill should snapshot
        it (the head is then prefilled ONCE; sharers block in the queue
        until the snapshot lands and take a copy)."""
        chunk = self.options.prefill_chunk
        plen = len(task.prompt)
        with self._lock:
            queued = [np.asarray(r.prompt, np.int32).reshape(-1)
                      for r in self._queue]
        lcp = max((common_prefix_len(task.prompt, p) for p in queued),
                  default=0)
        head = (min(lcp, plen - 1) // chunk) * chunk
        if head < max(chunk, self.options.min_prefix):
            return
        key = PrefixCache.key_for(task.prompt[:head])
        if key in self._prefix_cache or any(
                t.snapshot_key == key for t in self._prefilling):
            return
        task.snapshot_at = head
        task.snapshot_key = key

    def _advance_prefills(self) -> None:
        """Advance every in-flight chunked prefill by ONE chunk — the
        interleaving that keeps long prompts from blocking decodes —
        then activate tasks whose prompt is complete."""
        if not self._prefilling:
            return
        chunk_len = self.options.prefill_chunk
        finished = []
        for task in self._prefilling:
            n = min(chunk_len, len(task.prompt) - task.offset)
            with span("chunk", task.req.uid):
                chunk = np.zeros((1, chunk_len), np.int32)
                chunk[0, :n] = task.prompt[task.offset:task.offset + n]
                entry, _, _ = self._chunk_engine.get(1, n)
                # the program stages the task's own cache through its
                # static one; the logits are a copy, kept until the task
                # activates
                task.logits, task.cache = entry(chunk, task.cache,
                                                task.offset, n)
            task.offset += n
            self.metrics.prefill_chunks += 1
            if (task.snapshot_key is not None
                    and task.offset == task.snapshot_at):
                self._prefix_cache.insert(task.snapshot_key, task.offset,
                                          task.cache)
                task.snapshot_key = None
                task.snapshot_at = None
            if task.offset >= len(task.prompt):
                finished.append(task)
        for task in finished:
            self._prefilling.remove(task)
            slot = self.slot_manager.free_slots()[0]
            self._activate(slot, task.req, task.logits[:, 0], task.cache)

    def _activate(self, slot: int, req: Request, logits: torch.Tensor,
                  one_cache: Any) -> None:
        """Prefill is done: sample the first token from its (1, vocab)
        logits, splice the single-row cache into ``slot`` and record
        first-token metrics (including the SLO verdict).  Where ranks
        store different slots, the slot's ranks sample it and share it."""
        with span("sample", req.uid):
            if self._rows_split():
                tok = (self.sampler(logits, req.temperature, uid=req.uid,
                                    index=0)
                       if self.slot_manager.owns(slot) else None)
                tok = self._share_first_token(slot, tok)
            else:
                tok = self.sampler(logits, req.temperature, uid=req.uid,
                                   index=0)
        # clamp so prompt + generated tokens can never outrun the
        # per-slot cache capacity
        plen = int(np.asarray(req.prompt).shape[-1])
        budget = self.options.max_len - plen
        self.slot_manager.admit(slot, SlotState(
            uid=req.uid,
            remaining=min(req.max_new_tokens, budget) - 1,
            eos_id=req.eos_id,
            temperature=req.temperature), one_cache)
        self.last_token[slot, 0] = tok
        self.generated[req.uid] = [tok]
        m = self.request_metrics[req.uid]
        m.first_token_at = self.clock()
        m.new_tokens = 1
        self.metrics.total_new_tokens += 1
        if m.deadline is not None:
            m.slo_violated = bool(m.first_token_at > m.deadline)
            if m.slo_violated:
                self.metrics.slo_violations += 1
        if tok == req.eos_id or min(req.max_new_tokens, budget) <= 1:
            self._retire(slot, "eos" if tok == req.eos_id else "length")

    # -- retirement ----------------------------------------------------
    def _retire(self, slot: int, reason: str) -> None:
        st = self.slot_manager.evict(slot)
        m = self.request_metrics[st.uid]
        m.finished_at = self.clock()
        m.finish_reason = reason
        self.metrics.completed += 1
        c = Completion(st.uid, self.generated[st.uid],
                       finish_reason=reason)
        self.done.append(c)
        self._pending.append(c)

    # -- decode --------------------------------------------------------
    def _run_step(self, step: DecodeStep) -> Optional[torch.Tensor]:
        """Copy this rank's last tokens into the static token tensor, run
        one step (a replay on the card); the (b, vocab) logits of this
        rank's rows of the bucket (None when it stores none)."""
        sm = self.slot_manager
        self._tokens.copy_(torch.from_numpy(
            self.last_token[sm.row0:sm.row0 + sm.local_slots]))
        logits = step()
        return None if logits is None else logits[:, 0]

    def _bucketed_decode(self, k: int) -> torch.Tensor:
        """One decode step at the best warm batch bucket for ``k``
        active slots.  Compacts actives into rows ``[0, k)`` and runs the
        bucket's step over the first rows of the batched cache, in place
        (per row what decoding at the full slot count gives, minus the
        work for the empty rows; the logits cover the bucket's rows)."""
        for src, dst in self.slot_manager.compact():
            self.last_token[dst, 0] = self.last_token[src, 0]
        entry, _, _ = self._decode_engine.get(k)
        return self._run_step(entry)

    # -- the step loop -------------------------------------------------
    def step(self) -> int:
        """One scheduler iteration: admit into free slots, one batched
        decode step, sample + evict.  Returns the number of slots still
        active afterwards."""
        with torch.inference_mode(), span("step"):
            return self._step()

    def _step(self) -> int:
        self._check_mesh()          # no-op unless mesh-parallel serving
        with span("admit"):
            self._admit_free_slots()
        self._advance_prefills()    # no-op unless chunked prefill is on
        active = self.slot_manager.active_slots()
        if not active:
            return 0
        with span("decode"):
            if self._decode_engine is not None:
                logits = self._bucketed_decode(len(active))
                active = self.slot_manager.active_slots()  # post-compaction
            else:
                logits = self._run_step(self._decode)
        self.metrics.decode_steps += 1
        self.metrics.decode_slot_steps += len(active)
        sm = self.slot_manager
        toks = {}
        with span("sample"):
            for slot in active:
                if not sm.owns(slot):
                    continue
                st = sm.state(slot)
                row = slot - sm.row0
                toks[slot] = self.sampler(
                    logits[row:row + 1], st.temperature, uid=st.uid,
                    index=self.request_metrics[st.uid].new_tokens)
        toks = self._exchange(toks, active)
        for slot in active:
            st = sm.state(slot)
            m = self.request_metrics[st.uid]
            tok = toks[slot]
            self.generated[st.uid].append(tok)
            self.last_token[slot, 0] = tok
            m.new_tokens += 1
            self.metrics.total_new_tokens += 1
            st.remaining -= 1
            if tok == st.eos_id:
                self._retire(slot, "eos")
            elif st.remaining <= 0:
                self._retire(slot, "length")
        self.metrics.last_step_at = self.clock()
        return self.slot_manager.num_active()

    def run(self, max_steps: int = 10_000) -> List[Completion]:
        """Drain the queue; returns all completions in finish order."""
        steps = 0
        while ((self.queue_depth() or self.slot_manager.num_active()
                or self._prefilling)
               and steps < max_steps):
            self.step()
            steps += 1
        return self.done

    def pop_completions(self, *, purge: bool = False) -> List[Completion]:
        """Completions finished since the last pop (streaming drain).

        With ``purge=True`` the scheduler also forgets the popped
        requests entirely — their ``done`` entries, token lists,
        per-request metrics — and their uids become reusable.  A
        long-running server MUST drain with ``purge=True`` or
        per-request state grows without bound (aggregate
        ``SchedulerMetrics`` counters are unaffected; purged requests
        simply drop out of ``summary()``'s mean-TTFT)."""
        out, self._pending = self._pending, []
        if purge and out:
            drop = {c.uid for c in out}
            self.done = [c for c in self.done if c.uid not in drop]
            for uid in drop:
                self.generated.pop(uid, None)
                self.request_metrics.pop(uid, None)
        return out

    # -- reporting -----------------------------------------------------
    def summary(self) -> dict:
        """Aggregate metrics: counters and TTFT/queue percentiles, plus
        runtime engine stats, the active-precision audit record, and
        chunked-prefill / prefix-cache sections when those features are
        active (the reference's keys)."""
        engines = {}
        if self._decode_engine is not None:
            engines["decode"] = self._decode_engine.stats()
        if self._prefill_engine is not None:
            engines["prefill"] = self._prefill_engine.stats()
        if self._chunk_engine is not None:
            engines["chunk"] = self._chunk_engine.stats()
        out = self.metrics.summary(self.request_metrics)
        if engines:
            rt = {k: sum(e[k] for e in engines.values())
                  for k in ("bucket_hits", "bucket_misses",
                            "fallback_serves", "background_compiles",
                            "compile_stalls")}
            pad = sum(e["pad_elems"] for e in engines.values())
            total = sum(e["total_elems"] for e in engines.values())
            rt["pad_waste_frac"] = (pad / total) if total else 0.0
            rt.update(engines)
            out["runtime"] = rt
        if self.precision_info is not None:
            out["precision"] = dict(self.precision_info)
        if self.options.prefill_chunk is not None:
            out["chunked_prefill"] = {
                "enabled": self._chunk_engine is not None,
                "chunk_len": self.options.prefill_chunk,
            }
        if self._prefix_cache is not None:
            out["prefix_cache"] = self._prefix_cache.stats()
        if self.options.mesh is not None:
            out["faults"] = [dict(f) for f in self._faults]
            out["sharding"] = self._sharding_summary()
        out["engines"] = self._engines_summary()
        return out

    def _engines_summary(self) -> dict:
        """The port's own key: each serving program this scheduler runs,
        whether every one built so far is a CUDA graph (``captured``),
        and how many there are.  ``whole_prefill`` (no chunk or length
        buckets) has one program per prompt length seen, as the
        reference retraces its prefill per length; a decode step that
        gathers the cache over a mesh is eager."""
        steps = [s for s in self.decode_steps() if s.local]
        out = {"decode": {"captured": bool(steps) and all(
            s.captured for s in steps), "programs": len(steps)}}
        for name, eng in (("chunk", self._chunk_engine),
                          ("prefill", self._prefill_engine)):
            if eng is not None:
                progs = [eng.peek(b) for b in eng.warm_buckets()]
                out[name] = {"captured": bool(progs) and all(
                    p.captured for p in progs), "programs": len(progs)}
        if self._whole is not None:
            progs = self.whole_prefill_programs()
            out["whole_prefill"] = {"captured": bool(progs) and all(
                p.captured for p in progs), "programs": len(progs)}
        return out

    def decode_steps(self) -> List[DecodeStep]:
        """The built decode steps (each warm bucket's, or the fixed one),
        each once."""
        with self._steps_lock:
            return list(self._steps)

    def _sharding_summary(self) -> dict:
        """The mesh, its devices, the decode steps, and the collectives
        the decode steps issued on this rank, per mesh axis: the KV
        gathers over ``kv_seq``'s axes and the token exchange over
        ``batch``'s (the reference's keys, counted where the reference
        reads its compiled programs, plus each axis's host ``ms``).
        ``captured``: every decode step with rows on this rank a CUDA
        graph."""
        spec = self.options.mesh
        steps = self.decode_steps()
        return {"mesh": spec.describe(), "devices": spec.size,
                "decode_programs": len(steps),
                "collectives": self.collectives.summary(),
                "captured": all(s.captured for s in steps if s.local),
                "local_slots": self.slot_manager.local_slots}

    # legacy Engine attribute surface, used by the deprecated shim
    @property
    def cache(self) -> Any:
        """The batched KV cache (legacy ``Engine.cache`` surface)."""
        return self.slot_manager.cache
