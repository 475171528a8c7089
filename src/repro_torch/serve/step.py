"""The serving programs: the decode step of one batch bucket, over the
persistent batched cache, and the two prefill programs.

The counterpart of the reference's jitted decode program that takes the
whole batched cache donated (``repro.serve.scheduler``'s
``decode_body``/``build_decode``): there XLA slices the first ``b``
rows, decodes them and writes them back into the donated buffer inside
one compiled program.  Here the step runs ``model.decode_step`` over
views of rows ``[0, b)`` of every cache leaf, each along its own batch
axis (:meth:`~repro_torch.serve.slots.SlotManager.rows`), so the model's
in-place K/V and state writes are the write-back.

Its inputs are the static ``(slots, 1)`` int32 token tensor (the
scheduler copies the host's last tokens into it before each call), the
params and the cache, all persistent; its output is the bucket's
logits, ``(b, 1, vocab)``.

Every bucket's step runs its norms and its logits at the scheduler's
full slot count (``models.common.step_rows``): at fewer rows the H100
rounds their f32 sums differently, so without it a row's logits would
depend on the bucket that computed them, and bucketed serving would not
give the tokens fixed-shape serving gives.  On a mesh that is the
*global* slot count, though a rank holds only its part of the rows.

On a mesh the step runs over this rank's local rows.  Where the slots
alone are split (``data``) it talks to no other rank and is captured as
on one device.  Where the KV sequence is split (``model``) its compute
view gathers the sequence whole every step and keeps this rank's part
of the new K/V after it (:meth:`SlotManager.gathered`/``keep``); that
talks over the process group, so the step runs eagerly (``captured``
False).

The prefill programs are the counterparts of the reference's compiled
prefill programs (``repro.serve.scheduler``'s ``build_chunk`` and
``build_prefill``), each captured into the scheduler's one
:class:`~repro_torch.core.program.GraphPool` on a CUDA device and run
eagerly, the same functions on the same static tensors, on the CPU:

* :class:`ChunkProgram` — ``prefill_chunk`` of one ``(1, C)`` chunk with
  ``start`` and ``length`` as device scalars, so one graph serves every
  chunk of every prompt.  A graph's addresses are fixed and every
  request prefills into a cache of its own, so the program stages: it
  copies the request's cache whole into its static cache, replays, and
  copies the chunk's ``C`` rows of each K/V leaf and ``pos`` back: a
  whole cache in and ``C / max_len`` of it out, a chunk.  The request's
  cache ends as the eager chunk would leave it, and the chunk's logits
  are the eager chunk's on the same values.
* :class:`PrefillProgram` — one per length bucket: the padded prefill
  and its fix-up (:func:`prefill_fixup`) over a static ``(1, L)`` token
  buffer, the model's extra inputs and ``length`` as a device scalar,
  into a single-row cache that the scheduler's programs share and that
  the scheduler splices into a slot right after each call.
* :class:`WholePrefillProgram` — one per exact prompt length, for a
  scheduler with neither chunks nor length buckets: plain
  ``model.prefill`` over a static ``(1, L)`` token buffer and the
  model's extra inputs, into a single-row cache that the scheduler's
  whole-prompt programs share (zeroed before each call, as a fresh
  cache is), the counterpart of the reference's prefill that it jits
  and retraces per prompt length.  Lengths arrive in any order, so
  these programs capture into a pool of their own, which
  :meth:`~repro_torch.core.program.GraphPool.place` lays out again
  when a longer prompt arrives.

Their outputs live in the pool, where the next replay of any program
may overwrite them, so a call returns a copy of its logits.  None of
them talks to another rank (the scheduler prefills whole on every
rank), so they are captured on a mesh too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..core.program import GraphPool, capture, replay
from ..models.common import step_rows
from .slots import SlotManager


def _need_pool(pool: Optional[GraphPool], what: str) -> None:
    if pool is None:
        raise ValueError(f"{what} on a CUDA device captures into a "
                         f"GraphPool")


class DecodeStep:
    """``model.decode_step`` over rows ``[0, batch)`` of ``slots``' cache
    and of the static ``tokens`` (on a mesh, the local rows this rank
    stores of them: none is a step that does nothing), captured on a
    CUDA device unless it gathers the cache over the mesh."""

    def __init__(self, model, params, slots: SlotManager,
                 tokens: torch.Tensor, batch: int,
                 pool: Optional[GraphPool] = None) -> None:
        if not 0 < batch <= slots.slots:
            raise ValueError(f"batch {batch} outside 1..{slots.slots}")
        self.model = model
        self.manager = slots
        self.params = params
        self.batch = batch
        #: The rows of the bucket this rank stores (all of them off a
        #: mesh); the tokens tensor holds this rank's rows.
        self.local = slots.local_rows(batch)
        self.slots = slots.slots
        self.device = tokens.device
        self.rows = slots.rows(self.local)
        self.tokens = tokens[:self.local]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.pool = pool
        #: Seconds of the warm-up and capture; bytes the capture added to
        #: the pool (CUDA only).
        self.capture_s = 0.0
        self.pool_bytes = 0
        #: Steps run through :meth:`__call__` (replays on a CUDA device).
        self.calls = 0
        if self.device.type != "cuda" or slots.seq_axes or not self.local:
            return
        _need_pool(pool, "a decode step")

        def warmup():
            scratch = slots.scratch()
            with step_rows(self.slots):
                model.decode_step(params, slots.rows(self.local, scratch),
                                  torch.zeros_like(self.tokens))

        t0 = time.perf_counter()
        self.graph, self.logits, self.pool_bytes = capture(
            self.eager, self.device, pool, warmup=warmup)
        self.capture_s = time.perf_counter() - t0

    @property
    def captured(self) -> bool:
        """True when each call is a replay of a CUDA graph."""
        return self.graph is not None

    def eager(self) -> Optional[torch.Tensor]:
        """One step run op by op (what the graph recorded), its norms
        and logits at the full slot count, over the compute view (None
        when this rank stores none of the bucket's rows)."""
        if not self.local:
            return None
        with torch.inference_mode(), step_rows(self.slots):
            view = self.manager.gathered(self.rows)
            logits = self.model.decode_step(self.params, view,
                                            self.tokens)[0]
            self.manager.keep(view, self.rows)
            return logits

    def __call__(self) -> Optional[torch.Tensor]:
        """One step: the graph's replay on a CUDA device (the static
        logits tensor, valid until the next replay of the pool), the
        eager step on the CPU."""
        self.calls += 1
        if self.graph is None:
            return self.eager()
        replay(self.pool, self.graph, self.device)
        return self.logits


def prefill_fixup(model, params, batch: Dict[str, torch.Tensor], cache,
                  length):
    """Prefill padded to the bucket, then recover the exact-length
    result: the pad positions' K/V entries are causally downstream of
    the real tokens, so after rewinding ``pos`` to the last real token
    and re-decoding it, the logits and every cache position the model
    can still attend to are those of an exact-length prefill's decode
    path (the reference's program, step by step).  ``length`` is a host
    int or a device scalar: ``pos`` is written and the last real token
    picked on the device."""
    _, cache = model.prefill(params, batch, cache)
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=cache["pos"].device)
    cache["pos"].copy_(length - 1)
    last = batch["tokens"].index_select(1, (length - 1).reshape(1).long())
    return model.decode_step(params, cache, last)


class ChunkProgram:
    """``model.prefill_chunk`` over static tensors: a ``(1, chunk)`` int32
    token buffer, 0-d ``start`` and ``length`` and a single-row staging
    cache of ``max_len`` rows; captured on a CUDA device at construction
    (one graph, or under ``causal_skip`` one per count of kv chunks a
    chunk can see), run eagerly on the CPU.  A call stages the request's
    cache through the static one (see the module's note)."""

    def __init__(self, model, params, chunk: int, max_len: int, device,
                 pool: Optional[GraphPool] = None) -> None:
        self.model = model
        self.params = params
        self.chunk = chunk
        self.device = torch.device(device)
        with torch.inference_mode():
            self.tokens = torch.zeros((1, chunk), dtype=torch.int32,
                                      device=self.device)
            self.start = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
            self.length = torch.full((), chunk, dtype=torch.int32,
                                     device=self.device)
            self.cache = model.init_cache(1, max_len, self.device)
        #: Each K/V leaf's sequence dim (the rows a chunk writes).
        self.seq_dims = {name: axes.index("kv_seq")
                         for name, axes in model.cache_axes().items()
                         if "kv_seq" in axes}
        self.pool = pool
        #: Graph and static logits by visible-chunk count (None without
        #: ``causal_skip``).
        self.graphs: Dict[Optional[int], "torch.cuda.CUDAGraph"] = {}
        self.logits: Dict[Optional[int], torch.Tensor] = {}
        #: Seconds of the warm-ups and captures; bytes they added to the
        #: pool (CUDA only); chunks run through :meth:`__call__`.
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.calls = 0
        if self.device.type != "cuda":
            return
        _need_pool(pool, "a chunk program")
        t0 = time.perf_counter()
        for count in self.counts():
            self.graphs[count], self.logits[count], added = capture(
                lambda count=count: self.eager(count), self.device, pool)
            self.pool_bytes += added
        self.capture_s = time.perf_counter() - t0

    def counts(self):
        """The visible-chunk counts of every chunk boundary a prompt can
        start a chunk at (``[None]`` without ``causal_skip``)."""
        name, dim = next(iter(self.seq_dims.items()))
        rows = self.cache[name].shape[dim]
        got = {self.model.visible_chunks(self.cache, self.chunk, s)
               for s in range(0, rows - self.chunk + 1, self.chunk)}
        return sorted(got, key=lambda n: -1 if n is None else n)

    @property
    def captured(self) -> bool:
        """True when each call is a replay of a CUDA graph."""
        return bool(self.graphs)

    def eager(self, visible: Optional[int] = None) -> torch.Tensor:
        """The chunk run op by op over the static tensors (what a graph
        recorded): its (1, 1, vocab) logits."""
        with torch.inference_mode():
            return self.model.prefill_chunk(
                self.params, self.tokens, self.cache, self.start,
                self.length, visible)[0]

    def __call__(self, tokens, cache, start: int, length: int):
        """One chunk of a request's prompt: ``tokens`` its (1, chunk)
        int32 tokens (padded past ``length``), ``cache`` its single-row
        cache (the chunk's rows and ``pos`` written in place), ``start``
        and ``length`` host ints.  ``(logits, cache)``: the logits a copy,
        (1, 1, vocab)."""
        c = self.chunk
        self.model.check_chunk(cache, c, start, length)
        count = self.model.visible_chunks(cache, c, start)
        graph = self.graphs.get(count)
        if self.captured and graph is None:
            raise ValueError(f"no graph captured for a chunk at {start} "
                             f"(it sees {count} kv chunks)")
        self.calls += 1

        def copy_in():
            self.tokens.copy_(torch.as_tensor(tokens, dtype=torch.int32)
                              .reshape(1, c))
            self.start.fill_(start)
            self.length.fill_(length)
            for name, leaf in cache.items():
                self.cache[name].copy_(leaf)

        def copy_out(logits):
            for name, leaf in cache.items():
                dim = self.seq_dims.get(name)
                if dim is None:
                    leaf.copy_(self.cache[name])
                else:
                    leaf.narrow(dim, start, c).copy_(
                        self.cache[name].narrow(dim, start, c))
            return logits.clone()

        with torch.inference_mode():
            if graph is None:
                copy_in()
                return copy_out(self.eager(count)), cache
            return replay(self.pool, graph, self.device, copy_in,
                           lambda: copy_out(self.logits[count])), cache


class PrefillProgram:
    """:func:`prefill_fixup` of one length bucket over static tensors: a
    ``(1, length)`` int32 token buffer, a 0-d ``length``, and the
    model's extra inputs and the single-row cache that the scheduler's
    programs share; captured on a CUDA device (its warm-up on a scratch
    cache, so a background capture writes nothing another program
    reads), run eagerly on the CPU."""

    def __init__(self, model, params, length: int, cache: Dict[str, Any],
                 extras: Dict[str, torch.Tensor], device,
                 pool: Optional[GraphPool] = None) -> None:
        self.model = model
        self.params = params
        self.bucket = length
        self.device = torch.device(device)
        self.cache = cache
        self.extras = extras
        with torch.inference_mode():
            self.tokens = torch.zeros((1, length), dtype=torch.int32,
                                      device=self.device)
            self.length = torch.ones((), dtype=torch.int32,
                                     device=self.device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        #: As :class:`ChunkProgram`'s.
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.calls = 0
        if self.device.type != "cuda":
            return
        _need_pool(pool, "a prefill program")

        def warmup():
            scratch = {k: torch.zeros_like(v) for k, v in cache.items()}
            prefill_fixup(model, params, self.batch(), scratch, self.length)

        t0 = time.perf_counter()
        self.graph, self.logits, self.pool_bytes = capture(
            self.eager, self.device, pool, warmup=warmup)
        self.capture_s = time.perf_counter() - t0

    @property
    def captured(self) -> bool:
        """True when each call is a replay of a CUDA graph."""
        return self.graph is not None

    def batch(self) -> Dict[str, torch.Tensor]:
        """The static batch: tokens and the extra inputs."""
        return {"tokens": self.tokens, **self.extras}

    def eager(self) -> torch.Tensor:
        """The padded prefill run op by op over the static tensors (what
        the graph recorded): its (1, 1, vocab) logits."""
        with torch.inference_mode():
            return prefill_fixup(self.model, self.params, self.batch(),
                                 self.cache, self.length)[0]

    def __call__(self, batch: Dict[str, Any], length: int):
        """Prefill one request: ``batch`` its tokens padded to the
        bucket, (1, bucket), and every extra input, ``length`` its
        prompt's length.  ``(logits, cache)``: the logits a copy,
        (1, 1, vocab); the cache the shared static one, valid until the
        next prefill program's call."""
        if tuple(batch["tokens"].shape) != tuple(self.tokens.shape) \
                or set(batch) != {"tokens", *self.extras} \
                or not 0 < length <= self.bucket:
            raise ValueError(
                f"the program of length bucket {self.bucket} takes tokens "
                f"(1, {self.bucket}) and {sorted(self.extras)}, a length "
                f"in 1..{self.bucket}; got {tuple(batch['tokens'].shape)}, "
                f"{sorted(set(batch) - {'tokens'})} and {length}")
        self.calls += 1

        def copy_in():
            for name, t in self.batch().items():
                t.copy_(batch[name])
            self.length.fill_(length)

        with torch.inference_mode():
            if self.graph is None:
                copy_in()
                return self.eager().clone(), self.cache
            return replay(self.pool, self.graph, self.device, copy_in,
                           lambda: self.logits.clone()), self.cache


class WholePrefillProgram:
    """``model.prefill`` of one exact prompt length over static tensors:
    a ``(1, length)`` int32 token buffer and the model's extra inputs
    and single-row cache that the scheduler's whole-prompt programs
    share; captured on a CUDA device (its warm-up on a scratch cache),
    run eagerly on the CPU.  ``order`` is the length (the pool's size
    key, :meth:`~repro_torch.core.program.GraphPool.place`)."""

    def __init__(self, model, params, length: int, cache: Dict[str, Any],
                 extras: Dict[str, torch.Tensor], device,
                 pool: Optional[GraphPool] = None) -> None:
        self.model = model
        self.params = params
        self.length = self.order = length
        self.device = torch.device(device)
        self.cache = cache
        self.extras = extras
        with torch.inference_mode():
            self.tokens = torch.zeros((1, length), dtype=torch.int32,
                                      device=self.device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        #: As :class:`ChunkProgram`'s (the latest capture's bytes).
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.calls = 0
        if self.device.type == "cuda":
            _need_pool(pool, "a whole-prompt prefill program")
            self.recapture()

    @property
    def captured(self) -> bool:
        """True when each call is a replay of a CUDA graph."""
        return self.graph is not None

    def batch(self) -> Dict[str, torch.Tensor]:
        """The static batch: tokens and the extra inputs."""
        return {"tokens": self.tokens, **self.extras}

    def eager(self) -> torch.Tensor:
        """The prefill run op by op over the static tensors (what the
        graph recorded): its logits."""
        with torch.inference_mode():
            return self.model.prefill(self.params, self.batch(),
                                      self.cache)[0]

    def recapture(self) -> None:
        """Capture the prefill into the pool on the static tensors it
        already has (again, after :meth:`release`); the warm-up writes a
        scratch cache, so it leaves the shared one as it found it."""
        def warmup():
            scratch = {k: torch.zeros_like(v) for k, v in self.cache.items()}
            self.model.prefill(self.params, self.batch(), scratch)

        t0 = time.perf_counter()
        self.graph, self.logits, self.pool_bytes = capture(
            self.eager, self.device, self.pool, warmup=warmup)
        self.capture_s += time.perf_counter() - t0

    def release(self) -> None:
        """Drop the graph and its static logits (the pool is laid out
        again)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.logits = None

    def __call__(self, batch: Dict[str, Any]):
        """Prefill one request: ``batch`` its tokens, (1, length), and
        every extra input.  ``(logits, cache)``: the last position's
        logits a copy, (1, 1, vocab); the cache the shared static one,
        valid until the next whole-prompt program's call."""
        if tuple(batch["tokens"].shape) != tuple(self.tokens.shape) \
                or set(batch) != {"tokens", *self.extras}:
            raise ValueError(
                f"the whole-prompt program of length {self.length} takes "
                f"tokens (1, {self.length}) and {sorted(self.extras)}; got "
                f"{tuple(batch['tokens'].shape)} and "
                f"{sorted(set(batch) - {'tokens'})}")
        self.calls += 1

        def copy_in():
            for leaf in self.cache.values():
                leaf.zero_()
            for name, t in self.batch().items():
                t.copy_(batch[name])

        with torch.inference_mode():
            if self.device.type != "cuda":
                copy_in()
                return self.eager()[:, -1:].clone(), self.cache
            if self.graph is None:        # its recapture failed
                self.recapture()
            return replay(self.pool, self.graph, self.device, copy_in,
                          lambda: self.logits[:, -1:].clone()), self.cache
