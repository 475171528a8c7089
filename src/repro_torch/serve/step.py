"""The decode step of one batch bucket, over the persistent batched cache.

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
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..core.program import GraphPool, capture
from ..models.common import step_rows
from .slots import SlotManager


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
        if pool is None:
            raise ValueError("a decode step on a CUDA device captures into "
                             "a GraphPool")

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
        pool = self.pool
        stream = torch.cuda.current_stream(self.device)
        with pool.lock:
            if pool.done is None:
                pool.done = torch.cuda.Event()
            else:
                stream.wait_event(pool.done)
            self.graph.replay()
            pool.done.record(stream)
        return self.logits
