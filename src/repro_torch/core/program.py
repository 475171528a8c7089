"""One prepared program per batch size as a captured CUDA graph.

The counterpart of the reference's AOT-compiled XLA executable
(``repro.api.targets.JitExecutable._compile_batch``): where the
reference lowers and compiles one XLA program per batch size, the port
records one call of the prepared :class:`~repro_torch.core.lowering.
LoweredGraph` as a CUDA graph and replays it.  The replay runs the same
kernels in the same order on the same addresses, so its outputs are the
eager program's bit for bit, and one call costs one graph launch
instead of a Python walk over the nodes.

A :class:`CapturedProgram` owns:

* static input tensors for its batch size, which every call copies its
  inputs into (a caller that passes the static tensor itself, from
  :attr:`CapturedProgram.static_inputs`, skips the copy: path B's KV
  cache is written there once, not copied per call);
* the graph and its private memory pool, which holds every intermediate
  and the static outputs; a call returns clones of the outputs, so the
  next call never overwrites a tensor a caller holds;
* the eager program it was captured from (:attr:`eager`), whose split
  counters the graph reads.

Capture warms up on a side stream first (the first call loads the
kernel library, picks cuDNN algorithms and allocates the counters), as
the ``torch.cuda.graph`` documentation prescribes, then captures with
``capture_error_mode="thread_local"``, so a background capture and a
replay on another thread do not disturb each other.  Captures take one
process-wide lock: a capture under way makes CUDA refuse a device-wide
``torch.cuda.synchronize()`` on every thread, and each capture starts
with one.  For the same reason a thread that serves requests while a
bucket is captured in the background synchronises its stream
(``torch.cuda.current_stream().synchronize()``), never the device: a
refused synchronise also fails the capture.  A capture that fails
raises and leaves nothing behind (the engine cache captures the bucket
again at its next call): there is no fallback to the eager walk on a
CUDA device.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import torch

from .lowering import LoweredGraph

#: Graph input name -> (per-example shape, torch dtype).
InputSpecs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
#: One capture at a time in the process (see the module's note).
_CAPTURE_LOCK = threading.Lock()


class CapturedProgram:
    """A :class:`LoweredGraph` captured as one CUDA graph for its batch.

    Calling it maps input tensors (by graph input name) to fresh output
    tensors, like the eager program.  With ``rows`` below the batch the
    inputs hold that many examples: they fill the first rows of the
    static inputs, the rest are zeroed, and the outputs keep the first
    ``rows`` rows (a batch bucket's padding)."""

    def __init__(self, eager: LoweredGraph, inputs: InputSpecs,
                 device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"CapturedProgram needs a CUDA device, got "
                             f"{device}; run the LoweredGraph on the CPU")
        self.eager = eager
        self.batch = eager.ctx.batch_size
        self.device = device
        self._lock = threading.Lock()
        t0 = time.perf_counter()
        # Created outside inference mode: callers write into them.
        with torch.inference_mode(False):
            self.static_inputs = {
                n: torch.zeros((self.batch,) + tuple(shape), dtype=dtype,
                               device=device)
                for n, (shape, dtype) in inputs.items()}
        with _CAPTURE_LOCK, torch.cuda.device(device), \
                torch.inference_mode():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                eager(self.static_inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            # torch.cuda.graph empties the allocator's cache as it starts;
            # doing it first makes the reserved bytes before and after
            # the capture differ by the graph's pool.
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.graph = torch.cuda.CUDAGraph()
            # The outer stream context restores this thread's stream if
            # the capture fails (torch.cuda.graph's exit then skips it).
            with torch.cuda.stream(torch.cuda.current_stream(device)), \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                self.static_outputs = eager(self.static_inputs)
            #: Device memory the capture reserved: the graph's private
            #: pool (every intermediate and the static outputs).
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        #: Seconds of warm-up and capture.
        self.capture_s = time.perf_counter() - t0

    def __call__(self, env: Dict[str, torch.Tensor],
                 rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
        rows = self.batch if rows is None else rows
        cut = rows != self.batch
        self._check(env, rows)
        with self._lock:
            for name, t in env.items():
                static = self.static_inputs[name]
                if t is static:
                    continue
                if cut:
                    static[:rows].copy_(t)
                    static[rows:].zero_()
                else:
                    static.copy_(t)
            self.graph.replay()
            return {k: (v[:rows] if cut else v).clone()
                    for k, v in self.static_outputs.items()}

    def _check(self, env: Dict[str, torch.Tensor], rows: int) -> None:
        """Hold each input to ``rows`` rows of its static tensor's shape
        and dtype: ``copy_`` would broadcast a smaller input (one KV
        cache into every row, which the eager program refuses) or
        convert another dtype without a word."""
        if not 0 < rows <= self.batch or set(env) != set(self.static_inputs):
            raise ValueError(
                f"the program captured for batch {self.batch} takes inputs "
                f"{sorted(self.static_inputs)} of 1..{self.batch} rows, got "
                f"{sorted(env)} of {rows}")
        for name, t in env.items():
            static = self.static_inputs[name]
            want = (rows,) + tuple(static.shape[1:])
            if tuple(t.shape) != want or t.dtype != static.dtype:
                raise ValueError(
                    f"input {name!r}: expected {want} {static.dtype}, got "
                    f"{tuple(t.shape)} {t.dtype}")
