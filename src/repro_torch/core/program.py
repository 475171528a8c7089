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
* the graph and its static outputs; a call returns clones of the
  outputs, so the next call never overwrites a tensor a caller holds;
* the eager program it was captured from (:attr:`eager`), whose split
  counters the graph reads.

Every program of one executable captures into one :class:`GraphPool`:
one memory pool (``torch.cuda.graph_pool_handle()``) for the
intermediates of all its batch sizes, so device memory grows with the
largest batch captured, not with the number of batch sizes served.
The caching allocator hands a capture the blocks earlier captures
freed only where they are large enough: a batch larger than every
captured one would take new segments for each of its intermediates,
and batch sizes arriving in ascending order would each add a pool.  So
such a batch lays the pool out again, largest first
(:meth:`GraphPool.admit`; :meth:`GraphPool.place` for programs of any
kind, ordered by a key their caller gives: the ``engine`` forward's
input elements, a whole-prompt prefill's length, a train step's batch
elements): once the last replay has ended on the card,
every program releases its graph, the pool takes a fresh id (the old
one's memory returns at the next capture's ``empty_cache``), the new
program is captured, then the others again in descending batch order,
each on the static inputs it already had.  Two graphs that share
intermediates must never run on the card at once, and a host lock does
not order the card: so under the pool's lock every replay first makes
the caller's stream wait for the event the previous replay of the
executable recorded (after its output clones), then copies in, replays
and clones on that stream, and records the event again.  Static inputs
and static outputs stay referenced by their programs, so no capture is
handed another program's live tensor, and the programs replay in any
order.

Capture warms up on a side stream first (the first call loads the
kernel library, picks cuDNN algorithms and allocates the counters), as
the ``torch.cuda.graph`` documentation prescribes, then captures with
``capture_error_mode="thread_local"``, so a background capture and a
replay on another thread do not disturb each other.  A capture only
records: the background worker that captures a bucket never replays
it, and a replay of another program meanwhile runs nothing the
capture wrote.  Captures take one process-wide lock: a
capture under way makes CUDA refuse a device-wide
``torch.cuda.synchronize()`` on every thread, and each capture starts
with one.  For the same reason a thread that serves requests while a
bucket is captured in the background synchronises its stream
(``torch.cuda.current_stream().synchronize()``), never the device: a
refused synchronise also fails the capture.  A capture that fails
raises and leaves nothing behind (the engine cache captures the bucket
again at its next call, and a program whose recapture failed captures
again at its own next call): there is no fallback to the eager walk on
a CUDA device.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, TypeVar

import torch

from ..runtime.spans import span
from .lowering import LoweredGraph

P = TypeVar("P")
#: Graph input name -> (per-example shape, torch dtype).
InputSpecs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
#: One capture at a time in the process (see the module's note).
_CAPTURE_LOCK = threading.Lock()
#: The side stream captures warm up on, by device (under the lock).
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class GraphPool:
    """The memory pool, lock and replay-ordering event that the captured
    programs of one executable share (see the module's note).  ``bytes``
    is what their captures added to ``torch.cuda.memory_reserved``: the
    pool."""

    def __init__(self, device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"GraphPool needs a CUDA device, got {device}")
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        #: Recorded after each replay's clones; None before the first.
        self.done: Optional[torch.cuda.Event] = None
        self.bytes = 0

    def admit(self, eager: LoweredGraph, inputs: InputSpecs,
              held: Sequence["CapturedProgram"]) -> "CapturedProgram":
        """Capture ``eager`` into the pool beside ``held``, the programs
        captured into it before, ordered by batch (:meth:`place`)."""
        return self.place(
            lambda: CapturedProgram(eager, inputs, self.device, self),
            eager.ctx.batch_size, held)

    def place(self, make: Callable[[], "P"], order: int,
              held: Sequence["P"]) -> "P":
        """The program ``make()`` captures into the pool beside ``held``,
        the programs captured into it before.  ``order`` is the caller's
        size key, what each program's ``order`` holds (a batch, a
        program's input elements, a prompt length): a key above all of
        theirs lays the pool out again, largest first (see the module's
        note), so keys arriving in ascending order share one pool.  Each
        program has ``order``, ``release()`` and ``recapture()``.  If a
        capture fails it raises, and a held program left without a graph
        captures again at its next call."""
        if not held or order <= max(p.order for p in held):
            return make()
        with self.lock:
            if self.done is not None:
                self.done.synchronize()
            for p in held:
                p.release()
            self.handle = torch.cuda.graph_pool_handle()
            self.bytes = 0
            prog = make()
            for p in sorted(held, key=lambda p: -p.order):
                p.recapture()
        return prog


class CapturedProgram:
    """A :class:`LoweredGraph` captured as one CUDA graph for its batch,
    into ``pool`` (a pool of its own when None).  Not to be confused
    with a capture bundle (``api/capture.py::CaptureSession``), which
    records a whole compile for ``python -m repro_torch.replay``; a
    bundle recorded on the card holds this program's replayed outputs.

    Calling it maps input tensors (by graph input name) to fresh output
    tensors, like the eager program.  With ``rows`` below the batch the
    inputs hold that many examples: they fill the first rows of the
    static inputs, the rest are zeroed, and the outputs keep the first
    ``rows`` rows (a batch bucket's padding)."""

    def __init__(self, eager: LoweredGraph, inputs: InputSpecs,
                 device: torch.device,
                 pool: Optional[GraphPool] = None) -> None:
        if device.type != "cuda":
            raise ValueError(f"CapturedProgram needs a CUDA device, got "
                             f"{device}; run the LoweredGraph on the CPU")
        self.eager = eager
        self.batch = self.order = eager.ctx.batch_size
        self.device = device
        self.pool = pool if pool is not None else GraphPool(device)
        # Created outside inference mode: callers write into them.
        with torch.inference_mode(False):
            self.static_inputs = {
                n: torch.zeros((self.batch,) + tuple(shape), dtype=dtype,
                               device=device)
                for n, (shape, dtype) in inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_outputs: Optional[Dict[str, torch.Tensor]] = None
        self.recapture()

    def recapture(self) -> None:
        """Capture the eager program into the pool, on the static inputs
        it already has (again, after :meth:`release`)."""
        t0 = time.perf_counter()
        self.graph, self.static_outputs, self.pool_bytes = capture(
            lambda: self.eager(self.static_inputs), self.device, self.pool)
        #: Seconds of the latest warm-up and capture.
        self.capture_s = time.perf_counter() - t0

    def release(self) -> None:
        """Drop the graph and its static outputs: the pool's memory is
        returned once every program captured into it has released its
        own."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static_outputs = None

    def __call__(self, env: Dict[str, torch.Tensor],
                 rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
        rows = self.batch if rows is None else rows
        cut = rows != self.batch
        self._check(env, rows)
        pool = self.pool
        stream = torch.cuda.current_stream(self.device)
        with pool.lock:
            if self.graph is None:        # its recapture failed
                self.recapture()
            if pool.done is None:
                pool.done = torch.cuda.Event()
            else:
                stream.wait_event(pool.done)
            with span("input"):
                for name, t in env.items():
                    static = self.static_inputs[name]
                    if t is static:
                        continue
                    if cut:
                        static[:rows].copy_(t)
                        static[rows:].zero_()
                    else:
                        static.copy_(t)
            with span("replay"):
                self.graph.replay()
            with span("output"):
                out = {k: (v[:rows] if cut else v).clone()
                       for k, v in self.static_outputs.items()}
            pool.done.record(stream)
            return out

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


def _retire(pool: GraphPool) -> None:
    """A capture that fails (another thread's device-wide synchronise
    invalidates it) leaves its pool id refused by the allocator's next
    capture ("already recording"), even after the recording is ended.
    So end it (later captures must not allocate into it) and take a
    fresh pool id for the executable's later captures; the programs
    captured before keep theirs alive, and every replay stays ordered
    after the previous one."""
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(),
                                         pool.handle)
    except Exception:
        pass          # the capture ended its recording itself
    pool.handle = torch.cuda.graph_pool_handle()


def capture(fn: Callable[[], object], device: torch.device,
            pool: GraphPool, warmup: Optional[Callable[[], object]] = None,
            inference: bool = True
            ) -> Tuple[torch.cuda.CUDAGraph, object, int]:
    """Warm ``fn()`` up on a side stream, then capture one call of it into
    ``pool``: ``(graph, what the captured call returned, bytes the
    capture added to the pool)``.  Used for programs and for the
    autotuner's measurements alike.  ``warmup`` replaces ``fn`` in the
    warm-up, for a ``fn`` that writes state a real call must not touch
    (the serve scheduler's decode step, which writes the live KV cache:
    its warm-up runs the same step on scratch tensors of the same
    shapes, and only the recording names the live cache).  Both run
    under ``torch.inference_mode()`` unless ``inference`` is False (the
    train step, whose backward autograd must record)."""
    with _CAPTURE_LOCK, torch.cuda.device(device), \
            torch.inference_mode(inference):
        # One warm-up stream per device (captures hold the lock): a new
        # stream would make cuBLAS/cuDNN set up workspaces for it, which
        # the allocator keeps.
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (fn if warmup is None else warmup)()
        torch.cuda.current_stream(device).wait_stream(side)
        # torch.cuda.graph empties the allocator's cache as it starts;
        # doing it first makes the reserved bytes before and after the
        # capture differ by what it added to the pool.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        # The outer stream context restores this thread's stream if the
        # capture fails (torch.cuda.graph's exit then skips it).  A graph
        # or tensor that the cyclic collector frees in the middle of the
        # recording (a graph's destructor, a pool's release) invalidates
        # it, so no collection runs while it records (torch.cuda.graph
        # collects once before it starts).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(torch.cuda.current_stream(device)), \
                    torch.cuda.graph(graph, pool=pool.handle,
                                     capture_error_mode="thread_local"):
                out = fn()
        except BaseException:
            _retire(pool)
            raise
        finally:
            if collecting:
                gc.enable()
        added = torch.cuda.memory_reserved(device) - reserved
        pool.bytes += added
    return graph, out, added


def replay(pool: GraphPool, graph: "torch.cuda.CUDAGraph", device,
           copy_in: Optional[Callable[[], None]] = None,
           copy_out: Optional[Callable[[], Any]] = None) -> Any:
    """One replay of ``graph`` in ``pool``'s order (see the module's
    note): under the pool's lock the stream waits for the event of the
    pool's previous replay, ``copy_in()`` fills the static inputs, the
    graph replays, ``copy_out()`` copies what the caller keeps, and the
    event is recorded; ``copy_out``'s result."""
    stream = torch.cuda.current_stream(device)
    with pool.lock:
        if pool.done is None:
            pool.done = torch.cuda.Event()
        else:
            stream.wait_event(pool.done)
        if copy_in is not None:
            copy_in()
        with span("replay"):
            graph.replay()
        out = copy_out() if copy_out is not None else None
        pool.done.record(stream)
    return out
