"""EngineCache — warm executables per bucket, compiled off the hot path.

The port's copy of ``repro.runtime.engine_cache`` (pure Python; only
its docstrings and the worker thread's name differ).

The runtime half of shape-polymorphic serving.  An :class:`EngineCache`
maps :class:`~repro_torch.runtime.buckets.Bucket` → a *warm* compiled entry
(whatever the injected ``build`` callable returns — a captured CUDA
graph program, a specialized callable, an Executable).  Dispatch never
compiles on the request path:

* **hit** — the exact bucket is warm: run it.
* **miss** — the bucket is cold: enqueue a background compile (a daemon
  worker thread builds it and atomically swaps it in) and serve the
  request *now* on the nearest warm larger bucket (more padding, same
  semantics).  The next dispatch of that bucket after the swap is a hit.
* **stall** — nothing warm covers the shape: the only case that builds
  synchronously on the request path.  ``warm_up()`` at construction
  exists precisely so this never happens in steady state; the counter
  makes it observable (the serve bench asserts it stays zero).

Thread-safe: ``get`` may be called from the serving loop while the
worker compiles.  The swap is a dict assignment under a lock — readers
either see the old state (fallback) or the new one (hit), never a
half-built entry.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from .buckets import Bucket, BucketPolicy

#: Worker modes: ``"thread"`` (default) compiles cold buckets on a
#: daemon thread; ``"sync"`` compiles inline at miss (every miss is a
#: stall — the pre-bucketing behavior, for comparison); ``"manual"``
#: queues compiles until :meth:`EngineCache.drain` (deterministic tests).
WORKER_MODES = ("thread", "sync", "manual")


class EngineCache:
    """In-process bucket → warm-executable cache with async warm-up."""

    def __init__(self, policy: BucketPolicy,
                 build: Callable[[Bucket], Any], *,
                 worker: str = "thread",
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if worker not in WORKER_MODES:
            raise ValueError(f"worker must be one of {WORKER_MODES}, "
                             f"got {worker!r}")
        self.policy = policy
        self._build = build
        self._worker_mode = worker
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[Bucket, Any] = {}
        self._inflight: set = set()          # queued or compiling
        self._queue: "queue.Queue[Optional[Bucket]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # counters (read under the lock via stats())
        self.bucket_hits = 0
        self.bucket_misses = 0
        self.background_compiles = 0
        self.compile_stalls = 0
        self.fallback_serves = 0
        self.compile_ms = 0.0
        self._pad_elems = 0
        self._total_elems = 0

    # -- worker --------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker_loop, daemon=True,
                name="repro-torch-engine-cache")
            self._thread.start()

    def _worker_loop(self) -> None:
        while True:
            bucket = self._queue.get()
            if bucket is None:                    # shutdown sentinel
                return
            self._compile(bucket, background=True)

    def _compile(self, bucket: Bucket, *, background: bool) -> Any:
        """Build ``bucket`` and atomically swap it in.  Build failures
        drop the in-flight mark so a later dispatch can retry (or
        stall-compile with the error surfaced on the caller)."""
        t0 = self._clock()
        try:
            entry = self._build(bucket)
        except Exception:
            with self._lock:
                self._inflight.discard(bucket)
            if not background:
                raise
            return None
        with self._lock:
            self._entries[bucket] = entry
            self._inflight.discard(bucket)
            if background:
                self.background_compiles += 1
            self.compile_ms += (self._clock() - t0) * 1e3
        return entry

    def _schedule(self, bucket: Bucket) -> None:
        """Queue a background compile of ``bucket`` exactly once."""
        if self._worker_mode == "sync":
            return          # sync mode never compiles off the call path
        with self._lock:
            if (self._closed or bucket in self._entries
                    or bucket in self._inflight):
                return
            self._inflight.add(bucket)
        if self._worker_mode == "thread":
            self._ensure_thread()
        self._queue.put(bucket)

    def drain(self, max_items: Optional[int] = None) -> int:
        """Compile queued buckets on the calling thread (``"manual"``
        worker mode — tests control exactly when swap-in happens).
        Returns the number of buckets compiled."""
        n = 0
        while max_items is None or n < max_items:
            try:
                bucket = self._queue.get_nowait()
            except queue.Empty:
                return n
            if bucket is None:
                continue
            self._compile(bucket, background=True)
            n += 1
        return n

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until no compile is queued or in flight (steady state).
        In ``"manual"`` mode this drains inline."""
        if self._worker_mode == "manual":
            self.drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight and self._queue.empty():
                    return True
            time.sleep(0.005)
        return False

    def shutdown(self) -> None:
        """Stop accepting work and join the warm-up thread (idempotent)."""
        with self._lock:
            self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=10.0)

    # -- warm-up -------------------------------------------------------
    def warm_up(self, buckets: Optional[Iterable[Bucket]] = None, *,
                block: bool = False) -> None:
        """Compile ``buckets`` (default: every bucket the policy
        enumerates).  ``block=True`` compiles synchronously — server
        start, where a stall is load time, not latency; otherwise the
        background worker fills them in while traffic is served on
        whatever is already warm."""
        todo = tuple(buckets) if buckets is not None \
            else self.policy.enumerate_buckets()
        for b in todo:
            if block:
                with self._lock:
                    have = b in self._entries
                    if not have:
                        self._inflight.add(b)
                if not have:
                    self._compile(b, background=False)
            else:
                self._schedule(b)

    def peek(self, bucket: Bucket) -> Any:
        """The warm entry for ``bucket`` (None if cold) without touching
        the dispatch counters."""
        with self._lock:
            return self._entries.get(bucket)

    def put(self, bucket: Bucket, entry: Any) -> None:
        """Swap a pre-built entry in (pre-warming from a persistent
        cache at construction)."""
        with self._lock:
            self._entries[bucket] = entry
            self._inflight.discard(bucket)

    # -- dispatch ------------------------------------------------------
    def _nearest_warm(self, want: Bucket) -> Optional[Bucket]:
        """Smallest warm bucket ≥ ``want`` in every dimension (minimal
        padded area, batch as tiebreak)."""
        best: Optional[Bucket] = None
        for b in self._entries:
            if b.batch < want.batch:
                continue
            if want.length is not None:
                if b.length is None or b.length < want.length:
                    continue
            elif b.length is not None:
                continue
            area = b.batch * (b.length or 1)
            if best is None or area < best.batch * (best.length or 1) \
                    or (area == best.batch * (best.length or 1)
                        and b.batch < best.batch):
                best = b
        return best

    def get(self, batch: int, length: Optional[int] = None
            ) -> Tuple[Any, Bucket, bool]:
        """Resolve ``(batch, length)`` to a warm entry.

        Returns ``(entry, bucket, exact)`` where ``bucket`` is the shape
        the entry was compiled for (pad inputs up to it) and ``exact``
        says whether it is the policy's own bucket for the shape.  Never
        compiles on this path unless *nothing* warm covers the shape
        (counted in ``compile_stalls``).
        """
        want = self.policy.bucket_for(batch, length)
        with self._lock:
            entry = self._entries.get(want)
            if entry is not None:
                self.bucket_hits += 1
                self._account(batch, length, want)
                return entry, want, True
            self.bucket_misses += 1
        self._schedule(want)
        with self._lock:
            fb = self._nearest_warm(want)
            if fb is not None:
                self.fallback_serves += 1
                self._account(batch, length, fb)
                return self._entries[fb], fb, False
        # Nothing warm covers the shape: the one stall path.
        if self._worker_mode == "sync":
            entry = self._compile(want, background=False)
        else:
            # The background worker may already be compiling `want`;
            # waiting on it would still stall the request path, so it
            # counts the same.  Compile our own copy only if needed.
            entry = self._compile(want, background=False) \
                if self._claim(want) else self._await(want)
        with self._lock:
            self.compile_stalls += 1
            self._account(batch, length, want)
        return entry, want, True

    def _claim(self, bucket: Bucket) -> bool:
        with self._lock:
            if bucket in self._entries:
                return False
            if bucket in self._inflight:
                return False
            self._inflight.add(bucket)
            return True

    def _await(self, bucket: Bucket, timeout: float = 600.0) -> Any:
        """The bucket is being built elsewhere (worker thread) or queued;
        in ``"manual"`` mode drain inline, otherwise poll for the swap."""
        if self._worker_mode == "manual":
            self.drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if bucket in self._entries:
                    return self._entries[bucket]
                if bucket not in self._inflight:
                    break                      # failed in the worker
            time.sleep(0.002)
        return self._compile(bucket, background=False)

    def _account(self, batch: int, length: Optional[int],
                 bucket: Bucket) -> None:
        real = batch * (length if length is not None else 1)
        full = bucket.batch * (bucket.length or 1)
        self._pad_elems += full - real
        self._total_elems += full

    # -- introspection -------------------------------------------------
    @staticmethod
    def _order(b: Bucket) -> Tuple[int, int]:
        return (b.batch, b.length or 0)

    def warm_buckets(self) -> Tuple[Bucket, ...]:
        """Buckets whose programs are compiled and resident, sorted."""
        with self._lock:
            return tuple(sorted(self._entries, key=self._order))

    @property
    def pad_waste_frac(self) -> float:
        """Fraction of served elements that were bucket padding."""
        with self._lock:
            if self._total_elems == 0:
                return 0.0
            return self._pad_elems / self._total_elems

    def reset_counters(self) -> None:
        """Zero the dispatch/compile counters (warm entries are kept).
        Benchmarks call this between a warm-up wave and the measured
        steady-state wave so ``stats()`` reflects only the latter."""
        with self._lock:
            self.bucket_hits = 0
            self.bucket_misses = 0
            self.background_compiles = 0
            self.compile_stalls = 0
            self.fallback_serves = 0
            self.compile_ms = 0.0
            self._pad_elems = 0
            self._total_elems = 0

    def stats(self) -> dict:
        """Serving counters: bucket hits/misses, stalls, background
        compiles, compile time, warm set, and padding waste."""
        with self._lock:
            total = self._total_elems
            return {
                "bucket_hits": self.bucket_hits,
                "bucket_misses": self.bucket_misses,
                "fallback_serves": self.fallback_serves,
                "background_compiles": self.background_compiles,
                "compile_stalls": self.compile_stalls,
                "compile_ms": round(self.compile_ms, 3),
                "warm_buckets": [str(b) for b in
                                 sorted(self._entries, key=self._order)],
                "pad_elems": self._pad_elems,
                "total_elems": total,
                "pad_waste_frac": (self._pad_elems / total) if total else 0.0,
            }
