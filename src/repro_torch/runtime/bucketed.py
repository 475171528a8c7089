"""BucketedExecutable — shape-polymorphic dispatch over one compiled model.

The port of ``repro.runtime.bucketed``.  ``repro_torch.compile(graph,
CompileOptions(target="cuda", buckets=policy))`` returns one of these
instead of a bare :class:`~repro_torch.api.targets.JitExecutable`: a
single signature and source graph, but one program per batch bucket (on
a CUDA device a captured CUDA graph), dispatched by the input's batch
dimension at call time.  A call whose batch is not a bucket fills the
first rows of the bucket program's static inputs, zeroes the rest and
keeps the first rows of the outputs — bit-equal to calling the bucket's
program on the input padded with zero rows.

Capture never blocks a dispatch that a warm bucket can cover: cold
buckets are captured on the :class:`~repro_torch.runtime.engine_cache.
EngineCache` background worker while the call is served on the nearest
warm larger bucket.  At construction every bucket whose program entry
is already in the persistent executable cache is captured at once (the
pass pipeline's output came from the cache too), so a second process
starts with the first process's buckets warm.

Serialization is a manifest: the source graph plus the per-bucket
executable-cache keys, and ``repro_torch.deserialize`` re-wraps with the
same policy.
"""

from __future__ import annotations

import io
import json

from ..api.executable import Executable, pack
from .buckets import BucketPolicy
from .engine_cache import EngineCache


class BucketedExecutable(Executable):
    """Dispatch-by-shape wrapper over a :class:`JitExecutable`."""

    def __init__(self, inner, policy: BucketPolicy, *,
                 worker: str = "thread", prewarm: bool = True) -> None:
        if policy.len_buckets:
            raise ValueError(
                "graph executables have fixed per-example shapes; "
                "BucketPolicy.len_buckets applies to serving "
                "(repro_torch.serve, SchedulerOptions(buckets=...)), not "
                "CompileOptions")
        self.inner = inner
        self.policy = policy
        self.options = inner.options
        self.signature = inner.signature
        self.source = inner.source
        self._cache = EngineCache(
            policy, build=lambda b: inner.ensure_compiled(b.batch),
            worker=worker)
        if prewarm:
            self.prewarm_from_disk()

    # ------------------------------------------------------------------
    @property
    def compile_time(self):
        """Inner executable's accumulated compile time (read-through)."""
        return self.inner.compile_time

    @compile_time.setter
    def compile_time(self, value):
        """No-op: the Executable base class assigns this attribute, but
        the inner executable owns the real counter."""

    def prewarm_from_disk(self) -> int:
        """Capture every bucket whose program entry is already in the
        persistent executable cache — a capture, no pass or selection,
        cheap enough to do at construction.  Returns the number of
        buckets warmed."""
        n = 0
        for bucket in self.policy.enumerate_buckets():
            if self.inner.has_disk_entry(bucket.batch):
                self._cache.warm_up([bucket], block=True)
                n += 1
        return n

    def warm_up(self, *, block: bool = False) -> None:
        """Prepare every bucket (background by default)."""
        self._cache.warm_up(block=block)

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until background warm-up finishes; False on timeout."""
        return self._cache.wait_warm(timeout)

    def ensure_compiled(self, batch_size: int = 1):
        """Blocking preparation of the bucket covering ``batch_size``;
        returns the bucket's program (inputs are padded to the bucket
        batch by ``__call__``)."""
        bucket = self.policy.bucket_for(batch_size)
        self._cache.warm_up([bucket], block=True)
        return self._cache.peek(bucket)

    # ------------------------------------------------------------------
    def __call__(self, *pos, **inputs):
        args = self.inner._gather_inputs(pos, inputs)
        prog, bucket, _ = self._cache.get(args[0].shape[0])
        out = self.inner._run(prog, args, bucket.batch)
        return {pub: out[opt] for pub, opt in
                zip(self.inner.source.output_names,
                    self.inner.graph.outputs)}

    # ------------------------------------------------------------------
    def cost_summary(self):
        """Inner compile facts plus a ``runtime`` section (bucket policy
        + engine-cache counters)."""
        out = self.inner.cost_summary()
        out["runtime"] = {"policy": self.policy.to_dict(),
                          **self._cache.stats()}
        return out

    def cache_info(self) -> dict:
        """Disk-cache counters of the wrapped executable."""
        return self.inner.cache_info()

    def runtime_stats(self) -> dict:
        """Engine-cache counters: hits, misses, stalls, pad waste."""
        return self._cache.stats()

    def serialize(self) -> bytes:
        """Manifest container: the graph body plus per-bucket program
        keys into the persistent executable cache."""
        from ..frontends.container import save_model
        buf = io.BytesIO()
        save_model(self.inner.source, buf)
        artifacts = {str(b): self.inner.disk_key(b.batch)
                     for b in self.policy.enumerate_buckets()}
        return pack("bucketed", self.options, buf.getvalue(),
                    extra={"signature": self.signature.to_dict(),
                           "policy": self.policy.to_dict(),
                           "artifacts": artifacts})

    def shutdown(self) -> None:
        """Stop the background warm-up worker (idempotent)."""
        self._cache.shutdown()

    def __repr__(self) -> str:
        warm = ", ".join(str(b) for b in self._cache.warm_buckets())
        return (f"BucketedExecutable(target={self.options.target!r}, "
                f"buckets={json.dumps(self.policy.to_dict())}, "
                f"warm=[{warm}])")
