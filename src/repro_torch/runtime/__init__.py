"""repro_torch.runtime — shape-polymorphic dispatch over compiled executables.

The port of ``repro.runtime``:

* :class:`BucketPolicy` / :class:`Bucket` — deterministic shape→bucket
  rounding (powers-of-two batch buckets × configurable length buckets)
  with per-dispatch pad-waste accounting;
* :class:`EngineCache` — an in-process bucket → warm-program cache: cold
  buckets are captured on a background worker and swap in atomically
  while requests are served on the nearest warm larger bucket;
* :class:`BucketedExecutable` — what ``repro_torch.compile(graph,
  CompileOptions(buckets=policy))`` returns: one signature, one source
  graph, one captured program per batch bucket, dispatched by input
  shape and pre-warmed from the persistent executable cache.

The serving scheduler (:mod:`repro_torch.serve`) builds on the same
pieces: one captured decode step per batch bucket, and padded prefill
per length bucket (``SchedulerOptions(buckets=...)``).
"""

from .buckets import Bucket, BucketPolicy, powers_of_two
from .engine_cache import EngineCache, WORKER_MODES


def __getattr__(name):
    # Lazy: bucketed.py pulls in torch and repro_torch.api; CompileOptions
    # imports BucketPolicy from here, so the eager surface must stay
    # import-cycle-free.
    if name == "BucketedExecutable":
        from .bucketed import BucketedExecutable
        return BucketedExecutable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Bucket",
    "BucketPolicy",
    "BucketedExecutable",
    "EngineCache",
    "WORKER_MODES",
    "powers_of_two",
]
