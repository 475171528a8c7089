"""SchedulerOptions — the one options surface for ``repro_torch.serve``.

The port of ``repro.serve.options``: the same fields, validation and
``to_dict``.  The serving twin of ``CompileOptions``: a frozen,
hashable dataclass holding every scheduling choice, so a serving
configuration can be logged, compared and embedded in benchmark
artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..dist.mesh import MeshSpec
from ..runtime.buckets import BucketPolicy

ADMISSION_POLICIES = ("fcfs", "shortest", "deadline")


@dataclasses.dataclass(frozen=True)
class SchedulerOptions:
    """Every serving-time choice, in one place.

    slots:        number of concurrent decode slots (the fixed batch the
                  decode step is captured for; continuous batching
                  rebatches at slot granularity every step).
    max_len:      KV-cache capacity per slot.  A request whose prompt
                  alone exceeds it is rejected at submit; ``max_new_tokens``
                  is clamped so the cache can never overflow.
    admission:    queue discipline used when a slot frees up —
                  ``"fcfs"`` (arrival order), ``"shortest"`` (shortest
                  prompt first) or ``"deadline"`` (earliest-deadline-first
                  over each request's ``slo_ms``; requests without an SLO
                  sort after every deadline, FCFS among themselves).
    max_queue:    admission control: ``submit`` raises
                  :class:`QueueFullError` once this many requests are
                  waiting.  ``None`` = unbounded.
    fold:         run ``fold_norms`` on the params at scheduler build
                  (compile-time weight rewriting, paper §3.5).
    seed:         seed of the default temperature sampler's
                  ``torch.Generator``.
    buckets:      a :class:`repro_torch.runtime.BucketPolicy` enabling
                  shape-polymorphic serving: each step decodes at the
                  smallest warm batch bucket covering the active slots
                  (over the first rows of the cache, in place) and
                  prefill runs one padded program per length bucket;
                  cold decode buckets are captured on a background
                  worker.  Buckets are clipped to ``slots``/``max_len``.
                  ``None`` (default) = fixed-shape serving.
    prefill_chunk: chunk size (tokens) for incremental prefill, one chunk
                  per scheduler step, interleaved with decode steps.
                  Must divide ``max_len``.  ``None`` (default) =
                  whole-prompt prefill at admission.  Switched off
                  (surfaced in ``summary()["chunked_prefill"]``) for
                  families without incremental prefill: MLA latent
                  caches, vlm/audio extra inputs, ring and state caches.
    prefix_cache: capacity (entries) of the shared-prompt-head KV cache
                  (copy-on-write snapshots at chunk boundaries).
                  Requires ``prefill_chunk``.  ``0`` (default) = off.
    min_prefix:   minimum shared-head length (tokens) worth caching;
                  the effective floor is ``max(min_prefix,
                  prefill_chunk)``.
    mesh:         a :class:`repro_torch.dist.MeshSpec` (or any spelling
                  ``MeshSpec.coerce`` accepts, e.g. ``"data=2,model=2"``)
                  for data×model-parallel serving: one process a device
                  in a ``torch.distributed`` group of the mesh's size,
                  every rank running the same scheduler on the same
                  requests.  Params stay whole on every rank; each rank
                  stores its part of the batched cache (slots over the
                  ``batch`` rule's axes, the KV sequence over
                  ``kv_seq``'s); tokens equal single-device serving's.
                  ``None`` (default) = one device.
    """

    slots: int = 4
    max_len: int = 256
    admission: str = "fcfs"
    max_queue: Optional[int] = None
    fold: bool = True
    seed: int = 0
    buckets: Optional[BucketPolicy] = None
    prefill_chunk: Optional[int] = None
    prefix_cache: int = 0
    min_prefix: int = 0
    mesh: Optional[MeshSpec] = None

    def __post_init__(self) -> None:
        if self.slots <= 0:
            raise ValueError(f"slots must be positive, got {self.slots}")
        if self.max_len <= 1:
            raise ValueError(f"max_len must be > 1, got {self.max_len}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {self.admission!r}")
        if self.max_queue is not None and self.max_queue <= 0:
            raise ValueError(f"max_queue must be positive or None, "
                             f"got {self.max_queue}")
        if isinstance(self.buckets, dict):      # to_dict round-trip
            object.__setattr__(self, "buckets",
                               BucketPolicy.from_dict(self.buckets))
        if self.buckets is not None and not isinstance(self.buckets,
                                                       BucketPolicy):
            raise ValueError(
                f"buckets must be a repro_torch.runtime.BucketPolicy or "
                f"None, got {type(self.buckets).__name__}")
        if self.prefill_chunk is not None:
            if self.prefill_chunk <= 0:
                raise ValueError(f"prefill_chunk must be positive or "
                                 f"None, got {self.prefill_chunk}")
            if self.max_len % self.prefill_chunk != 0:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must divide "
                    f"max_len ({self.max_len})")
        if self.prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0, "
                             f"got {self.prefix_cache}")
        if self.prefix_cache > 0 and self.prefill_chunk is None:
            raise ValueError(
                "prefix_cache requires prefill_chunk: shared heads are "
                "snapshotted at chunk boundaries and tails are "
                "prefilled incrementally")
        if self.min_prefix < 0:
            raise ValueError(f"min_prefix must be >= 0, "
                             f"got {self.min_prefix}")
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            object.__setattr__(self, "mesh", MeshSpec.coerce(self.mesh))

    def replace(self, **kw) -> "SchedulerOptions":
        """Copy with the given fields replaced (re-validates)."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """Plain-dict view of every option field."""
        return dataclasses.asdict(self)
