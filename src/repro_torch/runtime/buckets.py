"""Shape buckets — the policy half of shape-polymorphic serving.

The port's copy of ``repro.runtime.buckets`` (pure Python, unchanged).

The paper's thesis is specializing compiled code to statically known
properties; the price is one program per shape.  A :class:`BucketPolicy`
bounds that price: live shapes are rounded up to a small, deterministic
set of *buckets* (powers-of-two batch sizes × configurable sequence
lengths), so the number of programs is fixed up front while any shape
inside the covered range still runs on specialized code — padded to the
bucket, with the waste accounted per dispatch.

The policy is pure arithmetic: no torch, no threads, no caches.  The
runtime half (which bucket is *warm*, what compiles in the background)
lives in :mod:`repro_torch.runtime.engine_cache`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple


class Bucket(NamedTuple):
    """One specialization point: a batch size and an optional sequence
    length (``length=None`` for batch-only bucketing, e.g. fixed-shape
    graph executables or single-token decode)."""

    batch: int
    length: Optional[int] = None

    def __str__(self) -> str:
        if self.length is None:
            return f"b{self.batch}"
        return f"b{self.batch}xl{self.length}"


def _ascending(values: Sequence[int], what: str) -> Tuple[int, ...]:
    out = tuple(sorted({int(v) for v in values}))
    if any(v <= 0 for v in out):
        raise ValueError(f"{what} must be positive: {tuple(values)}")
    return out


def powers_of_two(lo: int, hi: int) -> Tuple[int, ...]:
    """Powers of two in ``[lo, hi]``, always including ``hi`` itself so
    the largest bucket covers the full range even when ``hi`` is not a
    power of two."""
    if hi < lo:
        raise ValueError(f"empty bucket range [{lo}, {hi}]")
    out = []
    v = 1
    while v < lo:
        v *= 2
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Deterministic shape→bucket rounding.

    batch_buckets: ascending batch sizes to specialize for.
    len_buckets:   ascending sequence lengths; empty = batch-only
                   bucketing (``bucket_for`` returns ``length=None``
                   buckets and ignores any length argument).

    A shape maps to the smallest bucket ≥ it in every dimension.  A
    shape *above* the largest bucket gets an exact (unbucketed) bucket
    of its own shape — deterministic, never an error, but each distinct
    overflow shape is its own specialization (the pre-bucketing
    behavior), so size the largest bucket to the traffic you expect.
    """

    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    len_buckets: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "batch_buckets",
                           _ascending(self.batch_buckets, "batch_buckets"))
        object.__setattr__(self, "len_buckets",
                           _ascending(self.len_buckets, "len_buckets"))
        if not self.batch_buckets:
            raise ValueError("batch_buckets must not be empty")

    # ------------------------------------------------------------------
    @classmethod
    def default(cls, max_batch: int, max_len: Optional[int] = None,
                min_len: int = 16) -> "BucketPolicy":
        """Powers-of-two batch buckets up to ``max_batch``; length
        buckets doubling from ``min_len`` up to ``max_len`` (omitted =
        batch-only)."""
        lens: Tuple[int, ...] = ()
        if max_len is not None:
            lens = powers_of_two(min(min_len, max_len), max_len)
        return cls(batch_buckets=powers_of_two(1, max_batch),
                   len_buckets=lens)

    # ------------------------------------------------------------------
    def bucket_for(self, batch: int, length: Optional[int] = None) -> Bucket:
        """Smallest bucket ≥ ``(batch, length)`` in every dimension."""
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        b = next((c for c in self.batch_buckets if c >= batch), batch)
        if not self.len_buckets or length is None:
            return Bucket(b, None)
        if length <= 0:
            raise ValueError(f"length must be positive, got {length}")
        l = next((c for c in self.len_buckets if c >= length), length)
        return Bucket(b, l)

    def enumerate_buckets(self) -> Tuple[Bucket, ...]:
        """Every bucket the policy can round to, deterministically
        ordered (batch-major ascending) — the warm-up worklist."""
        if not self.len_buckets:
            return tuple(Bucket(b, None) for b in self.batch_buckets)
        return tuple(Bucket(b, l)
                     for b in self.batch_buckets
                     for l in self.len_buckets)

    def covers(self, bucket: Bucket) -> bool:
        """True if ``bucket`` is one of the policy's own buckets (not an
        overflow shape)."""
        return bucket in self.enumerate_buckets()

    # ------------------------------------------------------------------
    @staticmethod
    def pad_waste(batch: int, length: Optional[int], bucket: Bucket) -> float:
        """Fraction of the bucket's elements that are padding for a
        ``(batch, length)`` dispatch: ``1 - real/bucket``."""
        real = batch * (length if length is not None else 1)
        full = bucket.batch * (bucket.length if bucket.length is not None
                               else 1)
        if full <= 0:
            return 0.0
        return max(0.0, 1.0 - real / full)

    # ------------------------------------------------------------------
    def clip(self, max_batch: Optional[int] = None,
             max_len: Optional[int] = None) -> "BucketPolicy":
        """Derive a policy whose buckets never exceed the given caps —
        the cap itself becomes the largest bucket (a serving scheduler
        clips to its slot count and cache capacity)."""
        bb = self.batch_buckets
        if max_batch is not None:
            bb = tuple(b for b in bb if b < max_batch) + (max_batch,)
        lb = self.len_buckets
        if lb and max_len is not None:
            lb = tuple(l for l in lb if l < max_len) + (max_len,)
        return BucketPolicy(batch_buckets=bb, len_buckets=lb)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-friendly form; invert with ``from_dict``."""
        return {"batch_buckets": list(self.batch_buckets),
                "len_buckets": list(self.len_buckets)}

    @classmethod
    def from_dict(cls, d: dict) -> "BucketPolicy":
        """Rebuild a policy from ``to_dict`` output."""
        return cls(batch_buckets=tuple(d.get("batch_buckets") or ()),
                   len_buckets=tuple(d.get("len_buckets") or ()))
