"""The benchmark's own arithmetic on what a window recorded."""

from __future__ import annotations

from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) of ``values``, interpolated
    linearly between order statistics (``numpy.percentile``'s default);
    None for no values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> Optional[float]:
    """All the work of a window over all of its time; None for an empty
    window or no work."""
    if seconds <= 0 or count <= 0:
        return None
    return count / seconds


def merge(intervals: Sequence[tuple]) -> List[tuple]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]
