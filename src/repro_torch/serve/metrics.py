"""Per-request and aggregate serving metrics.

The port's copy of ``repro.serve.metrics`` (pure Python, unchanged):
``summary()`` has the reference's keys.

Timestamps come from the scheduler's injected ``clock`` (default
``time.perf_counter``), so tests drive a fake clock and assert exact
TTFT / throughput numbers.  ``summary()`` reports tail percentiles
(p50/p99), not just means — means hide exactly the TTFT tail that
SLO-aware admission targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) of ``values`` with linear
    interpolation between order statistics — the same definition as
    ``numpy.percentile``'s default, kept dependency-free so metrics
    never import numpy.  Returns None on an empty list."""
    if not values:
        return None
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    return v[lo] + (v[hi] - v[lo]) * frac


@dataclasses.dataclass
class RequestMetrics:
    """Lifecycle timestamps and counters for one request."""

    uid: int
    prompt_tokens: int
    submitted_at: float
    queue_depth_at_submit: int
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    new_tokens: int = 0
    finish_reason: Optional[str] = None   # "eos" | "length" | None
    #: Absolute first-token deadline (``submitted_at + slo_ms/1e3`` on
    #: the scheduler clock); None = no SLO.
    deadline: Optional[float] = None
    #: Set at first-token time: True if the deadline was missed.
    #: None until the first token (or when there is no deadline).
    slo_violated: Optional[bool] = None

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (submit -> first sampled token)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def queue_time(self) -> Optional[float]:
        """Seconds spent waiting in the queue before admission."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def decode_tokens_per_s(self) -> Optional[float]:
        """Steady-state decode rate (excludes queueing and prefill)."""
        if self.finished_at is None or self.first_token_at is None:
            return None
        dt = self.finished_at - self.first_token_at
        if dt <= 0:
            return None
        # the first token comes from prefill; the rest are decode steps
        return (self.new_tokens - 1) / dt

    def to_dict(self) -> dict:
        """Plain-dict view including the derived ttft/queue_time."""
        d = dataclasses.asdict(self)
        d["ttft"] = self.ttft
        d["queue_time"] = self.queue_time
        d["decode_tokens_per_s"] = self.decode_tokens_per_s
        return d


@dataclasses.dataclass
class SchedulerMetrics:
    """Aggregate counters maintained by the scheduler step loop."""

    submitted: int = 0
    rejected: int = 0
    admitted: int = 0
    completed: int = 0
    decode_steps: int = 0
    decode_slot_steps: int = 0   # sum of active slots over decode steps
    peak_queue_depth: int = 0
    started_at: Optional[float] = None
    last_step_at: Optional[float] = None
    total_new_tokens: int = 0
    #: Requests whose first token landed after their deadline.
    slo_violations: int = 0
    #: Incremental prefill chunks executed (chunked prefill only).
    prefill_chunks: int = 0

    @property
    def mean_batch_occupancy(self) -> Optional[float]:
        """Average number of active slots per decode step — how well
        continuous batching keeps the fixed-shape decode program full."""
        if self.decode_steps == 0:
            return None
        return self.decode_slot_steps / self.decode_steps

    @property
    def tokens_per_s(self) -> Optional[float]:
        """Aggregate new-token throughput over the serving window."""
        if (self.started_at is None or self.last_step_at is None
                or self.last_step_at <= self.started_at):
            return None
        return self.total_new_tokens / (self.last_step_at - self.started_at)

    def summary(self, per_request: Dict[int, RequestMetrics]) -> dict:
        """Aggregate report: totals plus TTFT / queue-depth p50+p99."""
        ttfts = [m.ttft for m in per_request.values() if m.ttft is not None]
        depths = [float(m.queue_depth_at_submit)
                  for m in per_request.values()]
        return {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "admitted": self.admitted,
            "completed": self.completed,
            "decode_steps": self.decode_steps,
            "mean_batch_occupancy": self.mean_batch_occupancy,
            "peak_queue_depth": self.peak_queue_depth,
            "total_new_tokens": self.total_new_tokens,
            "tokens_per_s": self.tokens_per_s,
            "mean_ttft": (sum(ttfts) / len(ttfts)) if ttfts else None,
            "ttft_p50": percentile(ttfts, 50.0),
            "ttft_p99": percentile(ttfts, 99.0),
            "queue_depth_p50": percentile(depths, 50.0),
            "queue_depth_p99": percentile(depths, 99.0),
            "slo_violations": self.slo_violations,
            "prefill_chunks": self.prefill_chunks,
        }
