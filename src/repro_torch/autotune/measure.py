"""Micro-benchmark primitive for the autotuner.

The reference's estimator, the **minimum** over reps, which shrugs off
the scheduler hiccups that dominate sub-millisecond means on a shared
machine.  What it times differs by device:

* On a CUDA tensor it times the **device**, never the host: the
  candidate's calls are captured into one small CUDA graph
  (``core/program.py::capture``), and each rep is CUDA-event time around
  one replay, divided by the calls in it.  A replay launches the kernels
  back to back, so the host's ~20-60 µs a Python call costs drops out;
  an eager inference is mostly host time at batch 1, and host time would
  measure the walk, not the tactic.
* On the CPU it is host wall time of the plain forms, so that the
  tuner's tests run anywhere.

Builds, warm-ups and captures count against the tuning deadline, so
``autotune_budget_ms`` bounds real wall-clock.  A candidate that fails
to build, to capture or to launch is not viable: the functions return
None and the tuner records it so; it never turns into a plain version.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

#: Calls of the candidate captured into the graph one rep replays.
CALLS_PER_GRAPH = 10


def now_ms() -> float:
    """Monotonic wall clock in milliseconds."""
    return time.perf_counter() * 1e3


class Deadline:
    """Wall-clock budget shared by every candidate of a tuning pass;
    ``None`` budget = unlimited."""

    def __init__(self, budget_ms: Optional[float]) -> None:
        self.start_ms = now_ms()
        self.budget_ms = budget_ms

    def spent_ms(self) -> float:
        """Milliseconds elapsed since the deadline was created."""
        return now_ms() - self.start_ms

    def expired(self) -> bool:
        """True once the budget is spent (never with a None budget)."""
        return (self.budget_ms is not None
                and self.spent_ms() >= self.budget_ms)


def _device_of(args: Sequence) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def replay_min_us(graph: "torch.cuda.CUDAGraph", device: torch.device, *,
                  reps: int = 5, calls: int = 1,
                  deadline: Optional[Deadline] = None) -> float:
    """Min over ``reps`` of the device µs of one replay of ``graph``
    (CUDA events around it, on the current stream), divided by the
    ``calls`` captured in it.  Waits on its own events only: a
    device-wide synchronise could fail a capture on another thread."""
    stream = torch.cuda.current_stream(device)
    best = None
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        graph.replay()
        end.record(stream)
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / calls
        best = us if best is None else min(best, us)
        if deadline is not None and deadline.expired():
            break
    return best


def bench_min_us(fn: Callable, args: Sequence, *, reps: int = 5,
                 warmup: int = 1,
                 deadline: Optional[Deadline] = None) -> Optional[float]:
    """Min-of-reps µs of one ``fn(*args)``: device time on a CUDA tensor
    (a captured graph of CALLS_PER_GRAPH calls, replayed), host wall
    time on the CPU.  None if the candidate fails to run or the deadline
    expires before a timed rep: the caller treats None as "not a viable
    tactic"."""
    device = _device_of(args)
    try:
        with torch.inference_mode():
            if device.type == "cuda":
                from ..core.program import GraphPool, capture
                graph, _, _ = capture(
                    lambda: [fn(*args) for _ in range(CALLS_PER_GRAPH)],
                    device, GraphPool(device))
                if deadline is not None and deadline.expired():
                    return None
                return replay_min_us(graph, device, reps=reps,
                                     calls=CALLS_PER_GRAPH,
                                     deadline=deadline)
            for _ in range(max(1, warmup)):
                fn(*args)
                if deadline is not None and deadline.expired():
                    return None
            best = None
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                fn(*args)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                if deadline is not None and deadline.expired():
                    break
            return best * 1e6
    except Exception:
        return None
