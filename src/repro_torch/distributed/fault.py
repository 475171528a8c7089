"""Fault-tolerance runtime pieces: straggler watchdog + retry wrapper.

The port of ``repro.distributed.fault``.  Slow steps are caught by the
watchdog's deadline, hard failures by :func:`run_with_restarts`, which
rebuilds the whole stack.  Device loss is typed: a sharded executable
whose visible device set (the default process group's ranks) shrinks
below its :class:`~repro_torch.dist.mesh.MeshSpec` raises
:class:`MeshUnavailableError` naming the axes that can no longer be
filled; :func:`check_mesh` is the polling form the watchdogs compose
with.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..dist.mesh import (MeshSpec, MeshUnavailableError,
                         ensure_mesh_available)


def check_mesh(spec: MeshSpec,
               available: Optional[int] = None) -> Optional[dict]:
    """One mesh-availability poll: ``None`` when ``spec`` fits the
    visible devices (``available``, default the process group's), else
    a plain-dict fault record — the non-raising twin of
    :func:`~repro_torch.dist.mesh.ensure_mesh_available` for watchdog
    loops that log and keep running."""
    try:
        ensure_mesh_available(spec, available)
    except MeshUnavailableError as e:
        return {"mesh": e.spec.describe(), "needed": e.needed,
                "available": e.available,
                "missing_axes": list(e.missing_axes)}
    return None


class StragglerWatchdog:
    """Deadline monitor for steps.

    >>> wd = StragglerWatchdog(deadline_s=300, on_timeout=alarm)
    >>> with wd.step(i):           # calls back if exceeded
    ...     train_step(...)
    """

    def __init__(self, deadline_s: float,
                 on_timeout: Optional[Callable[[int, float], None]] = None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.timeouts: list = []
        self._timer: Optional[threading.Timer] = None

    class _StepCtx:
        def __init__(self, wd: "StragglerWatchdog", step: int):
            self.wd, self.step = wd, step
            self.t0 = 0.0

        def __enter__(self):
            self.t0 = time.monotonic()
            wd = self.wd

            def fire():
                elapsed = time.monotonic() - self.t0
                wd.timeouts.append((self.step, elapsed))
                if wd.on_timeout:
                    wd.on_timeout(self.step, elapsed)

            wd._timer = threading.Timer(wd.deadline_s, fire)
            wd._timer.daemon = True
            wd._timer.start()
            return self

        def __exit__(self, *exc):
            if self.wd._timer is not None:
                self.wd._timer.cancel()
                self.wd._timer = None
            return False

    def step(self, step_idx: int) -> "_StepCtx":
        return self._StepCtx(self, step_idx)


def run_with_restarts(make_step: Callable[[], Callable[[int], None]],
                      n_steps: int, max_restarts: int = 3,
                      start_step: Callable[[], int] = lambda: 0) -> int:
    """Drive ``step_fn(i)`` for i in [start, n_steps), restarting the
    whole stack (``make_step`` called again: a fresh compile, restored
    state) on a ``RuntimeError``.  Returns the number of restarts."""
    restarts = 0
    while True:
        step_fn = make_step()
        i = start_step()
        try:
            while i < n_steps:
                step_fn(i)
                i += 1
            return restarts
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
