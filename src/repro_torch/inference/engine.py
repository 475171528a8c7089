"""Engine — DEPRECATED shim over ``repro_torch.serve``.

The port of ``repro.inference.engine``.  The slot-level
continuous-batching loop that lived here in the reference was extracted
into :mod:`repro_torch.serve` (``Scheduler`` + ``SlotManager`` +
per-request metrics).  The modern spelling::

    import repro_torch
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(target="engine"))
    sched = repro_torch.serve(exe, repro_torch.SchedulerOptions(slots=4))

This class keeps the legacy surface working: the constructor signature,
``submit`` / ``step`` / ``run``, and the ``cache`` / ``fold_report`` /
``done`` attributes, by delegating to a
:class:`repro_torch.serve.Scheduler` on the device the params are on.
A single ``DeprecationWarning`` is emitted per process.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List

from ..serve import Completion, Request, Scheduler, SchedulerOptions

__all__ = ["Engine", "Request", "Completion"]

_warned = False


def _warn_once() -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "inference.Engine is deprecated; use repro_torch.serve("
            "executable, repro_torch.SchedulerOptions(...)) instead",
            DeprecationWarning,
            stacklevel=3,
        )


class Engine:
    """Deprecated: serve a model via the legacy slot-loop surface."""

    def __init__(self, model, params, *, slots: int = 4,
                 max_len: int = 256, fold: bool = True,
                 seed: int = 0) -> None:
        _warn_once()
        self._sched = Scheduler(
            model, params,
            SchedulerOptions(slots=slots, max_len=max_len, fold=fold,
                             seed=seed))

    # -- legacy attribute surface --------------------------------------
    @property
    def scheduler(self) -> Scheduler:
        """The new-API scheduler this shim wraps."""
        return self._sched

    @property
    def cache(self) -> Any:
        return self._sched.slot_manager.cache

    @property
    def fold_report(self) -> Dict[str, Any]:
        return self._sched.fold_report

    @property
    def done(self) -> List[Completion]:
        return self._sched.done

    @property
    def generated(self) -> Dict[int, List[int]]:
        return self._sched.generated

    @property
    def params(self):
        return self._sched.params

    # -- legacy methods ------------------------------------------------
    def submit(self, req: Request) -> None:
        self._sched.submit(req)

    def step(self) -> int:
        return self._sched.step()

    def run(self, max_steps: int = 10_000) -> List[Completion]:
        return self._sched.run(max_steps)
