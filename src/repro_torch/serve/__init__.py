"""repro_torch.serve — continuous-batching serving over compiled executables.

The port of ``repro.serve``::

    import repro_torch
    from repro_torch.serve import Request

    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(target="engine"))
    sched = repro_torch.serve(exe, repro_torch.SchedulerOptions(slots=8))
    sched.submit(Request(uid=0, prompt=toks))
    completions = sched.run()
    print(sched.summary())

One scheduler (`Scheduler`), one options object (`SchedulerOptions`),
per-request metrics (`RequestMetrics`), a slot/KV-cache manager
(`SlotManager`) and the per-bucket decode step (`DecodeStep`, one
captured CUDA graph on the card).  The deprecated
``repro_torch.inference.Engine`` is a shim over this package.

The module itself is callable — ``repro_torch.serve(executable,
options)`` delegates to :func:`repro_torch.api.serve.serve` — so the
package namespace (``repro_torch.serve.Scheduler``) and the API entry
point share one name.
"""

import sys as _sys
import types as _types

from .metrics import RequestMetrics, SchedulerMetrics
from .options import ADMISSION_POLICIES, SchedulerOptions
from .prefix import PrefixCache
from .scheduler import (Completion, QueueFullError, Request, Scheduler,
                        TemperatureSampler)
from .slots import SlotManager, SlotState
from .step import DecodeStep

__all__ = [
    "ADMISSION_POLICIES",
    "Completion",
    "DecodeStep",
    "PrefixCache",
    "QueueFullError",
    "Request",
    "RequestMetrics",
    "Scheduler",
    "SchedulerMetrics",
    "SchedulerOptions",
    "SlotManager",
    "SlotState",
    "TemperatureSampler",
]


class _CallableServeModule(_types.ModuleType):
    def __call__(self, executable, options=None, **kw):
        from ..api.serve import serve as _serve   # lazy: avoids a cycle
        return _serve(executable, options, **kw)


_sys.modules[__name__].__class__ = _CallableServeModule
