"""``repro_torch.serve`` — the serving funnel over compiled executables.

The port of ``repro.api.serve``::

    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(target="engine"))
    sched = repro_torch.serve(exe, repro_torch.SchedulerOptions(slots=8))

Takes an executable produced by the ``"engine"`` target (or anything
exposing ``model`` + ``params``) and returns a
:class:`repro_torch.serve.Scheduler` on the executable's device — the
continuous-batching step loop, slot/KV-cache manager and per-request
metrics live in :mod:`repro_torch.serve`; this module is only the API
seam that pairs the compiled artifact with a scheduling policy.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..serve.options import SchedulerOptions
from ..serve.scheduler import Scheduler

_SERVE_HINT = (
    "repro_torch.serve() drives framework-scale executables: compile with "
    "CompileOptions(target='engine') first (graph-IR executables are "
    "single-shot programs with no KV cache to schedule over)"
)


def _precision_report(executable) -> Optional[dict]:
    """Audit record for ``Scheduler.summary()["precision"]``: the
    compiled precision, the calibration setting, and — when the
    executable reports one (``ModelExecutable.quant_report`` under
    ``precision="bf16"``) — the per-leaf f32/bf16 decision counts."""
    opts = getattr(executable, "options", None)
    prec = getattr(opts, "precision", None)
    if prec is None:
        return None
    info = {"precision": prec}
    if getattr(opts, "calibrate", None) is not None:
        info["calibrate"] = opts.calibrate
    try:
        quant = executable.cost_summary().get("quant")
    except Exception:
        quant = None
    if quant and quant.get("decisions"):
        info["decisions"] = dict(quant["decisions"])
    return info


def serve(executable, options: Optional[SchedulerOptions] = None, *,
          sampler: Optional[Callable] = None,
          clock: Optional[Callable[[], float]] = None,
          engine_worker: Optional[str] = None,
          device_source: Optional[Callable] = None,
          **kw) -> Scheduler:
    """Build a continuous-batching :class:`Scheduler` over ``executable``.

    ``executable`` must expose ``model`` (a ``repro_torch.models.Model``)
    and ``params`` — i.e. come from ``repro_torch.compile(cfg,
    CompileOptions(target="engine"))``; the scheduler serves on the
    device its params are on.  Remaining keyword args override
    ``SchedulerOptions`` fields (``repro_torch.serve(exe, slots=8)``);
    ``sampler`` and ``clock`` are injection points for tests
    (deterministic token streams, fake time); ``device_source`` is the
    mesh fault-injection seam (the visible devices).

    When the executable was compiled with ``CompileOptions(mesh=...)``
    and the scheduler options leave ``mesh`` unset, the compile-time
    mesh carries over: the serving placement follows the compiled
    artifact unless explicitly overridden.
    """
    model = getattr(executable, "model", None)
    params = getattr(executable, "params", None)
    if model is None or params is None or not hasattr(model, "decode_step"):
        raise TypeError(
            f"cannot serve {type(executable).__name__}: {_SERVE_HINT}")
    if options is None:
        options = SchedulerOptions()
    if kw:
        options = options.replace(**kw)
    if options.mesh is None:
        compiled_mesh = getattr(getattr(executable, "options", None),
                                "mesh", None)
        if compiled_mesh is not None:
            options = options.replace(mesh=compiled_mesh)
    extra = {}
    if clock is not None:
        extra["clock"] = clock
    if engine_worker is not None:
        extra["engine_worker"] = engine_worker
    if device_source is not None:
        extra["device_source"] = device_source
    info = _precision_report(executable)
    if info is not None:
        extra["precision_info"] = info
    return Scheduler(model, params, options, sampler=sampler, **extra)
