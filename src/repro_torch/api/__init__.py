"""repro_torch.api — the single compilation funnel.

    import repro_torch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(target="cuda"))
    out = exe(input=x)

One entry point (`compile`), one options object (`CompileOptions`), one
result protocol (`Executable`), a named-target registry, the frontend
registry and a persistent on-disk executable cache.  The ``"engine"``
target compiles the LLM configs (:mod:`.engine_adapter`).  The legacy
``CompiledModel`` (``repro_torch.core``) is a deprecated shim over this
package.
"""

from __future__ import annotations

from typing import Optional

from .. import frontends
from ..core.graph import Graph, Signature
from ..frontends import available_frontends, get_frontend, register_frontend
from ..frontends.trace import trace
from ..runtime.buckets import Bucket, BucketPolicy
from .cache import ExecutableCache, prune, resolve_cache_dir
from .executable import Executable, deserialize
from .options import CompileOptions
from .targets import (available_targets, get_target, register_target,
                      GraphExecutable, InterpretExecutable, JitExecutable)

_GRAPH_TARGET_HINT = (
    "graph-IR targets take a repro_torch.core.Graph; pass "
    "CompileOptions(target='engine') to compile a framework-scale "
    "ArchConfig/Model"
)

#: Keyword args routed to the frontend registry, not CompileOptions.
_FRONTEND_KW = ("frontend", "specs", "example_inputs", "input_names",
                "outputs")


@register_target("engine")
def _build_engine(model_or_cfg, options: CompileOptions, **kw):
    from .engine_adapter import ModelExecutable  # lazy: pulls the model zoo
    return ModelExecutable(model_or_cfg, options, **kw)


def compile(model, options: Optional[CompileOptions] = None,
            **kw) -> Executable:
    """Compile ``model`` into an :class:`Executable`.

    ``model`` is a graph IR (:class:`repro_torch.core.Graph`) — routed to
    the target named in ``options.target`` — or anything a registered
    frontend can normalize into a Graph: a ``ModelBuilder``, an ``.npz``
    container path, or a bare callable (traced; pass ``example_inputs=``
    — numpy arrays or torch tensors with a batch dim — or ``specs=``;
    ``frontend=`` forces a specific frontend).  Remaining keyword args
    override ``CompileOptions`` fields (``repro_torch.compile(g,
    target="interpret", device="cpu")``).  With ``buckets=`` a
    ``jit``/``cuda`` compile is wrapped in a
    :class:`~repro_torch.runtime.BucketedExecutable`.  A framework-scale
    ``ArchConfig``/``repro_torch.models.Model`` compiles with
    ``target="engine"`` only (``params=`` / ``init_seed=`` go to the
    engine adapter).  A graph of the JAX package goes through
    :func:`repro_torch.weights.from_reference` first.
    """
    factory_kw = {k: kw.pop(k) for k in ("params", "init_seed") if k in kw}
    frontend_kw = {k: kw.pop(k) for k in _FRONTEND_KW if k in kw}
    if options is None:
        options = CompileOptions()
    if kw:
        options = options.replace(**kw)

    if not isinstance(model, Graph):
        is_cfg = hasattr(model, "family") and hasattr(model, "name")
        is_model = hasattr(model, "cfg") and hasattr(model, "forward")
        if is_cfg or is_model:
            if frontend_kw:
                raise TypeError(f"unexpected args for the engine target: "
                                f"{sorted(frontend_kw)}")
            if options.target != "engine":
                raise TypeError(
                    f"target {options.target!r}: {_GRAPH_TARGET_HINT}")
            return get_target("engine")(model, options, **factory_kw)
        if hasattr(model, "structure_hash") and hasattr(model, "nodes"):
            raise TypeError(
                f"repro_torch.compile takes a repro_torch.core.Graph, got "
                f"{type(model).__module__}.{type(model).__name__}; convert "
                f"a reference graph with repro_torch.weights.from_reference")
        # Everything else goes through the frontend registry (raises a
        # TypeError naming the registered frontends if nothing accepts).
        model = frontends.resolve(model, **frontend_kw)
    elif frontend_kw:
        raise TypeError(f"unexpected args for graph models: "
                        f"{sorted(frontend_kw)}")

    if options.target == "engine":
        raise TypeError("target='engine' compiles ArchConfig/Model, "
                        "not a graph IR; use 'jit'/'cuda'/'interpret'")
    if factory_kw:
        raise TypeError(f"unexpected args for graph targets: "
                        f"{sorted(factory_kw)}")
    exe = get_target(options.target)(model, options)
    if options.buckets is not None:
        # Shape-polymorphic dispatch: one warm program per batch bucket,
        # cold buckets captured in the background (repro_torch.runtime).
        if not isinstance(exe, JitExecutable):
            raise TypeError(
                f"buckets= requires a per-batch-compiling target "
                f"('jit'/'cuda'), not {options.target!r}")
        from ..runtime.bucketed import BucketedExecutable
        exe = BucketedExecutable(exe, options.buckets)
    return exe


__all__ = [
    "Bucket",
    "BucketPolicy",
    "CompileOptions",
    "Executable",
    "ExecutableCache",
    "GraphExecutable",
    "InterpretExecutable",
    "JitExecutable",
    "Signature",
    "available_frontends",
    "available_targets",
    "compile",
    "deserialize",
    "get_frontend",
    "get_target",
    "prune",
    "register_frontend",
    "register_target",
    "resolve_cache_dir",
    "trace",
]
