"""repro_torch.api — the single compilation funnel.

    import repro_torch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(target="cuda"))
    out = exe(input=x)

One entry point (`compile`), one options object (`CompileOptions`), one
result protocol (`Executable`), a named-target registry, the frontend
registry and a persistent on-disk executable cache.  The legacy
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

#: Keyword args routed to the frontend registry, not CompileOptions.
_FRONTEND_KW = ("frontend", "specs", "example_inputs", "input_names",
                "outputs")


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
    :class:`~repro_torch.runtime.BucketedExecutable`.  An LLM config or
    model (the reference's ``engine`` target) raises: that is ROADMAP
    A.12.  A graph of the JAX package goes through
    :func:`repro_torch.weights.from_reference` first.
    """
    frontend_kw = {k: kw.pop(k) for k in _FRONTEND_KW if k in kw}
    if options is None:
        options = CompileOptions()
    if kw:
        options = options.replace(**kw)

    if not isinstance(model, Graph):
        is_cfg = hasattr(model, "family") and hasattr(model, "name")
        is_model = hasattr(model, "cfg") and hasattr(model, "forward")
        if is_cfg or is_model:
            raise NotImplementedError(
                f"{type(model).__name__} looks like an LLM config or model; "
                f"the engine target is not ported yet (ROADMAP A.12: LLM "
                f"models and the engine target)")
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
