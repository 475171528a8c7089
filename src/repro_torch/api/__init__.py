"""repro_torch.api — the single compilation funnel.

    import repro_torch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(target="cuda"))
    out = exe(input=x)
"""

from __future__ import annotations

from typing import Optional

from ..core.graph import Graph, Signature
from ..runtime.buckets import Bucket, BucketPolicy
from .cache import ExecutableCache, prune
from .executable import Executable, deserialize
from .options import CompileOptions
from .targets import (available_targets, get_target, register_target,
                      GraphExecutable, InterpretExecutable, JitExecutable)


def compile(model: Graph, options: Optional[CompileOptions] = None,
            **kw) -> Executable:
    """Compile a graph IR (:class:`repro_torch.core.Graph`) for the
    target named in ``options.target``.  Keyword args override
    ``CompileOptions`` fields (``repro_torch.compile(g, target="interpret",
    device="cpu")``).  With ``buckets=`` a ``jit``/``cuda`` compile is
    wrapped in a :class:`~repro_torch.runtime.BucketedExecutable`.  Other frontends (containers, tracing) are ROADMAP
    A.9; a graph of the JAX package goes through
    :func:`repro_torch.weights.from_reference` first."""
    if options is None:
        options = CompileOptions()
    if kw:
        options = options.replace(**kw)
    if not isinstance(model, Graph):
        raise TypeError(
            f"repro_torch.compile takes a repro_torch.core.Graph, got "
            f"{type(model).__module__}.{type(model).__name__}; convert a "
            f"reference graph with repro_torch.weights.from_reference")
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
    "available_targets",
    "compile",
    "deserialize",
    "get_target",
    "prune",
    "register_target",
]
