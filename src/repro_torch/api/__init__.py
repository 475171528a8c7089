"""repro_torch.api — the single compilation funnel.

    import repro_torch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(target="cuda"))
    out = exe(input=x)
"""

from __future__ import annotations

from typing import Optional

from ..core.graph import Graph, Signature
from .executable import Executable
from .options import CompileOptions
from .targets import (available_targets, get_target, register_target,
                      GraphExecutable, InterpretExecutable, JitExecutable)


def compile(model: Graph, options: Optional[CompileOptions] = None,
            **kw) -> Executable:
    """Compile a graph IR (:class:`repro_torch.core.Graph`) for the
    target named in ``options.target``.  Keyword args override
    ``CompileOptions`` fields (``repro_torch.compile(g, target="interpret",
    device="cpu")``).  Other frontends (containers, tracing) are ROADMAP
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
    return get_target(options.target)(model, options)


__all__ = [
    "CompileOptions",
    "Executable",
    "GraphExecutable",
    "InterpretExecutable",
    "JitExecutable",
    "Signature",
    "available_targets",
    "compile",
    "get_target",
    "register_target",
]
