"""CompiledModel — DEPRECATED shim over ``repro_torch.compile``.

The port of ``repro.core.compiler``.  The paper's ``CompiledNN::compile``
entry point lives behind the unified API::

    import repro_torch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(
        target="cuda", precision="exact"))

This class keeps the reference's legacy call sites working: it forwards
every constructor kwarg into ``CompileOptions``, delegates to the
``"jit"``/``"cuda"`` targets (``use_pallas=True``, the reference's
spelling of its kernel target, means ``"cuda"``), and re-exposes the old
attributes (``graph``, ``report``, ``compile_time``).  ``device`` is the
port's own, ``"cuda"`` by default as everywhere.  A single
``DeprecationWarning`` is emitted per process.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from .graph import Graph

_warned = False


def _warn_once() -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "CompiledModel is deprecated; use repro_torch.compile(graph, "
            "repro_torch.CompileOptions(...)) instead",
            DeprecationWarning,
            stacklevel=3,
        )


class CompiledModel:
    """Deprecated: compile a graph IR model via the legacy surface."""

    def __init__(
        self,
        graph: Graph,
        *,
        embed_weights: bool = True,
        precision: str = "exact",
        use_pallas: bool = False,
        passes: Optional[Tuple[str, ...]] = None,
        device: str = "cuda",
    ) -> None:
        _warn_once()
        from ..api import CompileOptions, compile as api_compile

        self.source = graph
        self.embed_weights = embed_weights
        self.precision = precision
        self.use_pallas = use_pallas
        self._exe = api_compile(
            graph,
            CompileOptions(
                target="cuda" if use_pallas else "jit",
                precision=precision,
                embed_weights=embed_weights,
                passes=passes,
                device=device,
            ),
        )

    # -- legacy attribute surface --------------------------------------
    @property
    def graph(self) -> Graph:
        return self._exe.graph

    @property
    def report(self) -> Dict:
        return self._exe.report

    @property
    def compile_time(self) -> Optional[float]:
        return self._exe.compile_time

    @property
    def executable(self):
        """The new-API executable this shim wraps."""
        return self._exe

    # -- legacy methods ------------------------------------------------
    def compile(self, batch_size: int = 1):
        """Prepare (on a CUDA device, capture) the program for a batch
        size; kept thereafter."""
        return self._exe.ensure_compiled(batch_size)

    def apply(self, **inputs) -> Dict[str, torch.Tensor]:
        return self._exe(**inputs)
