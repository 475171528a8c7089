"""The Executable protocol — what ``repro_torch.compile`` returns.

    exe(**inputs)        -> dict of named output tensors
    exe.compile_time     -> seconds spent compiling
    exe.cost_summary()   -> static cost/report dict

Serialization (``serialize``/``deserialize``) is ROADMAP A.7.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

from ..core.graph import Signature
from .options import CompileOptions


class Executable(abc.ABC):
    """Abstract base for all compiled artifacts."""

    options: CompileOptions
    compile_time: Optional[float]
    #: The model's public I/O contract: ordered, named inputs and
    #: outputs.  ``__call__`` binds arguments against it (positional or
    #: keyword) and keys the output dict by its output names.
    signature: Optional[Signature] = None

    @abc.abstractmethod
    def __call__(self, *args, **inputs) -> Dict[str, Any]:
        """Run inference; inputs bind positionally (signature order) or
        by keyword; returns a dict keyed by the signature's output
        names."""

    @abc.abstractmethod
    def cost_summary(self) -> Dict[str, Any]:
        """Static summary: nodes/params/memory plan/kernel selection."""
