"""The check that the process that prints a result never loaded JAX or
the JAX package: top-level module names compared whole, so
``repro_torch`` passes and ``repro`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``
    by default), sorted."""
    names = list(sys.modules) if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
