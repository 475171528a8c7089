"""repro_torch.frontends — model ingestion behind a registry.

The port of ``repro.frontends``.  A *frontend* normalizes some external
model description into the :class:`~repro_torch.core.graph.Graph` IR,
mirroring how targets
(``@register_target``), passes (``@register_pass``) and lowerings
(``@register_lowering``) plug into the rest of the compiler::

    from repro_torch.frontends import Frontend, register_frontend

    @register_frontend("my-format")
    class MyFrontend(Frontend):
        def accepts(self, model):
            return isinstance(model, MyModelDescription)
        def to_graph(self, model, **kw):
            return build_graph_from(model)

``repro_torch.compile`` consults the registry for any model it does not
natively understand, so new ingestion paths never edit the dispatch.
Built-ins (registered by :mod:`.builder`): ``"graph"`` (identity),
``"builder"`` (ModelBuilder), ``"container"`` (``.npz`` files, see
:mod:`.container`, the format the reference reads too) and ``"trace"``
(bare callables, see :mod:`.trace` — the ``repro_torch.trace`` entry
point).
"""

from __future__ import annotations

import abc
from typing import Dict, Tuple

from ..core.graph import Graph


class Frontend(abc.ABC):
    """Normalizes one family of model descriptions into the Graph IR."""

    name: str = "?"

    @abc.abstractmethod
    def accepts(self, model) -> bool:
        """Cheap structural test: can this frontend ingest ``model``?"""

    @abc.abstractmethod
    def to_graph(self, model, **kw) -> Graph:
        """Ingest ``model``; keyword args carry frontend-specific
        options (e.g. the trace frontend's ``example_inputs``)."""


_FRONTENDS: Dict[str, Frontend] = {}


def register_frontend(name: str):
    """Decorator: register a :class:`Frontend` subclass (or instance)
    under ``name`` (overwrites).  Resolution tries frontends in
    registration order."""

    def deco(obj):
        frontend = obj() if isinstance(obj, type) else obj
        frontend.name = name
        _FRONTENDS[name] = frontend
        return obj

    return deco


def get_frontend(name: str) -> Frontend:
    try:
        return _FRONTENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown frontend {name!r}; available: {available_frontends()}"
        ) from None


def available_frontends() -> Tuple[str, ...]:
    return tuple(sorted(_FRONTENDS))


def resolve(model, *, frontend: str = None, **kw) -> Graph:
    """Normalize ``model`` to a Graph via the first accepting frontend
    (or the named one).  Raises ``TypeError`` naming the registered
    frontends when nothing accepts the model."""
    if frontend is not None:
        return get_frontend(frontend).to_graph(model, **kw)
    for fe in _FRONTENDS.values():
        if fe.accepts(model):
            return fe.to_graph(model, **kw)
    raise TypeError(
        f"cannot compile {type(model).__name__}: expected a Graph or a "
        f"model accepted by a registered frontend "
        f"({', '.join(available_frontends())}); LLM configs and models "
        f"(the reference's engine target) are not ported yet (ROADMAP "
        f"A.12: LLM models and the engine target). Bare callables compile "
        f"via repro_torch.compile(fn, example_inputs=…) or "
        f"repro_torch.trace(fn, *specs); register new model formats with "
        f"@register_frontend")


from . import builder as _builtin_frontends  # noqa: E402  (self-registration)
from . import trace as ops                   # noqa: E402,F401  (the ops namespace)
from .trace import trace                     # noqa: E402,F401

from .container import load_model, save_model  # noqa: E402

__all__ = [
    "Frontend",
    "available_frontends",
    "get_frontend",
    "load_model",
    "ops",
    "register_frontend",
    "resolve",
    "save_model",
    "trace",
]
