"""Built-in frontends for models we already speak natively: graph IR,
``ModelBuilder``, the ``.npz`` container, and traced callables.

The port of ``repro.frontends.builder``.  Each is a
:class:`~repro_torch.frontends.Frontend` registered with
``@register_frontend`` — the same plug-in seam third parties use to
teach ``repro_torch.compile`` new model formats.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.graph import Graph, TensorSpec
from . import Frontend, register_frontend
from .container import CONTAINER_SUFFIX, load_model
from .trace import trace


def _dtype_name(dtype) -> str:
    """The IR's name of an example input's dtype: a torch dtype prints
    as ``"torch.float32"``, which is no IR dtype, so it maps to
    ``"float32"``; a numpy dtype is its name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@register_frontend("graph")
class GraphFrontend(Frontend):
    """The identity frontend: the model already *is* the IR."""

    def accepts(self, model) -> bool:
        return isinstance(model, Graph)

    def to_graph(self, model) -> Graph:
        return model


@register_frontend("builder")
class BuilderFrontend(Frontend):
    """Accepts a ``ModelBuilder`` whose outputs are set (or passed as
    ``outputs=``), so a builder can go straight into
    ``repro_torch.compile`` without the explicit ``.build()`` call."""

    def accepts(self, model) -> bool:
        from ..core.keras_like import ModelBuilder
        return isinstance(model, ModelBuilder)

    def to_graph(self, model, *, outputs=None) -> Graph:
        if outputs is not None:
            return model.build(outputs)
        if not model.graph.outputs:
            raise TypeError(
                "ModelBuilder has no outputs: call .build([...]) first or "
                "pass outputs=[...] to repro_torch.compile")
        return model.graph


@register_frontend("container")
class ContainerFrontend(Frontend):
    """Accepts a path to an ``.npz`` model container — the paper's
    load-a-pretrained-file-then-compile flow (a container the reference
    wrote loads too)."""

    def accepts(self, model) -> bool:
        return (isinstance(model, (str, os.PathLike))
                and os.fspath(model).endswith(CONTAINER_SUFFIX))

    def to_graph(self, model) -> Graph:
        return load_model(os.fspath(model))


@register_frontend("trace")
class TraceFrontend(Frontend):
    """Accepts a bare callable; needs ``specs=`` (batch-less shapes /
    TensorSpecs) or ``example_inputs=`` (numpy arrays or torch tensors,
    on any device, *with* a batch dim, as the callable would receive at
    run time) to know the input shapes."""

    def accepts(self, model) -> bool:
        return callable(model) and not isinstance(model, type)

    def to_graph(self, model, *, specs=None, example_inputs=None,
                 input_names=None) -> Graph:
        if specs is None and example_inputs is None:
            raise TypeError(
                "tracing a callable needs specs=(shape-or-TensorSpec, ...) "
                "or example_inputs=(array or tensor, ...) — arrays carry a "
                "leading batch dimension, specs do not")
        if specs is None:
            if isinstance(example_inputs, dict):
                input_names = list(example_inputs.keys())
                example_inputs = list(example_inputs.values())
            elif not isinstance(example_inputs, (tuple, list)):
                example_inputs = [example_inputs]
            specs = []
            for a in example_inputs:
                shape, dtype = tuple(a.shape), _dtype_name(a.dtype)
                if not shape:
                    raise TypeError(
                        f"example input of shape {shape} has no batch "
                        f"dimension to strip")
                specs.append(TensorSpec(shape[1:], dtype))
        elif isinstance(specs, TensorSpec) or (
                isinstance(specs, (tuple, list))
                and all(isinstance(d, int) for d in specs)):
            specs = [specs]    # a single spec, not a list of specs
        return trace(model, *specs, input_names=input_names)
