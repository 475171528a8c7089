"""repro_torch.core — the compiler's IR, passes, oracle and lowering.

Public API:
    Graph, ModelBuilder         — build/load models
    SimpleNN                    — exact oracle interpreter
    run_pipeline                — the pass pipeline, standalone

The compilation entry point lives in ``repro_torch.api``
(``repro_torch.compile``); the shared graph→torch lowering is
``repro_torch.core.lowering``.
"""

from .graph import (Graph, Node, Signature, TensorSpec, register_op,
                    register_shape_rule)
from .keras_like import ModelBuilder
from ..frontends.container import load_model, save_model
from .simple import SimpleNN
from .passes import (run_pipeline, DEFAULT_PIPELINE, PassManager,
                     PassOrderingError, PassVerificationError, register_pass)
from .lowering import register_lowering, registered_ops, UnsupportedOpError
from .selection import KernelChoice, select_kernels

__all__ = [
    "Graph", "Node", "TensorSpec", "Signature", "register_op",
    "register_shape_rule",
    "ModelBuilder", "load_model", "save_model",
    "SimpleNN",
    "run_pipeline", "DEFAULT_PIPELINE",
    "PassManager", "PassOrderingError", "PassVerificationError",
    "register_pass",
    "register_lowering", "registered_ops",
    "UnsupportedOpError",
    "KernelChoice", "select_kernels",
]
