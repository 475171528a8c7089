"""repro_torch — the PyTorch/CUDA port of the ``repro`` JIT compiler.

A second package beside the JAX reference (``repro``), importable under
the same ``PYTHONPATH=src``.  It imports torch and numpy, never jax and
nothing of ``repro``.

    import repro_torch
    from repro_torch.table1_models import SUITE
    exe = repro_torch.compile(SUITE["VGG19"](),
                              repro_torch.CompileOptions(target="cuda"))
    out = exe(input=x)          # x: (batch, 64, 64, 3), NHWC

Targets: ``interpret`` (SimpleNN oracle), ``jit`` (passes + ATen) and
``cuda`` (``jit`` + hand-written CUDA kernels for Hopper).  Programs run
on ``CompileOptions.device`` ("cuda" by default; "cpu" runs every
kernel's plain version).
"""

from .api import (CompileOptions, Executable, available_targets, compile,
                  get_target, register_target)
from .core import Graph, ModelBuilder, SimpleNN, run_pipeline

__all__ = [
    "CompileOptions",
    "Executable",
    "Graph",
    "ModelBuilder",
    "SimpleNN",
    "available_targets",
    "compile",
    "get_target",
    "register_target",
    "run_pipeline",
]
