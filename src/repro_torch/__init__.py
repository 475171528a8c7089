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
on ``CompileOptions.device`` ("cuda" by default, where ``jit`` and
``cuda`` run one captured CUDA graph per batch size; "cpu" runs the
eager program, every kernel's plain version).  ``buckets=BucketPolicy``
pads batches to warm buckets, ``cache_dir`` (or
``$REPRO_TORCH_CACHE_DIR``) keeps the pass pipeline's output across
processes, and ``exe.serialize()`` / ``repro_torch.deserialize`` carry
an executable as bytes.
"""

from .api import (Bucket, BucketPolicy, CompileOptions, Executable,
                  ExecutableCache, available_targets, compile, deserialize,
                  get_target, prune, register_target)
from .core import Graph, ModelBuilder, SimpleNN, run_pipeline

__all__ = [
    "Bucket",
    "BucketPolicy",
    "CompileOptions",
    "Executable",
    "ExecutableCache",
    "Graph",
    "ModelBuilder",
    "SimpleNN",
    "available_targets",
    "compile",
    "deserialize",
    "get_target",
    "prune",
    "register_target",
    "run_pipeline",
]
