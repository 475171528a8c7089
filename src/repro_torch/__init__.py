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

``repro_torch.compile`` also takes what a frontend
(``repro_torch.frontends``) turns into a graph: a ``ModelBuilder``, an
``.npz`` container path, or a plain function over
``repro_torch.frontends.ops`` (``repro_torch.trace(fn, *specs)``, or
``compile(fn, example_inputs=...)``).  ``capture=<dir>`` records a
bundle of the compile that ``python -m repro_torch.replay <dir>``
reproduces in a fresh process.

An LLM config compiles with ``target="engine"``, and
``repro_torch.serve(exe, repro_torch.SchedulerOptions(...))`` serves it
with continuous batching, one captured CUDA graph per decode batch
bucket on the card (:mod:`repro_torch.serve`).

``CompileOptions(mesh="data=2,model=2")`` compiles a graph for a device
mesh over the ``torch.distributed`` process group
(:mod:`repro_torch.dist`: ``MeshSpec``, ``ShardedExecutable``).
"""

from .api import (Bucket, BucketPolicy, CompileOptions, Executable,
                  ExecutableCache, MeshSpec, MeshUnavailableError,
                  SchedulerOptions, available_frontends,
                  available_targets, compile, deserialize, get_frontend,
                  get_target, prune, register_frontend, register_target,
                  resolve_cache_dir, trace)
from .core import Graph, ModelBuilder, SimpleNN, run_pipeline
# The callable module: repro_torch.serve(exe, ...) and
# repro_torch.serve.Scheduler resolve to the same object.
from . import serve

__all__ = [
    "Bucket",
    "BucketPolicy",
    "CompileOptions",
    "Executable",
    "ExecutableCache",
    "Graph",
    "MeshSpec",
    "MeshUnavailableError",
    "ModelBuilder",
    "SchedulerOptions",
    "SimpleNN",
    "available_frontends",
    "available_targets",
    "compile",
    "deserialize",
    "get_frontend",
    "get_target",
    "prune",
    "register_frontend",
    "register_target",
    "resolve_cache_dir",
    "run_pipeline",
    "serve",
    "trace",
]
