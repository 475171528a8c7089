"""Launch binding of the CUDA ``fast_act`` kernel (``csrc/fast_act.cu``).

Replaces the TPU kernel ``fast_act_2d`` of
``src/repro/kernels/fast_act/kernel.py``.  The kernel is a grid-stride
elementwise map over a flat contiguous tensor; its source note says what
bounds it on the H100.  Callers go through :func:`ops.fast_act`, which
validates the tensors and counts launches.
"""

from __future__ import annotations

import torch

#: Function codes of ``repro_fast_act`` (``csrc/fast_act.cu::FastFn``).
FN_CODES = {"exp": 0, "tanh": 1, "sigmoid": 2}


def launch(x: torch.Tensor, y: torch.Tensor, fn: str) -> None:
    """Run the kernel on the current stream of ``x``'s device: y = fn(x)
    elementwise.  Both are contiguous CUDA tensors of one dtype (f32 or
    bf16) and size; the wrapper has checked that."""
    from .. import build

    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fast_act(x.data_ptr(), y.data_ptr(), x.numel(),
                                FN_CODES[fn], int(x.dtype == torch.bfloat16),
                                stream)
    build.check(lib, rc, "fast_act")
