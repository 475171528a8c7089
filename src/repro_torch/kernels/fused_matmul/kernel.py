"""Launch binding of the CUDA ``fused_matmul`` kernel
(``csrc/fused_matmul.cu``).

Replaces the TPU kernel ``fused_matmul_p`` of
``src/repro/kernels/fused_matmul/kernel.py``; the source note of the
``.cu`` file says what bounds it on the H100 and what its design does
about it.  Callers go through :func:`ops.fused_matmul`, which validates
the tensors and counts launches.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Activation codes of ``repro_fused_matmul`` (``csrc/fused_matmul.cu::Act``).
ACT_CODES = {None: 0, "linear": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
             "hard_sigmoid": 4, "elu": 5, "tanh": 6, "sigmoid": 7}
#: Largest M the grid takes: (M + 63) // 64 blocks along gridDim.y.
MAX_M = 65535 * 64


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, w: torch.Tensor, bias, scale, offset,
           out: torch.Tensor, *, fn: Optional[str], alpha: float,
           fast: bool, w_layout: str) -> None:
    """out(M, N) = epilogue(x(M, K) . W) on the current stream of
    ``x``'s device.  The wrapper has checked devices, dtypes, shapes and
    contiguity."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul(
            x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(scale), _ptr(offset),
            out.data_ptr(), m, k, n, int(w_layout == "oi"),
            int(x.dtype == torch.bfloat16), ACT_CODES[fn], float(alpha),
            int(bool(fast)), stream)
    build.check(lib, rc, "fused_matmul")
