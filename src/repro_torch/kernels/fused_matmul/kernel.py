"""Launch bindings of the CUDA ``fused_matmul`` kernel
(``csrc/fused_matmul.cu``) and of its int8 twin ``fused_matmul_q8``
(``csrc/fused_matmul_q8.cu``).

They replace the TPU kernels ``fused_matmul_p`` and ``fused_matmul_q8_p``
of ``src/repro/kernels/fused_matmul/kernel.py``; the source notes of the
``.cu`` files say what bounds them on the H100 and what their designs do
about it.  Callers go through :func:`ops.fused_matmul` and
:func:`ops.fused_matmul_q8`, which validate the tensors and count
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Activation codes of ``repro_fused_matmul`` (``csrc/fused_matmul.cu::Act``).
ACT_CODES = {None: 0, "linear": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
             "hard_sigmoid": 4, "elu": 5, "tanh": 6, "sigmoid": 7}
#: Largest M the grids take: (M + 63) // 64 blocks along gridDim.y.
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


def launch_q8(x: torch.Tensor, wq: torch.Tensor, deq: torch.Tensor, bias,
              scale, offset, out: torch.Tensor, *, x_scale: float,
              fn: Optional[str], alpha: float, fast: bool,
              w_layout: str) -> None:
    """out(M, N) = epilogue(deq * (q(x)(M, K) . Wq)) on the current stream
    of ``x``'s device, x quantized with ``x_scale`` as it is loaded.  The
    wrapper has checked devices, dtypes, shapes and contiguity."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul_q8(
            x.data_ptr(), wq.data_ptr(), deq.data_ptr(), _ptr(bias),
            _ptr(scale), _ptr(offset), out.data_ptr(), m, k, n,
            int(w_layout == "oi"), float(x_scale), ACT_CODES[fn],
            float(alpha), int(bool(fast)), stream)
    build.check(lib, rc, "fused_matmul_q8")
