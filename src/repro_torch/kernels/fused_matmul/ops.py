"""Public wrapper of the fused matmul kernel.

``fused_matmul`` runs the plain torch version (``ref.py``) for a tensor
on the CPU and launches the CUDA kernel for a CUDA tensor, raising on
anything the kernel does not take; there is no fallback between the
two.  ``fused_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check_vec(name: str, v: Optional[torch.Tensor], n: int,
               device: torch.device) -> None:
    if v is None:
        return
    if v.device != device or v.dtype != torch.float32 or v.shape != (n,) \
            or not v.is_contiguous():
        raise ValueError(
            f"fused_matmul: {name} must be a contiguous f32 ({n},) tensor on "
            f"{device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


def fused_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    fn: Optional[str] = None,
    fast: bool = False,
    w_layout: str = "io",
    attrs: Optional[dict] = None,
) -> torch.Tensor:
    """y = affine(act(x @ W + bias)) with W in 'io' (K,N) or 'oi' (N,K).

    x may be any rank; the contraction is over its last axis.  Operands
    are f32 or bf16 (x and W alike), bias/scale/offset f32 (N,); the
    output is f32.
    """
    if w_layout not in ("io", "oi"):
        raise ValueError(f"fused_matmul: unknown w_layout {w_layout!r}")
    if fn not in kernel.ACT_CODES:
        raise NotImplementedError(f"fused_matmul: activation {fn!r}")
    if (scale is None) != (offset is None):
        raise ValueError("fused_matmul: scale and offset go together")
    attrs = attrs or {}
    shape = x.shape
    k = shape[-1]
    if w.ndim != 2 or w.shape[0 if w_layout == "io" else 1] != k:
        raise ValueError(f"fused_matmul: x {tuple(shape)} does not contract "
                         f"with W {tuple(w.shape)} ({w_layout})")
    n = w.shape[1] if w_layout == "io" else w.shape[0]
    if x.device.type == "cpu":
        y = ref.fused_matmul_ref(
            x.reshape(-1, k).float(), w.float(), bias, scale, offset, fn=fn,
            fast=fast, w_layout=w_layout, attrs=attrs)
        return y.reshape(shape[:-1] + (n,))
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"fused_matmul: operands must both be one of "
                        f"{_DTYPES}, got x {x.dtype}, W {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"fused_matmul: W on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_matmul: the CUDA kernel needs contiguous "
                         "x and W")
    for name, v in (("bias", bias), ("scale", scale), ("offset", offset)):
        _check_vec(name, v, n, x.device)
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m > kernel.MAX_M:
        raise ValueError(f"fused_matmul: M={m} exceeds the grid's {kernel.MAX_M}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        kernel.launch(x2, w, bias, scale, offset, out, fn=fn,
                      alpha=attrs.get("alpha", 0.01), fast=fast,
                      w_layout=w_layout)
        fused_matmul.launches += 1
    return out.reshape(shape[:-1] + (n,))


#: Kernel launches since the count was last set (chip_smoke.py resets it).
fused_matmul.launches = 0
