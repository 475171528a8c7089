"""Public wrappers of the fused matmul kernels.

``fused_matmul`` (f32/bf16) and ``fused_matmul_q8`` (int8) run their
plain torch versions (``ref.py``) for a tensor on the CPU and launch
their CUDA kernels for a CUDA tensor, raising on anything the kernel
does not take; there is no fallback between the two.  Each keeps a
``launches`` count of kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import kernel, ref
from .. import qmath

_DTYPES = (torch.float32, torch.bfloat16)


def _check_vec(name: str, v: Optional[torch.Tensor], n: int,
               device: torch.device, what: str = "fused_matmul") -> None:
    if v is None:
        return
    if v.device != device or v.dtype != torch.float32 or v.shape != (n,) \
            or not v.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous f32 ({n},) tensor on "
            f"{device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


def _check_common(what: str, x, w, scale, offset, fn, w_layout) -> int:
    """Checks both wrappers share; returns N."""
    if w_layout not in ("io", "oi"):
        raise ValueError(f"{what}: unknown w_layout {w_layout!r}")
    if fn not in kernel.ACT_CODES:
        raise NotImplementedError(f"{what}: activation {fn!r}")
    if (scale is None) != (offset is None):
        raise ValueError(f"{what}: scale and offset go together")
    k = x.shape[-1]
    if w.ndim != 2 or w.shape[0 if w_layout == "io" else 1] != k:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not contract "
                         f"with W {tuple(w.shape)} ({w_layout})")
    return w.shape[1] if w_layout == "io" else w.shape[0]


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
    counters: Optional[kernel.SplitCounters] = None,
    plan: Optional[kernel.Plan] = None,
) -> torch.Tensor:
    """y = affine(act(x @ W + bias)) with W in 'io' (K,N) or 'oi' (N,K).

    x may be any rank; the contraction is over its last axis.  Operands
    are f32 or bf16 (x and W alike), bias/scale/offset f32 (N,); the
    output is f32.  ``counters`` are the split counters of the program
    that calls (``LoweringContext.counters``); a direct call uses
    ``kernel.SHARED_COUNTERS``.  ``plan`` is a ready
    :func:`kernel.plan` for this (M, K, N) (a tactic the autotuner
    chose); None launches the heuristic's.  The plain version on the CPU
    is the same for every plan.
    """
    n = _check_common("fused_matmul", x, w, scale, offset, fn, w_layout)
    attrs = attrs or {}
    shape = x.shape
    k = shape[-1]
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
        if plan is None:
            plan = kernel.plan(m, k, n, w_layout=w_layout,
                               itemsize=x.element_size())
        kernel.check_plan(plan, m, k, n, "fused_matmul")
        kernel.launch(x2, w, bias, scale, offset, out, fn=fn,
                      alpha=attrs.get("alpha", 0.01), fast=fast,
                      w_layout=w_layout,
                      counters=counters or kernel.SHARED_COUNTERS, p=plan)
        fused_matmul.launches += 1
    return out.reshape(shape[:-1] + (n,))


#: Calls that launched the kernel, eagerly or into a CUDA graph under
#: capture, since the count was last set (chip_smoke.py resets it).  A
#: graph's replay passes through no wrapper; chip_smoke.py counts replays
#: from the profiler's kernel names.
fused_matmul.launches = 0


def fused_matmul_q8(
    x: torch.Tensor,
    wq: torch.Tensor,
    deq: Optional[torch.Tensor],
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    x_scale: float,
    fn: Optional[str] = None,
    fast: bool = False,
    w_layout: str = "io",
    attrs: Optional[dict] = None,
    counters: Optional[kernel.SplitCounters] = None,
    plan: Optional[kernel.Plan] = None,
    sums: bool = False,
) -> torch.Tensor:
    """Int8 fused matmul: y = affine(act(deq * (q(x) @ Wq) + bias)) with
    q(x) = ``qmath.quantize_q8(x, x_scale)`` and Wq int8 in 'io' (K,N) or
    'oi' (N,K) (:func:`~repro_torch.kernels.qmath.quantize_weight`).

    x is f32 of any rank (contracted over its last axis), ``x_scale`` a
    float (rounded to f32, as the reference rounds it); deq/bias/scale/
    offset f32 (N,); the output is f32.  The kernel quantizes x as it
    loads it, so a CUDA call is one launch.  ``counters`` as for
    :func:`fused_matmul`; ``plan`` a ready :func:`kernel.plan_q8`, as
    there.

    ``sums=True`` returns the exact int32 sums ``q(x) @ Wq`` themselves,
    with no dequantize and no epilogue (``deq`` None, no bias, scale,
    offset or activation): what a row-parallel site all-reduces before
    it dequantizes (``core/lowering.py``).
    """
    n = _check_common("fused_matmul_q8", x, wq, scale, offset, fn, w_layout)
    if sums and (deq is not None or bias is not None or scale is not None
                 or fn not in (None, "linear")):
        raise ValueError("fused_matmul_q8: sums=True takes no deq, bias, "
                         "affine or activation")
    if not sums and deq is None:
        raise ValueError("fused_matmul_q8: deq is required unless sums=True")
    attrs = attrs or {}
    shape = x.shape
    k = shape[-1]
    if x.device.type == "cpu":
        xq = qmath.quantize_q8(x.reshape(-1, k).float(), x_scale)
        if sums:
            return ref.q8_sums_ref(xq, wq, w_layout=w_layout).reshape(
                shape[:-1] + (n,))
        y = ref.fused_matmul_q8_ref(
            xq, wq, deq, bias, scale, offset, fn=fn, fast=fast,
            w_layout=w_layout, attrs=attrs)
        return y.reshape(shape[:-1] + (n,))
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_q8: unsupported device {x.device}")
    if x.dtype != torch.float32 or wq.dtype != torch.int8:
        raise TypeError(f"fused_matmul_q8: x must be f32 and Wq int8, got "
                        f"x {x.dtype}, Wq {wq.dtype}")
    if wq.device != x.device:
        raise ValueError(f"fused_matmul_q8: Wq on {wq.device}, x on {x.device}")
    if not (x.is_contiguous() and wq.is_contiguous()):
        raise ValueError("fused_matmul_q8: the CUDA kernel needs contiguous "
                         "x and Wq")
    if isinstance(x_scale, torch.Tensor):
        raise TypeError("fused_matmul_q8: x_scale is a float (reading a "
                        "device tensor would synchronise)")
    if not float(x_scale) > 0.0:
        raise ValueError(f"fused_matmul_q8: x_scale must be > 0, got {x_scale}")
    if not sums:
        _check_vec("deq", deq, n, x.device, "fused_matmul_q8")
    for name, v in (("bias", bias), ("scale", scale), ("offset", offset)):
        _check_vec(name, v, n, x.device, "fused_matmul_q8")
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m > kernel.MAX_M_Q8:
        raise ValueError(f"fused_matmul_q8: M={m} exceeds the grid's "
                         f"{kernel.MAX_M_Q8}")
    out = torch.empty((m, n), dtype=torch.int32 if sums else torch.float32,
                      device=x.device)
    if m and n:
        if plan is None:
            plan = kernel.plan_q8(m, k, n, w_layout=w_layout)
        kernel.check_plan(plan, m, k, n, "fused_matmul_q8")
        kernel.launch_q8(x2, wq, deq, bias, scale, offset, out,
                         x_scale=float(np.float32(x_scale)), fn=fn,
                         alpha=attrs.get("alpha", 0.01), fast=fast,
                         w_layout=w_layout,
                         counters=counters or kernel.SHARED_COUNTERS,
                         p=plan)
        fused_matmul_q8.launches += 1
    return out.reshape(shape[:-1] + (n,))


#: Calls that launched the kernel, eagerly or into a CUDA graph under
#: capture, since the count was last set (chip_smoke.py resets it).  A
#: graph's replay passes through no wrapper; chip_smoke.py counts replays
#: from the profiler's kernel names.
fused_matmul_q8.launches = 0
