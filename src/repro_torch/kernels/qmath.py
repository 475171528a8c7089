"""Shared quantization arithmetic — one copy of the numerics.

The port of ``repro/kernels/qmath.py``.  Every consumer of a
``quant.*`` annotation — the SimpleNN oracle, the lowering rules, the
``fused_matmul_q8`` wrapper's plain version and the quantize pass —
routes through the helpers here, so "int8 dense" is the same arithmetic
on every target: the int8 sum is exact and the dequant is one f32
multiply, so the targets agree bit for bit.

Conventions (symmetric, as in the reference): an activation scale
``s_x = absmax / 127`` per tensor, weight scales ``s_w[n] = absmax_n /
127`` per output channel, ``q = clamp(round(x / s), -127, 127)``, zero
points 0.

``tensor_scale`` and ``channel_scales`` are numpy, copied verbatim, so
the scales come out bit-identical to the reference's.  The rest is on
tensors.  Two details keep ``quantize_q8`` bit-equal to the reference
and to the CUDA kernel (``csrc/fused_matmul_q8.cu``): ``torch.round``
rounds half to even like ``jnp.round`` and ``rintf``; and the scale is
always a *tensor* on ``x``'s device, because PyTorch divides a CUDA
tensor by a CPU scalar (a Python float) as a multiplication by the
reciprocal, which can differ from the true quotient in the last bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.ops_common import conv2d_nhwc

#: Symmetric int8 clip range (−127..127; −128 is excluded so the range
#: is symmetric and ``-q`` is always representable).
Q8_MAX = 127.0
#: Scale floor — an all-zero tensor quantizes with this scale instead
#: of dividing by zero.
EPS = 1e-12


def tensor_scale(absmax: float) -> float:
    """Per-tensor symmetric scale from a calibrated |x| maximum."""
    return max(float(absmax), EPS) / Q8_MAX


def channel_scales(w: np.ndarray, axis: int) -> np.ndarray:
    """Per-channel symmetric scales: |w| max reduced over every axis
    except ``axis`` (the output-channel axis), divided by 127."""
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    absmax = np.abs(np.asarray(w, dtype=np.float32)).max(axis=reduce_axes)
    return np.maximum(absmax, EPS).astype(np.float32) / np.float32(Q8_MAX)


def scale_tensor(scale, device) -> torch.Tensor:
    """``scale`` (a float, numpy array or tensor) as an f32 tensor on
    ``device``: a float becomes a 0-dim tensor made on the device (a
    fill, no host copy), rounded to f32 as ``jnp.float32`` rounds it."""
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32)
    if np.ndim(scale) == 0:
        return torch.full((), float(np.float32(scale)), dtype=torch.float32,
                          device=device)
    return torch.from_numpy(np.asarray(scale, np.float32)).to(device)


def quantize_q8(x: torch.Tensor, scale) -> torch.Tensor:
    """``clamp(round(x / scale), ±127) -> int8``.  ``scale`` broadcasts
    (a scalar for activations, a shaped array for per-channel weights).
    The ONE quantize expression: half to even, a true division."""
    q = torch.clamp(torch.round(x / scale_tensor(scale, x.device)),
                    -Q8_MAX, Q8_MAX)
    return q.to(torch.int8)


def dequant_scales(x_scale: float, w_scales) -> np.ndarray:
    """The fused f32 dequant vector ``s_x * s_w[n]``: one multiply per
    output channel, applied once to the exact int32 sum.  Computed in
    numpy f32, which rounds the product as ``jnp`` does."""
    return np.float32(x_scale) * np.asarray(w_scales, dtype=np.float32)


def quantize_weight(w: torch.Tensor, x_scale: float, w_scales,
                    w_layout: str = "io") -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 operand and the dequant vector of one dense site, as the
    reference's wrapper computes them on every call and its compiler
    constant-folds: ``wq = quantize_q8(w, s_w)`` per output channel of
    the ``w_layout`` W ("io" (K, N) or "oi" (N, K)), and ``deq = s_x *
    s_w`` in f32, both on ``w``'s device.  ``w_scales`` covers W's
    output width."""
    ws = scale_tensor(w_scales, w.device)
    wq = quantize_q8(w.float(), ws[None, :] if w_layout == "io"
                     else ws[:, None])
    deq = scale_tensor(dequant_scales(x_scale, w_scales), w.device)
    return wq.contiguous(), deq


def conv2d_q8(x: torch.Tensor, k_oihw: torch.Tensor, x_scale: float,
              w_scales, *, strides, padding) -> torch.Tensor:
    """Int8 NHWC convolution with an OIHW kernel: quantize both operands
    with the calibrated scales, sum exactly, dequantize with one f32
    multiply per output channel.  The sum runs in float64 on the int8
    values: every partial sum is an integer below 127² · (kh·kw·cin)
    < 2^53, so it is exact in any order, as the reference's int32 sum
    is.  ``padding`` is the node's own (lax semantics)."""
    ws = scale_tensor(w_scales, x.device)
    xq = quantize_q8(x, x_scale)
    kq = quantize_q8(k_oihw.float(), ws[:, None, None, None])
    acc = conv2d_nhwc(xq.double(), kq.double(), strides, padding)
    deq = scale_tensor(dequant_scales(x_scale, w_scales), x.device)
    return acc.float() * deq


def conv2d_bf16(x: torch.Tensor, k_oihw: torch.Tensor, *, strides,
                padding) -> torch.Tensor:
    """Bf16 NHWC convolution: round both operands to bfloat16, then
    convolve the widened f32 values in f32 (TF32 off, ``ops_common``).
    That is the reference's f32 accumulation (``preferred_element_type``);
    cuDNN's bf16 convolution would round its output to bf16 as well."""
    xq, kq = bf16_cast_pair(x, k_oihw)
    return conv2d_nhwc(xq.float(), kq.float(), strides, padding)


def bf16_cast_pair(x: torch.Tensor, w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 mode's only transformation: round both operands to
    bfloat16 (round to nearest even, as ``astype`` does)."""
    return x.to(torch.bfloat16), w.to(torch.bfloat16)
