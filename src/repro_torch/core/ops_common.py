"""Op helpers shared by the SimpleNN oracle and the lowering rules.

Tensors are NHWC at every op boundary, as in the reference.  The
convolution and pooling helpers permute to NCHW views for ATen/cuDNN
and back; on a contiguous NHWC tensor the NCHW view is already
``channels_last``, so the permutes copy nothing.

Three semantics of the reference are reproduced explicitly here:

* ``lax`` "SAME" padding puts the odd pixel at the bottom/right
  (``low = total // 2``); at stride 2 that is asymmetric, which neither
  ``conv2d(padding=k//2)`` nor ``padding="same"`` expresses, so the pads
  are computed and applied with ``F.pad`` when they differ.
* Average pooling divides by the number of valid cells in the window,
  not by the window size.
* f32 convolutions on the GPU run with TF32 off (cuDNN's default is on),
  so they agree with the oracle to f32 rounding, not to TF32's ~1e-3.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def spatial_pads(padding, h: int, w: int, kh: int, kw: int,
                 sh: int, sw: int) -> Pads:
    """'same'/'valid'/explicit ((t,b),(l,r)) -> explicit ((t,b),(l,r)),
    with ``lax``'s placement of an odd "SAME" pad (bottom/right)."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            return _same_pads(h, kh, sh), _same_pads(w, kw, sw)
        if padding.lower() == "valid":
            return (0, 0), (0, 0)
        raise ValueError(f"unknown padding {padding!r}")
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


@contextlib.contextmanager
def _ieee_f32_convs(x: torch.Tensor):
    """cuDNN convolutions in full f32 (TF32 off) for the duration."""
    if not x.is_cuda:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, strides, padding,
                bias=None, groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight and ``lax`` padding semantics."""
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    sh, sw = strides
    (t, b), (l, r) = spatial_pads(padding, x.shape[1], x.shape[2],
                                  kh, kw, sh, sw)
    xc = x.permute(0, 3, 1, 2)
    with _ieee_f32_convs(x):
        if t == b and l == r:
            y = F.conv2d(xc, w_oihw, bias, stride=(sh, sw), padding=(t, l),
                         groups=groups)
        else:
            y = F.conv2d(F.pad(xc, (l, r, t, b)), w_oihw, bias,
                         stride=(sh, sw), groups=groups)
    return y.permute(0, 2, 3, 1)


def maxpool2d_nhwc(x: torch.Tensor, pool_size, strides, padding) -> torch.Tensor:
    """Max pool; padded cells are -inf, as in ``reduce_window``."""
    (t, b), (l, r) = spatial_pads(padding, x.shape[1], x.shape[2],
                                  *pool_size, *strides)
    xc = x.permute(0, 3, 1, 2)
    if t or b or l or r:
        xc = F.pad(xc, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, tuple(pool_size), tuple(strides)).permute(0, 2, 3, 1)


def avgpool2d_nhwc(x: torch.Tensor, pool_size, strides, padding) -> torch.Tensor:
    """Window sum over the count of valid (unpadded) cells."""
    (t, b), (l, r) = spatial_pads(padding, x.shape[1], x.shape[2],
                                  *pool_size, *strides)
    pads = (l, r, t, b)
    xc = F.pad(x.permute(0, 3, 1, 2), pads)
    ones = F.pad(torch.ones_like(x[:1, :, :, :1]).permute(0, 3, 1, 2), pads)
    s = F.avg_pool2d(xc, tuple(pool_size), tuple(strides), divisor_override=1)
    n = F.avg_pool2d(ones, tuple(pool_size), tuple(strides), divisor_override=1)
    return (s / n).permute(0, 2, 3, 1)


def apply_activation(fn: str, x: torch.Tensor, attrs: Dict) -> torch.Tensor:
    """The exact activation semantics (oracle and compiled paths alike)."""
    if fn == "linear":
        return x
    if fn == "relu":
        return torch.clamp_min(x, 0.0)
    if fn == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if fn == "leaky_relu":
        alpha = attrs.get("alpha", 0.01)
        return torch.where(x >= 0, x, alpha * x)
    if fn == "sigmoid":
        return torch.sigmoid(x)
    if fn == "tanh":
        return torch.tanh(x)
    if fn == "elu":
        return torch.where(x >= 0, x, torch.expm1(x))
    if fn == "hard_sigmoid":
        return torch.clamp(x * 0.2 + 0.5, 0.0, 1.0)
    if fn == "softmax":
        return torch.softmax(x, dim=attrs.get("axis", -1))
    raise NotImplementedError(fn)


def fast_activation(fn: str, x: torch.Tensor, attrs: Dict) -> torch.Tensor:
    """The paper's §3.4 approximations in plain torch; exact forms for
    everything else."""
    from ..kernels.fast_act import ref as fast_ref

    if fn == "tanh":
        return fast_ref.cf_tanh(x)
    if fn == "sigmoid":
        return fast_ref.cf_sigmoid(x)
    if fn == "softmax":
        return fast_ref.fast_softmax(x, axis=attrs.get("axis", -1))
    if fn == "elu":
        return torch.where(x >= 0, x, fast_ref.schraudolph_exp(x) - 1.0)
    return apply_activation(fn, x, attrs)
