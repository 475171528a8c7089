"""Plain torch version of the fused matmul + epilogue.

The port's counterpart of ``repro/kernels/fused_matmul/ref.py``: the
``jit`` target's dense lowering, the CPU side of the ``fused_matmul``
wrapper, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fast_act import ref as fast_ref


def fused_matmul_ref(
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
    """matmul + bias + activation + post-affine, each a separate op.
    ``elu`` is the exact ``expm1`` even when ``fast``, as in the
    reference's kernel epilogue."""
    y = x @ (w.T if w_layout == "oi" else w)
    return _epilogue_chain(y, bias, scale, offset, fn, fast, attrs)


def fused_matmul_split_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    splits: int,
    ksplit: int,
    fn: Optional[str] = None,
    fast: bool = False,
    w_layout: str = "io",
    attrs: Optional[dict] = None,
) -> torch.Tensor:
    """The CUDA kernel's split-K reduction in plain torch (tests and
    ``chip_smoke.py`` only): the partial products over the K ranges
    ``[i·ksplit, (i+1)·ksplit)`` summed in split order, then the
    epilogue once."""
    k = x.shape[-1]
    wk = w.T if w_layout == "oi" else w
    y = None
    for i in range(splits):
        k0, k1 = i * ksplit, min(k, (i + 1) * ksplit)
        part = x[:, k0:k1] @ wk[k0:k1]
        y = part if y is None else y + part
    return _epilogue_chain(y, bias, scale, offset, fn, fast, attrs)


def _epilogue_chain(y, bias, scale, offset, fn, fast, attrs):
    """The f32 epilogue chain alone (bias → activation → affine), each a
    separate op — shared by the int8 path, which produces ``y`` by
    dequantizing an exact integer sum instead of an f32 matmul."""
    attrs = attrs or {}
    if bias is not None:
        y = y + bias
    if fn and fn != "linear":
        if fn == "relu":
            y = torch.clamp_min(y, 0.0)
        elif fn == "relu6":
            y = torch.clamp(y, 0.0, 6.0)
        elif fn == "leaky_relu":
            y = torch.where(y >= 0, y, attrs.get("alpha", 0.01) * y)
        elif fn == "hard_sigmoid":
            y = torch.clamp(y * 0.2 + 0.5, 0.0, 1.0)
        elif fn == "elu":
            y = torch.where(y >= 0, y, torch.expm1(y))
        elif fn == "tanh":
            y = fast_ref.cf_tanh(y) if fast else torch.tanh(y)
        elif fn == "sigmoid":
            y = fast_ref.cf_sigmoid(y) if fast else torch.sigmoid(y)
        else:
            raise NotImplementedError(fn)
    if scale is not None:
        y = y * scale + offset
    return y


def fused_matmul_q8_ref(
    xq: torch.Tensor,
    wq: torch.Tensor,
    deq: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    fn: Optional[str] = None,
    fast: bool = False,
    w_layout: str = "io",
    attrs: Optional[dict] = None,
) -> torch.Tensor:
    """Int8 matmul of already quantized operands: an exact integer sum,
    one f32 multiply by ``deq`` (per-channel ``s_x * s_w``), then the
    f32 epilogue chain.

    The sum runs in float64 on the int8 values, on either device (CUDA
    has no integer matmul in ATen): each partial sum is an integer of
    magnitude below 127² · K < 2^53, so it is exact in any order and
    rounds to f32 as the reference's int32 sum does."""
    wd = wq.double()
    acc = xq.double() @ (wd.T if w_layout == "oi" else wd)
    y = acc.float() * deq
    return _epilogue_chain(y, bias, scale, offset, fn, fast, attrs)
