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
    attrs = attrs or {}
    y = x @ (w.T if w_layout == "oi" else w)
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
