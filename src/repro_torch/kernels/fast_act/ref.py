"""Plain torch versions of the fast activation approximations (§3.4).

The port's counterpart of ``repro/kernels/fast_act/ref.py`` and the
plain version the CUDA kernel (``csrc/fast_act.cu``) is held against:

* ``schraudolph_exp`` — Schraudolph (1999): ``int32(A*x + (B-C))``,
  truncated toward zero, read back as the bits of an f32.
* ``cf_tanh`` — the degree-(7,8) continued fraction of Eq. 5, clamped at
  ±4.97; ``cf_sigmoid`` = (tanh(x/2)+1)/2 (Eq. 4).

Eager torch runs every ``*`` and ``+`` below as its own f32 op, with
the Python constants rounded to f32, so the CUDA kernel reproduces this
bit for bit when it, too, rounds after each operation (no FMA).
"""

from __future__ import annotations

import torch

# The reference's Schraudolph constants (double); f32 rounds A to
# 12102203 and B-C = 1064866808 to 1064866816.
_EXP_A = 12102203.161561485  # 2^23 / ln(2)
_EXP_B = 127.0 * (2.0 ** 23)
_EXP_C = 60801.0 * 8.0


def schraudolph_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) via the IEEE-754 bit trick.  Max relative error ~4%."""
    x = torch.clamp(x.to(torch.float32), -87.0, 88.0)
    i = (_EXP_A * x + (_EXP_B - _EXP_C)).to(torch.int32)
    return i.view(torch.float32)


def cf_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh via the truncated continued fraction (paper Eq. 5)."""
    x = torch.clamp(x.to(torch.float32), -4.97, 4.97)
    x2 = x * x
    num = (((36.0 * x2 + 6930.0) * x2 + 270270.0) * x2 + 2027025.0) * x
    den = (((x2 + 630.0) * x2 + 51975.0) * x2 + 945945.0) * x2 + 2027025.0
    return num / den


def cf_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) = (tanh(x/2) + 1) / 2   (paper Eq. 4)."""
    x = x.to(torch.float32)
    return 0.5 * (cf_tanh(0.5 * x) + 1.0)


def fast_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Two-pass softmax (§3.4) with the Schraudolph exp."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = schraudolph_exp(x - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


FAST = {
    "exp": schraudolph_exp,
    "tanh": cf_tanh,
    "sigmoid": cf_sigmoid,
    "softmax": fast_softmax,
}
