"""Public wrappers for the fast activations.

``fast_act(x, fn)`` runs the plain torch version (``ref.py``) for a
tensor on the CPU and launches the CUDA kernel for a CUDA tensor; there
is no fallback between the two.  ``fast_act.launches`` counts kernel
launches.  ``fast_softmax`` and ``fast_activation`` build the compiler's
fast softmax/elu/tanh/sigmoid on it, so under ``precision="fast"`` on
the ``cuda`` target every exp, tanh and sigmoid runs in the kernel
(mirroring the reference's ``fast_softmax(use_pallas=True)``).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16)


def fast_act(x: torch.Tensor, fn: str) -> torch.Tensor:
    """fn in {'exp', 'tanh', 'sigmoid'}, any shape; the output keeps the
    input dtype (f32 or bf16), the math is f32 inside on both paths."""
    if fn not in kernel.FN_CODES:
        raise ValueError(f"fast_act: unknown fn {fn!r}; "
                         f"expected one of {sorted(kernel.FN_CODES)}")
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return ref.FAST[fn](x.float()).to(torch.bfloat16)
        return ref.FAST[fn](x)
    if x.device.type != "cuda":
        raise ValueError(f"fast_act: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fast_act: dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("fast_act: the CUDA kernel needs a contiguous input")
    y = torch.empty_like(x)
    if x.numel():
        kernel.launch(x, y, fn)
        fast_act.launches += 1
    return y


#: Kernel launches since the count was last set (chip_smoke.py resets it).
fast_act.launches = 0


def fast_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Max-subtracted softmax on the fast exp (paper §3.4)."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = fast_act((x - m).contiguous(), "exp")
    return e / torch.sum(e, dim=axis, keepdim=True)


#: Activations with a fast form that runs in the kernel.
KERNEL_FNS = ("tanh", "sigmoid", "softmax", "elu")


def fast_activation(fn: str, x: torch.Tensor, attrs: Dict) -> torch.Tensor:
    """``ops_common.fast_activation`` with every exp/tanh/sigmoid in
    ``fast_act``; ``fn`` must be one of :data:`KERNEL_FNS`."""
    if fn in ("tanh", "sigmoid"):
        return fast_act(x.to(torch.float32).contiguous(), fn)
    if fn == "softmax":
        return fast_softmax(x, axis=attrs.get("axis", -1))
    if fn == "elu":
        x = x.to(torch.float32)
        return torch.where(x >= 0, x, fast_act(x.contiguous(), "exp") - 1.0)
    raise ValueError(f"fast_activation: {fn!r} has no fast_act kernel form")
