"""Public wrapper of the decode attention kernel.

``decode_attention`` runs a plain torch version (``ref.py``) for tensors
on the CPU — the tiled online softmax under ``fast``, whose rounding the
kernel follows, and the one-pass form otherwise — and launches the CUDA
kernels for CUDA tensors, raising on anything the kernels do not take;
there is no fallback between the two.  ``decode_attention.launches``
counts calls that launched the kernels: one a graph node, whatever the
number of CUDA kernels a call issues (``kernel.KERNELS_PER_CALL``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    fast: bool = False,
) -> torch.Tensor:
    """q (B, H, D), K/V (B, S, Hkv, D) f32, lengths (B,) int32 (missing:
    every row is valid); returns (B, H, D) f32.  ``scale`` defaults to
    D^-1/2."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, K "
                         f"{tuple(k_cache.shape)}, V {tuple(v_cache.shape)}")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k_cache.shape)}")
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        if fast:
            return ref.decode_attention_tiled(q, k_cache, v_cache, lengths,
                                              scale=scale, fast=True)
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("K", k_cache), ("V", v_cache)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"f32 tensor on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.shape != (b,) or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be a contiguous "
                         f"int32 ({b},) tensor on {q.device}")
    if h // hkv > kernel.MAX_GROUP or d > kernel.MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attention: the kernel takes G = H/Hkv <= "
            f"{kernel.MAX_GROUP} and D <= {kernel.MAX_HEAD_DIM}, got "
            f"G={h // hkv} D={d}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b and s and h and d:
        kernel.launch(q, k_cache, v_cache, lengths, out, scale=scale,
                      fast=fast)
        decode_attention.launches += 1
    return out


#: Calls that launched the kernels since the count was last set
#: (chip_smoke.py resets it).
decode_attention.launches = 0
