"""Plain torch versions of single-token GQA decode attention.

The port's counterpart of ``repro/kernels/decode_attention/ref.py``, in
two forms:

* :func:`decode_attention_ref` — the one-pass form (all S scores, one
  softmax), which the reference's ``jit`` and ``interpret`` targets run;
* :func:`decode_attention_tiled` — the online softmax of the TPU kernel
  (``kernel.py::_decode_kernel``) walking S in ``bs``-row tiles, which
  the reference's ``pallas`` target runs and the CUDA kernel
  (``csrc/decode_attention.cu``) is held to;
* :func:`decode_attention_split` — the CUDA kernel's own algorithm (S
  split into chunks of tiles with the tiled form's running maxima), for
  the tests and ``chip_smoke.py`` only.

Exact, the two differ only by rounding.  Under ``fast`` they differ by
more: ``alpha = exp(m_prev - m_new)`` goes through the Schraudolph exp,
and that approximation does not compose (exp(a)·exp(b) ≠ exp(a+b)), so
the tile size and order are part of the result.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fast_act import ref as fast_ref

#: KV rows per tile of the TPU kernel (``DEFAULT_BS``) and of the CUDA
#: kernel (``csrc/decode_attention.cu::BS``).
DEFAULT_BS = 512


def _exp(fast: bool):
    return fast_ref.schraudolph_exp if fast else torch.exp


def decode_attention_ref(
    q: torch.Tensor,          # (B, H, D)
    k_cache: torch.Tensor,    # (B, S, Hkv, D)
    v_cache: torch.Tensor,    # (B, S, Hkv, D)
    lengths: Optional[torch.Tensor] = None,  # (B,) int32 valid lengths
    *,
    scale: Optional[float] = None,
    fast: bool = False,
) -> torch.Tensor:
    """One-pass grouped-query decode attention, length-masked, f32."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache) * scale
    if lengths is not None:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, None, None, :] < lengths[:, None, None, None]
        scores = torch.where(mask, scores, float("-inf"))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = _exp(fast)(scores - m)
    if lengths is not None:
        e = torch.where(mask, e, 0.0)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(b, h, d)


def decode_attention_tiled(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    fast: bool = False,
    bs: int = DEFAULT_BS,
) -> torch.Tensor:
    """The TPU kernel's online softmax over ``bs``-row tiles of S, in
    order: per tile the masked scores, ``m_new = max(m, max scores)``,
    ``p = exp(scores - m_new)``, ``alpha = exp(m - m_new)``,
    ``l = l·alpha + Σp``, ``acc = acc·alpha + p·V``; then ``acc / l``.
    The last tile may be ragged (the TPU kernel pads it; its padded rows
    are masked, so they add nothing)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    exp = _exp(fast)
    qg = q.reshape(b, hkv, g, d)
    m = torch.full((b, hkv, g, 1), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    lens = lengths[:, None, None, None]
    for s0 in range(0, s, bs):
        kt = k_cache[:, s0:s0 + bs]
        vt = v_cache[:, s0:s0 + bs]
        scores = torch.einsum("bkgd,btkd->bkgt", qg, kt) * scale
        pos = s0 + torch.arange(kt.shape[1], device=q.device)
        valid = pos[None, None, None, :] < lens
        scores = torch.where(valid, scores, float("-inf"))
        m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
        p = torch.where(valid, exp(scores - m_new), 0.0)
        alpha = exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgt,btkd->bkgd", p, vt)
        m = m_new
    return (acc / l).reshape(b, h, d)


def decode_attention_split(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    tiles_per_chunk: int,
    scale: Optional[float] = None,
    fast: bool = False,
    bs: int = DEFAULT_BS,
) -> torch.Tensor:
    """The CUDA kernel's split of :func:`decode_attention_tiled`, in plain
    torch (``csrc/decode_attention.cu``; tests and ``chip_smoke.py`` hold
    the two against each other).  S is cut into chunks of
    ``tiles_per_chunk`` tiles:

    1. the masked scores and each tile's maximum;
    2. per chunk, the running maxima ``m_t`` (a prefix max over every
       tile before), then tile by tile in order the tiled form's
       ``p = exp(s - m_t)`` and ``alpha_t = exp(m_{t-1} - m_t)``, giving
       the chunk's ``l_c``, ``acc_c`` and ``A_c = prod alpha_t``;
    3. ``acc = acc·A_c + acc_c``, ``l = l·A_c + l_c`` in chunk order, then
       ``acc / l``.

    Every p and alpha equals the tiled form's; tiles wholly past a length
    are dropped (the tiled form's ``alpha = exp(0)`` for them cancels in
    ``acc / l``)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    exp = _exp(fast)
    qg = q.reshape(b, hkv, g, d)
    rows = tiles_per_chunk * bs
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        # 1. scores and tile maxima over the valid rows.
        scores = torch.einsum("kgd,tkd->kgt", qg[bi], k_cache[bi, :n]) * scale
        ntiles = -(-n // bs)
        tmax = [torch.amax(scores[..., t * bs:(t + 1) * bs], dim=-1)
                for t in range(ntiles)]
        m_run, m = [], torch.full((hkv, g), float("-inf"), device=q.device)
        for t in range(ntiles):
            m = torch.maximum(m, tmax[t])
            m_run.append(m)
        acc = torch.zeros((hkv, g, d), dtype=torch.float32, device=q.device)
        l = torch.zeros((hkv, g), dtype=torch.float32, device=q.device)
        for c0 in range(0, max(n, 1), rows):
            # 2. one chunk, its tiles in order.
            acc_c = torch.zeros_like(acc)
            l_c, a_c = torch.zeros_like(l), torch.ones_like(l)
            for t in range(c0 // bs, min(-(-(c0 + rows) // bs), ntiles)):
                sc = scores[..., t * bs:(t + 1) * bs]
                vt = v_cache[bi, t * bs:min((t + 1) * bs, n)]
                m_prev = m_run[t - 1] if t else torch.full_like(l, float("-inf"))
                p = exp(sc - m_run[t][..., None])
                alpha = exp(m_prev - m_run[t])
                l_c = l_c * alpha + torch.sum(p, dim=-1)
                acc_c = acc_c * alpha[..., None] + torch.einsum(
                    "kgt,tkd->kgd", p, vt)
                a_c = a_c * alpha
            # 3. combine.
            acc = acc * a_c[..., None] + acc_c
            l = l * a_c + l_c
        out[bi] = acc / l[..., None]
    return out.reshape(b, h, d)
