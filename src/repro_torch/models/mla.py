"""Multi-head Latent Attention (DeepSeek-V3).

The port of ``repro.models.mla``.  MLA compresses K/V into a small
latent ``c_kv`` (plus a shared RoPE key) and re-expands per head:

* **prefill/forward** — naive expansion: k/v materialized per head and
  fed to the shared chunked attention;
* **decode** — the *absorbed* form: ``W_UK`` folded into the query and
  ``W_UV`` into the output, in f32, so attention runs in the latent
  space and the cache stores only the latent.

Cache slices (4-D to match the generic transformer cache):
    c_kv   (B, S, 1, kv_rank)
    k_rope (B, S, 1, rope_dim)
"""

from __future__ import annotations

import torch

from . import common as C


def mla_init(init: C.Init, lead, cfg):
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    return {
        "q_down": C.dense_init(init, (*lead, d, qr), d, dt),
        "q_norm": C.zeros_init(init, (*lead, qr), dt),
        "q_up": C.dense_init(init, (*lead, qr, h * (dn + dr)), qr, dt),
        "kv_down": C.dense_init(init, (*lead, d, kvr + dr), d, dt),
        "kv_norm": C.zeros_init(init, (*lead, kvr), dt),
        "k_up": C.dense_init(init, (*lead, kvr, h * dn), kvr, dt),
        "v_up": C.dense_init(init, (*lead, kvr, h * dv), kvr, dt),
        "wo": C.dense_init(init, (*lead, h * dv, d), h * dv, dt),
    }


def mla_axes(cfg):
    """Logical axes of :func:`mla_init`'s params (per layer)."""
    return {
        "q_down": ("fsdp", None),
        "q_norm": (None,),
        "q_up": (None, "heads"),
        "kv_down": ("fsdp", None),
        "kv_norm": (None,),
        "k_up": (None, "heads"),
        "v_up": (None, "heads"),
        "wo": ("heads", "fsdp"),
    }


def _latent(p, cfg, x, positions, heads=None):
    """Shared front: queries (nope+rope) and the compressed KV latent.
    ``heads``: this rank's range of heads (``sharding.Part``) where
    compute is split over ``model``; the down projections, their norms
    and the shared rope key stay whole."""
    b, s, _ = x.shape
    h = cfg.n_heads if heads is None else heads.size
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.matmul(x, p["q_down"].to(x.dtype))
    q = C.rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = C.col_parallel_in(q, (p["q_up"],), parts=(
        None if heads is None else heads.times(dn + dr),))[0]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = C.apply_rope(q_rope, positions, cfg.rope_theta)

    ckr = torch.matmul(x, p["kv_down"].to(x.dtype))
    c_kv = C.rms_norm(ckr[..., :cfg.kv_lora_rank], p["kv_norm"],
                      cfg.norm_eps)
    k_rope = C.apply_rope(ckr[..., None, cfg.kv_lora_rank:], positions,
                          cfg.rope_theta)          # (B,S,1,dr), shared
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, cfg, x, positions, window):
    """Full-sequence form: expand K/V per head, run chunked attention.
    Returns (out, (c_kv_4d, k_rope_4d)) cache slices.  Where compute is
    split over ``model`` a rank expands, attends and projects out its
    range of the heads."""
    from ..distributed.sharding import model_part
    b, s, _ = x.shape
    heads = model_part(cfg.n_heads)
    h = cfg.n_heads if heads is None else heads.size
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _latent(p, cfg, x, positions, heads)

    cols = (None, None) if heads is None else (heads.times(dn),
                                               heads.times(dv))
    k_nope, v = C.col_parallel_in(c_kv, (p["k_up"], p["v_up"]), parts=cols)
    k_nope = k_nope.reshape(b, s, h, dn)
    v = v.reshape(b, s, h, dv)
    k = torch.cat([k_nope, C.shared_part(k_rope).expand(b, s, h, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)

    out = C.chunked_attention(
        q, k, v, causal=True, window_arr=window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        scale=(dn + dr) ** -0.5,
        compute_dtype=cfg.attn_compute_dtype,
        causal_skip=cfg.causal_skip)
    out = out.reshape(b, s, h * dv)
    y = C.row_parallel_out(out, p["wo"], cfg.tp_psum, cols[1])
    return y, (c_kv[:, :, None, :], k_rope)


def mla_decode(p, cfg, x, c_cache, r_cache, lengths, window):
    """Absorbed decode: x (B,1,D); c_cache (B,S,1,kvr); r_cache
    (B,S,1,dr), both written in place; lengths (B,) tokens already
    cached.  Where compute is split over ``model`` (the partitioned
    serving program) a rank absorbs and projects out its range of the
    heads; the latent, computed whole on every rank, goes into the
    rank's part of the cache, which is attended in the flash-decoding
    form (``common.decode_attention_jnp``)."""
    from ..distributed.sharding import model_part
    b = x.shape[0]
    heads = model_part(cfg.n_heads)
    h = cfg.n_heads if heads is None else heads.size
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    dr = cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    positions = lengths[:, None]
    q_nope, q_rope, c_kv, k_rope = _latent(p, cfg, x, positions, heads)

    # Insert the new latent at each sequence's slot.
    C.ring_insert(c_cache, c_kv[:, 0, None, :], lengths, cfg.cache_update)
    C.ring_insert(r_cache, k_rope[:, 0], lengths, cfg.cache_update)

    # Absorb W_UK into q: q_abs = q_nope @ W_UK^T  -> latent space.
    k_up = C.column_part(p["k_up"], None if heads is None
                         else heads.times(dn))
    k_up = k_up.float().reshape(kvr, h, dn)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), k_up)
    q_full = torch.cat([q_abs, q_rope[:, 0].float()], dim=-1)  # (B,H,kvr+dr)
    kv_full = torch.cat([c_cache[:, :, 0], r_cache[:, :, 0]],
                        dim=-1)                              # (B,S,kvr+dr)
    out_lat = C.decode_attention_jnp(
        q_full.to(x.dtype), kv_full[:, :, None, :],
        c_cache[:, :, 0][:, :, None, :], lengths + 1,
        window_arr=window, scale=(dn + dr) ** -0.5,
        compute_dtype=cfg.attn_compute_dtype, heads=heads,
        seq=C.cache_seq(c_cache))                            # (B,H,kvr)

    # Absorb W_UV into the output projection.
    cols = None if heads is None else heads.times(dv)
    v_up = C.column_part(p["v_up"], cols).float().reshape(kvr, h, dv)
    out = torch.einsum("bhr,rhd->bhd", out_lat.float(), v_up)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    y = C.row_parallel_out(out, p["wo"], cfg.tp_psum, cols)
    return y, (c_cache, r_cache)
