"""Decoder-only transformer assembly.

The port of ``repro.models.transformer``: the dense archs (qwen2.5,
deepseek-7b, gemma3, minicpm, the internvl2 LM backbone) and, through
the MoE and MLA modules, the MoE archs (mixtral, deepseek-v3).

Per-layer params are stacked on a leading ``L`` dim, as the reference's.
Where the reference scans one layer body with ``lax.scan``, the port
loops over the layers in Python with a view of each layer's params and
cache; the per-layer window (gemma3's 5:1 local:global, mixtral's SWA)
is a host int from :func:`layer_windows`.

KV caches are ring buffers: when every layer is sliding-window
(mixtral), the cache holds only the window and the ring overwrite is the
eviction; otherwise it covers the whole context and local layers mask by
window.  ``cache["pos"]`` counts absolute tokens per batch row (int32).
The cache is updated in place: ``prefill`` fills the cache it is given
(the reference builds a new one of the same shape and ignores the old
contents) and ``decode_step``/``prefill_chunk`` write their rows into
it, so the cache passed in is the cache returned (the reference's
engine donates it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import common as C
from . import mla as mla_mod
from . import moe as moe_mod


# ---------------------------------------------------------------------------
# Per-layer static window pattern
# ---------------------------------------------------------------------------
def layer_windows(cfg) -> np.ndarray:
    """Per-layer sliding-window width; 0 = global attention."""
    L = cfg.num_layers
    if cfg.pattern == "gemma3":            # 5 local : 1 global
        w = [0 if (i + 1) % 6 == 0 else cfg.window for i in range(L)]
    elif cfg.pattern == "swa":             # all layers sliding-window
        w = [cfg.window] * L
    else:                                   # all global
        w = [0] * L
    return np.asarray(w, np.int32)


def cache_len(cfg, max_len: int) -> int:
    """Ring caches allocate only the window when no layer is global."""
    w = layer_windows(cfg)
    if (w == 0).any():
        return max_len
    return min(max_len, int(w.max()))


def _ring(cfg) -> bool:
    """All-local models get a ring cache: eviction is the overwrite, so
    decode needs no window mask (a static property of the config)."""
    return bool((layer_windows(cfg) > 0).all())


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attn_init(init: C.Init, lead, cfg):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": C.dense_init(init, (*lead, d, h * hd), d, dt),
        "wk": C.dense_init(init, (*lead, d, hkv * hd), d, dt),
        "wv": C.dense_init(init, (*lead, d, hkv * hd), d, dt),
        "wo": C.dense_init(init, (*lead, h * hd, d), h * hd, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = C.zeros_init(init, (*lead, h * hd), dt)
        p["bk"] = C.zeros_init(init, (*lead, hkv * hd), dt)
        p["bv"] = C.zeros_init(init, (*lead, hkv * hd), dt)
    if cfg.qk_norm:
        p["q_norm"] = C.zeros_init(init, (*lead, hd), dt)
        p["k_norm"] = C.zeros_init(init, (*lead, hd), dt)
    return p


def _qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = C.col_parallel_in(x, (p["wq"], p["wk"], p["wv"]))
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(x.dtype), k + p["bk"].to(x.dtype),
                   v + p["bv"].to(x.dtype))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = C.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = C.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(p, cfg, q, k, v, window, q_offset=0):
    b, s = q.shape[:2]
    out = C.chunked_attention(
        q, k, v, causal=True, window_arr=window, q_offset=q_offset,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
        compute_dtype=cfg.attn_compute_dtype,
        causal_skip=cfg.causal_skip)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return C.row_parallel_out(out, p["wo"])


def attn_apply(p, cfg, x, positions, window):
    """Full-sequence attention; window is a host int (0 = global).
    Returns (out, (k, v)) — the cache slices for this layer."""
    q, k, v = _qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v, window), (k, v)


def attn_decode(p, cfg, x, k_cache, v_cache, pos, window):
    """One-token decode; x (B,1,D), caches (B,S,Hkv,D) written in place,
    pos (B,)."""
    b = x.shape[0]
    s_cache = k_cache.shape[1]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    C.ring_insert(k_cache, k[:, 0], pos, cfg.cache_update)
    C.ring_insert(v_cache, v[:, 0], pos, cfg.cache_update)
    eff_len = torch.clamp(pos + 1, max=s_cache)
    out = C.decode_attention_jnp(
        q[:, 0], k_cache, v_cache, eff_len,
        window_arr=None if _ring(cfg) else window,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
        compute_dtype=cfg.attn_compute_dtype)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return C.row_parallel_out(out, p["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# One decoder layer
# ---------------------------------------------------------------------------
def layer_init(init: C.Init, lead, cfg):
    dt = cfg.param_dtype
    return {
        "ln1": C.zeros_init(init, (*lead, cfg.d_model), dt),
        "ln2": C.zeros_init(init, (*lead, cfg.d_model), dt),
        "attn": (mla_mod.mla_init if cfg.mla else attn_init)(init, lead, cfg),
        "ffn": (moe_mod.moe_init(init, lead, cfg) if cfg.n_experts
                else C.mlp_init(init, lead, cfg.d_model, cfg.d_ff, dt)),
    }


def _ffn(p, cfg, x):
    if cfg.n_experts:
        return moe_mod.moe_apply(p, cfg, x)
    return (C.gated_mlp(x, p["wi_gate"], p["wi_up"], p["wo"],
                        act=cfg.mlp_act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn_block(p, cfg, x, h):
    """The residual ``x + h`` and the FFN block after it: (out, aux).  The
    sum enters the second norm unrounded (f32), as the reference's XLA
    program computes it: XLA fuses the add into the norm and, with excess
    precision allowed, drops the round trip through the compute dtype;
    the residual stream itself is rounded.  Rounding the norm's input
    too would move the MoE router's input by an ulp, which can flip a
    near-tie between two experts."""
    x1 = x.float() + h.float()
    y, aux = _ffn(p["ffn"], cfg,
                  C.rms_norm(x1, p["ln2"], cfg.norm_eps).to(x.dtype))
    return x1.to(x.dtype) + y, aux


def layer_apply(p, cfg, x, positions, window):
    flavor = mla_mod.mla_apply if cfg.mla else attn_apply
    h, slices = flavor(p["attn"], cfg, C.rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions, window)
    x, aux = _ffn_block(p, cfg, x, h)
    return x, slices, aux


def layer_decode(p, cfg, x, c1, c2, pos, window):
    flavor = mla_mod.mla_decode if cfg.mla else attn_decode
    h, _ = flavor(p["attn"], cfg, C.rms_norm(x, p["ln1"], cfg.norm_eps),
                  c1, c2, pos, window)
    return _ffn_block(p, cfg, x, h)[0]


def _layers(cfg, params):
    """(layer i's param views, its window) for every layer, in order."""
    windows = layer_windows(cfg)
    for i in range(cfg.num_layers):
        yield i, C.layer_view(params["layers"], i), int(windows[i])


# ---------------------------------------------------------------------------
# Whole model: params
# ---------------------------------------------------------------------------
def init_params(cfg, init: C.Init) -> Dict[str, Any]:
    dt = cfg.param_dtype
    p = {
        "embed": C.dense_init(init, (cfg.vocab, cfg.d_model), cfg.d_model,
                              dt),
        "layers": layer_init(init, (cfg.num_layers,), cfg),
        "ln_f": C.zeros_init(init, (cfg.d_model,), dt),
    }
    if not cfg.tie_embeddings:
        p["head"] = C.dense_init(init, (cfg.d_model, cfg.vocab),
                                 cfg.d_model, dt)
    if cfg.mtp:
        p["mtp"] = {
            "proj": C.dense_init(init, (2 * cfg.d_model, cfg.d_model),
                                 2 * cfg.d_model, dt),
            "block": layer_init(init, (), cfg),
            "ln": C.zeros_init(init, (cfg.d_model,), dt),
        }
    if cfg.num_image_tokens:
        p["img_proj"] = C.dense_init(init, (cfg.vit_dim, cfg.d_model),
                                     cfg.vit_dim, dt)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _embed_in(cfg, params, tokens, patches=None):
    dtype = C.torch_dtype(cfg.dtype)
    x = C.embed_tokens(params["embed"], tokens, dtype)
    if cfg.scale_embed:
        x = x * C.rounded(np.sqrt(cfg.d_model), dtype)
    if cfg.num_image_tokens and patches is not None:
        img = torch.matmul(torch.as_tensor(patches, device=x.device).to(dtype),
                           params["img_proj"].to(dtype))
        x = torch.cat([img, x[:, cfg.num_image_tokens:]], dim=1)
    return x


def _head(cfg, params, x):
    x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = C.lm_logits(x, head)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _positions(s, device, start=0):
    return (start + torch.arange(s, dtype=torch.int32, device=device))[None, :]


def forward(cfg, params, tokens, patches=None):
    """Forward: tokens (B,S) -> (logits (B,S,V), extras)."""
    s = tokens.shape[1]
    x = _embed_in(cfg, params, tokens, patches)
    positions = _positions(s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, lp, w in _layers(cfg, params):
        x, _, a = layer_apply(lp, cfg, x, positions, w)
        aux = aux + a
    logits = _head(cfg, params, x)
    extras = {"aux_loss": aux * cfg.moe_aux_alpha}
    if cfg.mtp:
        extras["mtp_hidden"] = x
    return logits, extras


def mtp_logits(cfg, params, hidden, tokens):
    raise NotImplementedError(
        "the multi-token-prediction head's logits serve training, which is "
        "not ported yet (ROADMAP A.15: training)")


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    s = cache_len(cfg, max_len)
    L = cfg.num_layers
    if cfg.mla:
        shapes = ((batch, s, 1, cfg.kv_lora_rank),
                  (batch, s, 1, cfg.qk_rope_dim))
    else:
        shapes = ((batch, s, cfg.n_kv_heads, cfg.head_dim),) * 2
    dtype = C.torch_dtype(cfg.dtype)
    return {
        "c1": torch.zeros((L,) + shapes[0], dtype=dtype, device=device),
        "c2": torch.zeros((L,) + shapes[1], dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _check_batch(cache, b):
    if cache["c1"].shape[1] != b:
        raise ValueError(f"the cache holds {cache['c1'].shape[1]} rows; "
                         f"the tokens have {b}")


def _fit_into(dst, t):
    """Store the last ``dst.shape[1]`` positions of ``t``, ring-aligned."""
    s, slen = t.shape[1], dst.shape[1]
    if s > slen:
        dst.copy_(torch.roll(t[:, -slen:], shifts=s % slen, dims=1))
    elif s < slen:
        dst[:, :s].copy_(t)
        dst[:, s:].zero_()
    else:
        dst.copy_(t)


def prefill(cfg, params, tokens, cache, patches=None):
    """Run the prompt, fill the cache (in place), return last-position
    logits and the cache."""
    b, s = tokens.shape
    _check_batch(cache, b)
    x = _embed_in(cfg, params, tokens, patches)
    positions = _positions(s, x.device)
    for i, lp, w in _layers(cfg, params):
        x, (c1, c2), _ = layer_apply(lp, cfg, x, positions, w)
        _fit_into(cache["c1"][i], c1)
        _fit_into(cache["c2"][i], c2)
    cache["pos"].fill_(s)
    return _head(cfg, params, x[:, -1:]), cache


def attn_chunk(p, cfg, x, k_cache, v_cache, positions, window, start):
    """Prefill one chunk against an existing cache: write the chunk's
    K/V into rows ``[start, start+C)`` (in place) and attend the chunk's
    queries over the cache prefix plus the chunk itself (``q_offset``
    keeps the causal/window masks absolute)."""
    c = x.shape[1]
    q, k, v = _qkv(p, cfg, x, positions)
    k_cache[:, start:start + c] = k.to(k_cache.dtype)
    v_cache[:, start:start + c] = v.to(v_cache.dtype)
    return _attend(p, cfg, q, k_cache, v_cache, window, q_offset=start), \
        (k_cache, v_cache)


def layer_chunk(p, cfg, x, c1, c2, positions, window, start):
    """One decoder layer over a prefill chunk."""
    h, _ = attn_chunk(p["attn"], cfg, C.rms_norm(x, p["ln1"], cfg.norm_eps),
                      c1, c2, positions, window, start)
    return _ffn_block(p, cfg, x, h)[0]


def prefill_chunk(cfg, params, tokens, cache, start, length):
    """Incremental prefill: process ``length`` (<= C) prompt tokens at
    absolute positions ``[start, start+length)`` against an existing
    cache.  ``tokens`` is a fixed-size (B, C) chunk (pad beyond
    ``length``).  Returns the logits of the last real token and the
    cache (``pos = start+length``), equal to the same positions of one
    full-sequence ``prefill``: the chunk's queries see the same keys in
    the same chunks, the earlier chunks' K/V at their absolute rows.

    Requires a full-context cache (``cache_len == max_len``): with a ring
    the chunk's absolute rows would alias.  MLA caches hold latents, not
    K/V, and are not supported (as in the reference).  Where the
    reference clamps a chunk that runs past the cache's end, this
    raises."""
    if cfg.mla:
        raise NotImplementedError(
            "chunked prefill is not supported for MLA caches")
    b, c = tokens.shape
    start, length = int(start), int(length)
    _check_batch(cache, b)
    if not 0 <= start <= cache["c1"].shape[2] - c or not 0 < length <= c:
        raise ValueError(f"chunk [{start}, {start + c}) with length "
                         f"{length} does not fit a cache of "
                         f"{cache['c1'].shape[2]} rows")
    x = _embed_in(cfg, params, tokens)
    positions = _positions(c, x.device, start)
    for i, lp, w in _layers(cfg, params):
        x = layer_chunk(lp, cfg, x, cache["c1"][i], cache["c2"][i],
                        positions, w, start)
    cache["pos"].fill_(start + length)
    return _head(cfg, params, x[:, length - 1:length]), cache


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) -> (logits (B,1,V), the cache with
    this token's K/V written in place and ``pos`` advanced)."""
    _check_batch(cache, tokens.shape[0])
    x = _embed_in(cfg, params, tokens)
    pos = cache["pos"]
    for i, lp, w in _layers(cfg, params):
        x = layer_decode(lp, cfg, x, cache["c1"][i], cache["c2"][i], pos, w)
    pos.add_(1)
    return _head(cfg, params, x), cache
