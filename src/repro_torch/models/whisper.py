"""Whisper-style encoder-decoder (audio backbone; conv front end a stub).

The port of ``repro.models.whisper``.  The modality front end is a stub,
as in the reference: the ``frames`` input holds precomputed frame
embeddings (B, n_frames, D), the output of Whisper's two conv layers,
and the encoder runs the bidirectional transformer on them.  The
decoder is a causal stack with cross-attention; the cross-attention K/V
are computed once at prefill from the encoder output, cached, and
carried unchanged through decode.

Positions are sinusoidal (computed on the fly), LayerNorm with a bias,
non-gated tanh-GELU MLPs, MHA with no RoPE.  Caches are updated in
place, as the transformer's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import common as C


def _sinusoid(positions, d):
    """positions (...,S) -> (...,S,d) sinusoidal embedding; the
    frequencies divide by ``max(1, half - 1)``, as the reference's."""
    half = d // 2
    freq = torch.exp(float(-np.log(10000.0))
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(1, half - 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Plain MHA (LayerNorm models, no RoPE) + standard MLP
# ---------------------------------------------------------------------------
def _mha_init(init: C.Init, lead, cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    n = cfg.n_heads * cfg.head_dim
    return {"wq": C.dense_init(init, (*lead, d, n), d, dt),
            "bq": C.zeros_init(init, (*lead, n), dt),
            "wk": C.dense_init(init, (*lead, d, n), d, dt),
            "wv": C.dense_init(init, (*lead, d, n), d, dt),
            "bv": C.zeros_init(init, (*lead, n), dt),
            "wo": C.dense_init(init, (*lead, n, d), n, dt),
            "bo": C.zeros_init(init, (*lead, d), dt)}


def _mha_axes():
    return {"wq": ("fsdp", "heads"), "bq": ("heads",),
            "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
            "bv": ("heads",), "wo": ("heads", "fsdp"), "bo": (None,)}


def _heads(cfg):
    """This rank's range of the heads' columns where compute is split
    over ``model`` (the mesh train step); else None."""
    from ..distributed.sharding import model_part
    return model_part(cfg.n_heads, cfg.head_dim)


def _proj(p, cfg, x, names):
    """The projections ``names`` (of ``q``, ``k``, ``v``) of ``x``, with
    their biases, each (B, S, heads, hd): the rank's heads where compute
    is split over ``model``."""
    b, s, _ = x.shape
    cols = _heads(cfg)
    bias = {"q": "bq", "v": "bv"}
    outs = C.col_parallel_in(x, [p["w" + n] for n in names],
                             parts=(cols,) * len(names))
    out = []
    for n, t in zip(names, outs):
        if n in bias:
            t = t + C.column_part(p[bias[n]], cols).to(x.dtype)
        out.append(t.reshape(b, s, -1, cfg.head_dim))
    return out


def _proj_kv(p, cfg, src):
    return _proj(p, cfg, src, ("k", "v"))


def _proj_q(p, cfg, x):
    return _proj(p, cfg, x, ("q",))[0]


def _out(p, cfg, o):
    b, s = o.shape[:2]
    o = o.reshape(b, s, -1)
    return (C.row_parallel_out(o, p["wo"], cfg.tp_psum, _heads(cfg))
            + p["bo"].to(o.dtype))


def _mlp_init(init: C.Init, lead, cfg):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"w1": C.dense_init(init, (*lead, d, f), d, dt),
            "b1": C.zeros_init(init, (*lead, f), dt),
            "w2": C.dense_init(init, (*lead, f, d), f, dt),
            "b2": C.zeros_init(init, (*lead, d), dt)}


def _mlp(p, cfg, x):
    """The MLP; where compute is split over ``model`` a rank computes its
    range of the ``mlp`` columns, and the output's bias is added once,
    after the sum over ``model``."""
    from ..distributed.sharding import model_part, whole_dim
    cols = model_part(whole_dim(p["w1"], -1))
    h = C.gelu_tanh(C.col_parallel_in(x, (p["w1"],), parts=(cols,))[0]
                    + C.column_part(p["b1"], cols).to(x.dtype))
    return (C.row_parallel_out(h, p["w2"], cfg.tp_psum, cols)
            + p["b2"].to(x.dtype))


def _mlp_axes():
    return {"w1": ("fsdp", "mlp"), "b1": ("mlp",),
            "w2": ("mlp", "fsdp"), "b2": (None,)}


def _ln_init(init: C.Init, lead, cfg):
    return {"g": C.ones_init(init, (*lead, cfg.d_model), cfg.param_dtype),
            "b": C.zeros_init(init, (*lead, cfg.d_model), cfg.param_dtype)}


def _ln(p, cfg, x):
    return C.layer_norm(x, p["g"], p["b"], cfg.norm_eps)


def _residual_ln(p, cfg, x, h):
    """The residual ``x + h``, rounded to x's dtype, and the LayerNorm of
    the sum taken unrounded (f32), as the reference's XLA program
    computes it: the add fuses into the norm's upcast
    (``transformer._ffn_block``)."""
    s = x.float() + h.float()
    return s.to(x.dtype), _ln(p, cfg, s).to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def init_params(cfg, init: C.Init) -> Dict[str, Any]:
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": C.dense_init(init, (cfg.vocab, cfg.d_model), cfg.d_model,
                              cfg.param_dtype),
        "enc": {"ln1": _ln_init(init, enc, cfg),
                "attn": _mha_init(init, enc, cfg),
                "ln2": _ln_init(init, enc, cfg),
                "mlp": _mlp_init(init, enc, cfg)},
        "enc_ln": _ln_init(init, (), cfg),
        "dec": {"ln1": _ln_init(init, dec, cfg),
                "self": _mha_init(init, dec, cfg),
                "ln2": _ln_init(init, dec, cfg),
                "cross": _mha_init(init, dec, cfg),
                "ln3": _ln_init(init, dec, cfg),
                "mlp": _mlp_init(init, dec, cfg)},
        "dec_ln": _ln_init(init, (), cfg),
    }


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of :func:`init_params`' tree, leaf for leaf."""
    ln = {"g": (None,), "b": (None,)}
    enc = {"ln1": ln, "attn": _mha_axes(), "ln2": ln, "mlp": _mlp_axes()}
    dec = {"ln1": ln, "self": _mha_axes(), "ln2": ln, "cross": _mha_axes(),
           "ln3": ln, "mlp": _mlp_axes()}
    return {"embed": ("vocab", "fsdp"), "enc": C.stack_axes(enc),
            "enc_ln": ln, "dec": C.stack_axes(dec), "dec_ln": ln}


def _stack(params, name, n):
    return enumerate(C.layer_views(params[name], n))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(cfg, params, frames):
    """frames: (B, n_frames, D) precomputed conv-front-end output (stub)."""
    dtype = C.torch_dtype(cfg.dtype)
    s = frames.shape[1]
    pos = torch.arange(s, device=frames.device)
    x = frames.to(dtype) + _sinusoid(pos, cfg.d_model).to(dtype)

    def body(lp, x):
        xn = _ln(lp["ln1"], cfg, x)
        q, k, v = _proj(lp["attn"], cfg, xn, ("q", "k", "v"))
        o = C.chunked_attention(q, k, v, causal=False,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                compute_dtype=cfg.attn_compute_dtype)
        x, xn = _residual_ln(lp["ln2"], cfg, x, _out(lp["attn"], cfg, o))
        return x + _mlp(lp["mlp"], cfg, xn)

    body = C.maybe_remat(cfg, body)
    for _, lp in _stack(params, "enc", cfg.encoder_layers):
        x = body(lp, x)
    return _ln(params["enc_ln"], cfg, x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens, positions):
    dtype = C.torch_dtype(cfg.dtype)
    return (C.embed_tokens(params["embed"], tokens, dtype)
            + _sinusoid(positions, cfg.d_model).to(dtype))


def _decoder_layer(lp, cfg, x, enc, cross_dtype):
    """One decoder layer over the whole sequence: causal self-attention,
    cross-attention over ``enc`` and the MLP.  Returns (x, k, v, xk, xv):
    the self and the cross K/V, for the cache."""
    xn = _ln(lp["ln1"], cfg, x)
    q, k, v = _proj(lp["self"], cfg, xn, ("q", "k", "v"))
    o = C.chunked_attention(q, k, v, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            compute_dtype=cfg.attn_compute_dtype,
                            causal_skip=cfg.causal_skip)
    x, xn = _residual_ln(lp["ln2"], cfg, x, _out(lp["self"], cfg, o))
    q = _proj_q(lp["cross"], cfg, xn)
    xk, xv = _proj_kv(lp["cross"], cfg, enc)
    o = C.chunked_attention(q, xk, xv, causal=False,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            compute_dtype=cross_dtype)
    x, xn = _residual_ln(lp["ln3"], cfg, x, _out(lp["cross"], cfg, o))
    return x + _mlp(lp["mlp"], cfg, xn), k, v, xk, xv


def _logits(cfg, params, x):
    x = _ln(params["dec_ln"], cfg, x)
    return C.lm_logits(x, params["embed"], tied=True)  # whisper ties them


def forward(cfg, params, tokens, frames=None):
    """Teacher-forced pass: (tokens, frames) -> logits."""
    enc = encode(cfg, params, frames)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens, torch.arange(s, device=enc.device))
    body = C.maybe_remat(cfg, lambda lp, x: _decoder_layer(
        lp, cfg, x, enc, cfg.attn_compute_dtype)[0])
    for _, lp in _stack(params, "dec", cfg.num_layers):
        x = body(lp, x)
    return _logits(cfg, params, x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    h, hd, L = cfg.n_heads, cfg.head_dim, cfg.num_layers
    dtype = C.torch_dtype(cfg.dtype)
    z = lambda s: torch.zeros((L, batch, s, h, hd), dtype=dtype,
                              device=device)
    return {"k": z(max_len), "v": z(max_len),
            "xk": z(cfg.n_frames), "xv": z(cfg.n_frames),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_axes(cfg):
    """The logical axes of :func:`init_cache`'s leaves: the self and the
    cross K/V alike, their sequence (frame) dim ``kv_seq``."""
    kv = ("layers", "batch", "kv_seq", "heads", "head_dim")
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ("batch",)}


def _fit(dst, t):
    """The reference's ``fit``: pad a short prompt's rows with zeros, or
    keep the last ``dst.shape[1]`` rows of a long one (no roll)."""
    s, slen = t.shape[1], dst.shape[1]
    if s < slen:
        dst[:, :s].copy_(t)
        dst[:, s:].zero_()
    else:
        dst.copy_(t[:, -slen:])


def prefill(cfg, params, tokens, cache, frames=None):
    """Encode the audio, run the prompt through the decoder, and fill the
    cache (in place) with the self-attention K/V and the
    (encoder-constant) cross-attention K/V.  In the partitioned serving
    program each rank computes its heads' K/V and fills what the cache's
    placement gives it (``common.kv_fill``)."""
    b, s = tokens.shape
    if cache["k"].shape[1] != b:
        raise ValueError(f"the cache holds {cache['k'].shape[1]} rows; "
                         f"the tokens have {b}")
    enc = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens, torch.arange(s, device=enc.device))
    heads = _head_range(cfg)
    for i, lp in _stack(params, "dec", cfg.num_layers):
        # The reference's prefill gives the cross-attention no compute
        # dtype (its default, f32), where its forward passes the config's.
        x, k, v, xk, xv = _decoder_layer(lp, cfg, x, enc, "float32")
        C.kv_fill(cache["k"][i], k, _fit, heads)
        C.kv_fill(cache["v"][i], v, _fit, heads)
        C.kv_fill(cache["xk"][i], xk, _fit, heads)
        C.kv_fill(cache["xv"][i], xv, _fit, heads)
    cache["pos"].fill_(s)
    return _logits(cfg, params, x[:, -1:]), cache


def _head_range(cfg):
    """This rank's range of the heads (units of heads, not columns), or
    None."""
    from ..distributed.sharding import model_part
    return model_part(cfg.n_heads)


def _attend_cache(q, kc, vc, lengths, cfg, heads):
    return C.decode_attention_jnp(q, kc, vc, lengths,
                                  compute_dtype=cfg.attn_compute_dtype,
                                  heads=heads, seq=C.cache_seq(kc))


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) -> (logits (B,1,V), the cache with
    this token's self-attention K/V written in place and ``pos``
    advanced; the cross K/V are read, never written).  In the
    partitioned serving program a rank computes its heads, the caches'
    parts it holds attended as ``transformer.attn_decode`` attends
    them."""
    b = tokens.shape[0]
    pos = cache["pos"]
    x = _embed(cfg, params, tokens, pos[:, None])
    self_len = torch.clamp(pos + 1, max=C.whole_len(cache["k"][0]))
    cross_len = torch.full((b,), C.whole_len(cache["xk"][0]),
                           dtype=torch.int32, device=x.device)
    heads = _head_range(cfg)
    for i, lp in _stack(params, "dec", cfg.num_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        xn = _ln(lp["ln1"], cfg, x)
        q = _proj_q(lp["self"], cfg, xn)
        k, v = _proj_kv(lp["self"], cfg, xn)
        C.kv_insert(kc, k[:, 0], pos, cfg.cache_update, heads)
        C.kv_insert(vc, v[:, 0], pos, cfg.cache_update, heads)
        o = _attend_cache(q[:, 0], kc, vc, self_len, cfg, heads)
        x, xn = _residual_ln(lp["ln2"], cfg, x, _out(lp["self"], cfg,
                                                     o[:, None]))
        q = _proj_q(lp["cross"], cfg, xn)
        o = _attend_cache(q[:, 0], cache["xk"][i], cache["xv"][i],
                          cross_len, cfg, heads)
        x, xn = _residual_ln(lp["ln3"], cfg, x, _out(lp["cross"], cfg,
                                                     o[:, None]))
        x = x + _mlp(lp["mlp"], cfg, xn)
    pos.add_(1)
    return _logits(cfg, params, x), cache
