"""RecurrentGemma hybrid: RG-LRU recurrent blocks + local attention, 2:1.

The port of ``repro.models.rglru``.  Block pattern (Griffin):
(recurrent, recurrent, local-attention) repeated; 38 layers = 12
super-blocks of 3 + 2 trailing recurrent layers.  The super-blocks'
params are stacked on a leading ``nb`` dim, the trailing layers' on a
``tail`` dim, as the reference's; the port loops over them in Python.

The RG-LRU recurrence  h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t)
is evaluated for prefill with a log-depth parallel prefix scan over the
sequence (:func:`associative_scan`, the reference's
``lax.associative_scan``) and as the O(1) update for decode.  The
attention sub-blocks are the transformer's ``attn_apply`` /
``attn_decode`` with ``window=cfg.window`` over a ring cache of at most
``window`` rows.  Caches are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C
from . import transformer as T
from .ssm import softplus

_C_RGLRU = 8.0  # RG-LRU "a" sharpness constant (Griffin paper)


# ---------------------------------------------------------------------------
# The parallel prefix scan
# ---------------------------------------------------------------------------
def associative_scan(combine, elems, dim: int = 1):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``combine``: ``jax.lax.associative_scan``'s odd/even
    recursion, on whole tensors, in O(log S) steps.  Adjacent pairs are
    combined, the half-length sequence is scanned, and the even
    positions are filled in from it; the same operations in the same
    order as the reference's."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(
        combine, combine([sl(e, 0, -1, 2) for e in elems],
                         [sl(e, 1, None, 2) for e in elems]), dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(list(odd), [sl(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        t = torch.empty_like(e)
        sl(t, 0, 1).copy_(sl(e, 0, 1))
        sl(t, 2, None, 2).copy_(ev)
        sl(t, 1, None, 2).copy_(od)
        out.append(t)
    return out


def _lru_combine(c1, c2):
    """(a1, b1) then (a2, b2): h = a2 (a1 h + b1) + b2."""
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, b1 * a2 + b2]


# ---------------------------------------------------------------------------
# RG-LRU temporal-mixing block
# ---------------------------------------------------------------------------
def rec_init(init: C.Init, lead, cfg):
    d, dr = cfg.d_model, cfg.lru_width
    dt = cfg.param_dtype
    return {
        "wx": C.dense_init(init, (*lead, d, dr), d, dt),
        "wy": C.dense_init(init, (*lead, d, dr), d, dt),      # gate branch
        "conv_w": C.dense_init(init, (*lead, cfg.conv_width, dr),
                               cfg.conv_width, dt),
        "conv_b": C.zeros_init(init, (*lead, dr), dt),
        "w_rg": C.dense_init(init, (*lead, dr, dr), dr, dt),  # recurrence gate
        "w_in": C.dense_init(init, (*lead, dr, dr), dr, dt),  # input gate
        "a_param": torch.full((*lead, dr), -1.0, dtype=C.torch_dtype(dt),
                              device=init.device),         # lambda init
        "wo": C.dense_init(init, (*lead, dr, d), dr, dt),
    }


def _sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))``."""
    return 1.0 / (1.0 + torch.exp(-x))


def _gates(p, x, part=None):
    """i gate and log-decay from the conv'd branch x (B,S,dr), in f32.
    ``part``: this rank's range of the channels (``sharding.Part``),
    where compute is split over ``model``: x holds every channel, the
    gates and the decay the rank's."""
    w_rg, w_in, a = (C.column_part(p[n], part) for n in ("w_rg", "w_in",
                                                       "a_param"))
    r = _sigmoid(torch.matmul(x, w_rg.to(x.dtype)).float())
    i = _sigmoid(torch.matmul(x, w_in.to(x.dtype)).float())
    log_a = -_C_RGLRU * softplus(a.float()) * r              # (B,S,dr)
    return i, log_a


def _decay_input(log_a, i_g, xc):
    """a = exp(log_a) and the scaled input sqrt(1 - a²) i x, in f32."""
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), beta * i_g * xc.float()


def rec_apply(p, cfg, x):
    """x: (B,S,D).  Returns (out, (conv_tail, h_final)).  Where compute
    is split over ``model`` a rank runs its range of the ``mlp``
    channels: the conv, the gates' columns and the recurrence are per
    channel; the gates read every channel of the conv's output, gathered
    over ``model``."""
    from ..distributed.sharding import model_part
    part = model_part(cfg.lru_width)
    s = x.shape[1]
    xb, gate = C.col_parallel_in(x, (p["wx"], p["wy"]), parts=(part, part))
    gate = C.gelu_tanh(gate)
    k = cfg.conv_width
    tail = F.pad(xb[:, -(k - 1):], (0, 0, max(0, k - 1 - s), 0))
    conv_w, conv_b = (C.column_part(p[n], part) for n in ("conv_w", "conv_b"))
    # causal depthwise conv
    padded = F.pad(xb, (0, 0, k - 1, 0))
    xc = padded[:, 0:s] * conv_w[0].to(xb.dtype)
    for i in range(1, k):
        xc = xc + padded[:, i:i + s] * conv_w[i].to(xb.dtype)
    xc = xc + conv_b.to(xb.dtype)

    every = xc
    if part is not None:
        from ..dist.collectives import gather_part
        from ..distributed.sharding import current_mesh
        every = gather_part(xc, ("model",), current_mesh(), -1,
                            cfg.lru_width)
    i_g, log_a = _gates(p, every, part)
    a, bx = _decay_input(log_a, i_g, xc)
    # h_t = a_t h_{t-1} + bx_t  via the parallel prefix scan.
    _, h = associative_scan(_lru_combine, [a, bx], dim=1)
    y = h.to(x.dtype) * gate
    return (C.row_parallel_out(y, p["wo"], cfg.tp_psum, part),
            (tail, h[:, -1]))


def rec_decode(p, cfg, x, conv_tail, h):
    """One-step recurrent update.  x (B,1,D); conv_tail (B,K-1,dr);
    h (B,dr) f32.  Returns (out, new tail, new h).  Where compute is
    split over ``model`` (the partitioned serving program) a rank runs
    its range of the channels, as :func:`rec_apply` does: conv_tail and
    h are then its channels (``common.read_channels``), and so are the
    new tail and h."""
    from ..distributed.sharding import model_part
    part = model_part(cfg.lru_width)
    xb, gate = C.col_parallel_in(x, (p["wx"], p["wy"]), parts=(part, part))
    gate = C.gelu_tanh(gate)
    conv_w, conv_b = (C.column_part(p[n], part) for n in ("conv_w", "conv_b"))
    window = torch.cat([conv_tail.to(xb.dtype), xb], dim=1)
    xc = (torch.einsum("bkr,kr->br", window.float(), conv_w.float())
          + conv_b.float())[:, None]                       # (B,1,dr)
    every = xc
    if part is not None:
        from ..dist.collectives import gather_part
        from ..distributed.sharding import current_mesh
        every = gather_part(xc, ("model",), current_mesh(), -1,
                            cfg.lru_width)
    i_g, log_a = _gates(p, every, part)
    a, bx = _decay_input(log_a[:, 0], i_g[:, 0], xc[:, 0])
    h = a * h + bx
    y = h[:, None].to(x.dtype) * gate
    return (C.row_parallel_out(y, p["wo"], part is not None and cfg.tp_psum,
                               part), window[:, 1:], h)


# ---------------------------------------------------------------------------
# Super-block assembly:  [rec, rec, local-attn] × n  + trailing recs
# ---------------------------------------------------------------------------
def _sub_init(init: C.Init, lead, cfg, kind):
    dt = cfg.param_dtype
    mixer = (rec_init(init, lead, cfg) if kind == "rec"
             else T.attn_init(init, lead, cfg))
    return {"ln1": C.zeros_init(init, (*lead, cfg.d_model), dt),
            "ln2": C.zeros_init(init, (*lead, cfg.d_model), dt),
            "mixer": mixer,
            "ffn": C.mlp_init(init, lead, cfg.d_model, cfg.d_ff, dt)}


def rec_axes(cfg):
    """Logical axes of :func:`rec_init`'s params (per layer)."""
    return {"wx": ("fsdp", "mlp"), "wy": ("fsdp", "mlp"),
            "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "w_rg": ("fsdp", "mlp"), "w_in": ("fsdp", "mlp"),
            "a_param": ("mlp",), "wo": ("mlp", "fsdp")}


def _sub_axes(cfg, kind):
    return {"ln1": (None,), "ln2": (None,),
            "mixer": rec_axes(cfg) if kind == "rec" else T.attn_axes(cfg),
            "ffn": C.mlp_axes()}


def n_superblocks(cfg) -> Tuple[int, int]:
    nb = cfg.num_layers // 3
    return nb, cfg.num_layers - nb * 3


def init_params(cfg, init: C.Init) -> Dict[str, Any]:
    nb, tail = n_superblocks(cfg)
    p = {
        "embed": C.dense_init(init, (cfg.vocab, cfg.d_model), cfg.d_model,
                              cfg.param_dtype),
        "blocks": {"rec0": _sub_init(init, (nb,), cfg, "rec"),
                   "rec1": _sub_init(init, (nb,), cfg, "rec"),
                   "attn": _sub_init(init, (nb,), cfg, "attn")},
        "ln_f": C.zeros_init(init, (cfg.d_model,), cfg.param_dtype),
    }
    if tail:
        p["tail"] = _sub_init(init, (tail,), cfg, "rec")
    return p


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of :func:`init_params`' tree, leaf for leaf."""
    nb, tail = n_superblocks(cfg)
    block = {"rec0": _sub_axes(cfg, "rec"), "rec1": _sub_axes(cfg, "rec"),
             "attn": _sub_axes(cfg, "attn")}
    p = {"embed": ("vocab", "fsdp"), "blocks": C.stack_axes(block),
         "ln_f": (None,)}
    if tail:
        p["tail"] = C.stack_axes(_sub_axes(cfg, "rec"))
    return p


def _mlp_block(p, cfg, x, h):
    """The residual ``x + h`` and the MLP sub-block after it.  The sum
    enters the norm unrounded (f32), as the reference's XLA program
    computes it (the add fuses into the norm's upcast); the residual
    stream itself is rounded (``transformer._ffn_block``)."""
    x1 = x.float() + h.float()
    f = p["ffn"]
    y = C.gated_mlp(C.rms_norm(x1, p["ln2"], cfg.norm_eps).to(x.dtype),
                    f["wi_gate"], f["wi_up"], f["wo"], act=cfg.mlp_act,
                    tp_psum=cfg.tp_psum)
    return x1.to(x.dtype) + y


def _rec_sub(p, cfg, x):
    h, caches = rec_apply(p["mixer"], cfg,
                          C.rms_norm(x, p["ln1"], cfg.norm_eps))
    return _mlp_block(p, cfg, x, h), caches


def _attn_sub(p, cfg, x, positions):
    h, kv = T.attn_apply(p["mixer"], cfg,
                         C.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions, cfg.window)
    return _mlp_block(p, cfg, x, h), kv


def _embed(cfg, params, tokens):
    dtype = C.torch_dtype(cfg.dtype)
    x = C.embed_tokens(params["embed"], tokens, dtype)
    if cfg.scale_embed:
        x = x * C.rounded(np.sqrt(cfg.d_model), dtype)
    return x


def _head(cfg, params, x):
    x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = C.lm_logits(x, params["embed"], tied=True)  # tied embeddings
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _blocks(cfg, params):
    return enumerate(C.layer_views(params["blocks"], n_superblocks(cfg)[0]))


def _tail(cfg, params):
    tail = n_superblocks(cfg)[1]
    return enumerate(C.layer_views(params["tail"], tail) if tail else [])


def forward(cfg, params, tokens, patches=None):
    x = _embed(cfg, params, tokens)
    positions = T._positions(tokens.shape[1], x.device)

    def block(bp, x):
        x, _ = _rec_sub(bp["rec0"], cfg, x)
        x, _ = _rec_sub(bp["rec1"], cfg, x)
        return _attn_sub(bp["attn"], cfg, x, positions)[0]

    block = C.maybe_remat(cfg, block)
    tail = C.maybe_remat(cfg, lambda lp, x: _rec_sub(lp, cfg, x)[0])
    for _, bp in _blocks(cfg, params):
        x = block(bp, x)
    for _, lp in _tail(cfg, params):
        x = tail(lp, x)
    return _head(cfg, params, x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    nb, tail = n_superblocks(cfg)
    dr, k = cfg.lru_width, cfg.conv_width
    s = min(max_len, cfg.window)                 # attn layers are local-only
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dtype, f32 = C.torch_dtype(cfg.dtype), torch.float32
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    cache = {
        "rec_conv": z((nb, 2, batch, k - 1, dr), dtype),
        "rec_h": z((nb, 2, batch, dr), f32),
        "attn_k": z((nb, batch, s, hkv, hd), dtype),
        "attn_v": z((nb, batch, s, hkv, hd), dtype),
        "pos": z((batch,), torch.int32),
    }
    if tail:
        cache["tail_conv"] = z((tail, batch, k - 1, dr), dtype)
        cache["tail_h"] = z((tail, batch, dr), f32)
    return cache


def cache_axes(cfg):
    """The logical axes of :func:`init_cache`'s leaves: the recurrent
    leaves carry the batch on axis 2, after the block's two recs."""
    nb, tail = n_superblocks(cfg)
    axes = {
        "rec_conv": ("layers", None, "batch", None, "mlp"),
        "rec_h": ("layers", None, "batch", "mlp"),
        "attn_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "attn_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "pos": ("batch",),
    }
    if tail:
        axes["tail_conv"] = ("layers", "batch", None, "mlp")
        axes["tail_h"] = ("layers", "batch", "mlp")
    return axes


def _check_batch(cache, b):
    if cache["rec_h"].shape[2] != b:
        raise ValueError(f"the cache holds {cache['rec_h'].shape[2]} rows; "
                         f"the tokens have {b}")


def _channels(cfg):
    """This rank's range of the RG-LRU's channels where compute is split
    over ``model``, else None."""
    from ..distributed.sharding import model_part
    return model_part(cfg.lru_width)


def prefill(cfg, params, tokens, cache, patches=None):
    """Run the prompt, fill the cache (in place: the attention layers'
    last ``window`` K/V rows ring-aligned), return last-position logits
    and the cache.  In the partitioned serving program the recurrent
    state holds the rank's channels where the placement cuts them
    (``mlp`` over ``model``; ``common.store_channels``) and the
    attention cache is filled as ``transformer.prefill`` fills it."""
    b, s = tokens.shape
    _check_batch(cache, b)
    x = _embed(cfg, params, tokens)
    positions = T._positions(s, x.device)
    part = _channels(cfg)
    parts = T.head_parts(cfg)
    heads = None if parts is None else parts[0]
    for j, bp in _blocks(cfg, params):
        for r, name in enumerate(("rec0", "rec1")):
            x, (ct, h) = _rec_sub(bp[name], cfg, x)
            C.store_channels(cache["rec_conv"][j, r], ct, part)
            C.store_channels(cache["rec_h"][j, r], h, part)
        x, (k, v) = _attn_sub(bp["attn"], cfg, x, positions)
        C.kv_fill(cache["attn_k"][j], k, T._fit_into, heads)
        C.kv_fill(cache["attn_v"][j], v, T._fit_into, heads)
    for j, lp in _tail(cfg, params):
        x, (ct, h) = _rec_sub(lp, cfg, x)
        C.store_channels(cache["tail_conv"][j], ct, part)
        C.store_channels(cache["tail_h"][j], h, part)
    cache["pos"].fill_(s)
    return _head(cfg, params, x[:, -1:]), cache


def _rec_step(p, cfg, x, conv, h):
    """One recurrent sub-block's decode step; ``conv`` and ``h`` (cache
    views) are rewritten in place (their rank's channels where compute
    is split over ``model``)."""
    part = _channels(cfg)
    out, new_conv, new_h = rec_decode(p["mixer"], cfg,
                                      C.rms_norm(x, p["ln1"], cfg.norm_eps),
                                      C.read_channels(conv, part),
                                      C.read_channels(h, part))
    C.store_channels(conv, new_conv, part)
    C.store_channels(h, new_h, part)
    return _mlp_block(p, cfg, x, out)


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) -> (logits (B,1,V), the cache with
    each layer's state and this token's K/V written in place and ``pos``
    advanced)."""
    _check_batch(cache, tokens.shape[0])
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    for j, bp in _blocks(cfg, params):
        for r, name in enumerate(("rec0", "rec1")):
            x = _rec_step(bp[name], cfg, x, cache["rec_conv"][j, r],
                          cache["rec_h"][j, r])
        ap = bp["attn"]
        ao, _ = T.attn_decode(ap["mixer"], cfg,
                              C.rms_norm(x, ap["ln1"], cfg.norm_eps),
                              cache["attn_k"][j], cache["attn_v"][j], pos,
                              cfg.window)
        x = _mlp_block(ap, cfg, x, ao)
    for j, lp in _tail(cfg, params):
        x = _rec_step(lp, cfg, x, cache["tail_conv"][j], cache["tail_h"][j])
    pos.add_(1)
    return _head(cfg, params, x), cache
