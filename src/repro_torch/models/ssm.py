"""Mamba-2 (SSD — state-space duality) blocks.

The port of ``repro.models.ssm``.  The SSD algorithm computes the
selective-SSM recurrence

    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)      y_t = C_t · h_t + D x_t

in chunked matmul form: intra-chunk terms are (Q×Q) masked products and
inter-chunk states are carried by a short loop over the S/Q chunks (the
reference's ``lax.scan``), on whole tensors, never over tokens.  Decode
is the O(1)-state recurrent update.

Shapes: d_inner = expand * d_model, nheads = d_inner / head_dim, B/C
shared across heads (ngroups = 1).  The state is ``(b, nh, ds, dh)``,
as the reference's.  Caches are updated in place, as the transformer's:
``prefill`` fills the cache it is given and ``decode_step`` writes the
new conv tail and state into it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import common as C


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def ssm_init(init: C.Init, lead, cfg):
    d = cfg.d_model
    di, nh, ds = d_inner(cfg), n_heads(cfg), cfg.ssm_state
    conv_dim = di + 2 * ds                      # x + B + C share the conv
    dt = cfg.param_dtype
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=init.device))
    return {
        # in_proj emits [z (di), x+B+C (conv_dim), dt (nh)]
        "in_proj": C.dense_init(init, (*lead, d, di + conv_dim + nh), d, dt),
        "conv_w": C.dense_init(init, (*lead, cfg.ssm_conv, conv_dim),
                               cfg.ssm_conv, dt),
        "conv_b": C.zeros_init(init, (*lead, conv_dim), dt),
        "a_log": a_log.to(C.torch_dtype(dt)).expand(*lead, nh).clone(),
        "dt_bias": C.zeros_init(init, (*lead, nh), dt),
        "d_skip": C.ones_init(init, (*lead, nh), dt),
        "norm": C.zeros_init(init, (*lead, di), dt),
        "out_proj": C.dense_init(init, (*lead, di, d), di, dt),
    }


def ssm_axes(cfg):
    """Logical axes of :func:`ssm_init`'s params (per layer)."""
    return {
        "in_proj": ("fsdp", "mlp"),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "a_log": (None,),
        "dt_bias": (None,),
        "d_skip": (None,),
        "norm": ("mlp",),
        "out_proj": ("mlp", "fsdp"),
    }


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` for every x (torch's softplus
    returns x itself above its threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split_proj(cfg, zxbcdt):
    di, ds = d_inner(cfg), cfg.ssm_state
    conv_dim = di + 2 * ds
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d, width K: y_t = sum_k w_k * x_{t-K+1+k},
    in xbc's dtype."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    y = pad[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, k):
        y = y + pad[:, i:i + s] * w[i].to(xbc.dtype)
    return C.silu(y + b.to(xbc.dtype))


def _segsum(a):
    """log-space cumulative decay matrix: L[i,j] = sum_{j<k<=i} a_k for
    j <= i, -inf above the diagonal.  a: (..., Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, dif, float("-inf"))


def ssd_scan(cfg, x, dt, B, Cc, a_log):
    """Chunked SSD.  x: (b,S,nh,dh); dt: (b,S,nh); B/C: (b,S,ds).
    Returns y (b,S,nh,dh) and the final state (b,nh,ds,dh)."""
    b, s, nh, dh = x.shape
    ds = B.shape[-1]
    Q = min(cfg.ssm_chunk, s)
    pad = (-s) % Q
    nc = (s + pad) // Q

    A = -torch.exp(a_log.float())                         # (nh,) negative
    dtf = softplus(dt.float())                            # (b,S,nh)
    da = dtf * A                                          # log decay
    xdt = x.float() * dtf[..., None]                      # (b,S,nh,dh)
    if pad:
        # Pad AFTER discretization: da=0 (decay 1) and xdt=0 make padded
        # steps identities, so the final state equals the state at s-1.
        da = F.pad(da, (0, 0, 0, pad))
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))

    xc = xdt.reshape(b, nc, Q, nh, dh)
    dac = da.reshape(b, nc, Q, nh)
    Bc = B.reshape(b, nc, Q, ds).float()
    Cck = Cc.reshape(b, nc, Q, ds).float()

    # Intra-chunk (diagonal block): Y = (C B^T ⊙ L) @ xdt
    L = torch.exp(_segsum(dac.transpose(-1, -2)))         # (b,nc,nh,Q,Q)
    cb = torch.einsum("bnqs,bnks->bnqk", Cck, Bc)         # (b,nc,Q,Q)
    y_diag = torch.einsum("bnhqk,bnkhd->bnqhd", cb[:, :, None] * L, xc)
    del L

    # Chunk-final states: S_n = sum_i decay_to_end_i * B_i ⊗ xdt_i
    cum = torch.cumsum(dac, dim=2)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,Q,nh)
    states = torch.einsum("bnqs,bnqh,bnqhd->bnhsd",
                          Bc, decay_end, xc)              # (b,nc,nh,ds,dh)

    # Inter-chunk recurrence over the chunk states: one step a chunk.
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,nh)
    h = torch.zeros((b, nh, ds, dh), dtype=torch.float32, device=x.device)
    h_prev = torch.empty_like(states)                     # state before n
    for n in range(nc):
        h_prev[:, n] = h
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]

    # Inter-chunk output: y += C_t · (decay_from_start * h_prev)
    decay_in = torch.exp(cum)                             # (b,nc,Q,nh)
    y_off = torch.einsum("bnqs,bnqh,bnhsd->bnqhd", Cck, decay_in, h_prev)

    y = (y_diag + y_off).reshape(b, s + pad, nh, dh)[:, :s]
    return y.to(x.dtype), h


def _gated_norm(y, z, gamma, eps):
    """``rms_norm(y * silu(z))`` with the product fed to the norm
    unrounded (f32), as the reference's XLA program computes it: the
    product fuses into the norm's upcast, while silu rounds op by op in
    the activation dtype (``common.silu``)."""
    return C.rms_norm(y.float() * C.silu(z).float(), gamma, eps).to(y.dtype)


def ssm_apply(p, cfg, x):
    """Full-sequence block: x (B,S,D) -> (y (B,S,D), final_state)."""
    y, _, final = ssm_prefill(p, cfg, x)
    return y, final


def ssm_prefill(p, cfg, x):
    """Like ssm_apply but also returns the decode caches: (y, conv tail,
    final SSM state)."""
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    k = cfg.ssm_conv
    b, s, _ = x.shape
    # conv tail: last K-1 *pre-activation* inputs, for decode continuity
    tail = F.pad(xbc_raw[:, -(k - 1):], (0, 0, max(0, k - 1 - s), 0))
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    di, ds = d_inner(cfg), cfg.ssm_state
    nh, dh = n_heads(cfg), cfg.ssm_head_dim
    xh = xbc[..., :di].reshape(b, s, nh, dh)
    y, final = ssd_scan(cfg, xh, dt + p["dt_bias"].to(dt.dtype),
                        xbc[..., di:di + ds], xbc[..., di + ds:],
                        p["a_log"])
    y = y + xh * p["d_skip"].to(x.dtype)[:, None]
    y = _gated_norm(y.reshape(b, s, di), z, p["norm"], cfg.norm_eps)
    return C.row_parallel_out(y, p["out_proj"]), tail, final


def ssm_decode(p, cfg, x, conv_tail, state):
    """One-token recurrent update.  x: (B,1,D); conv_tail: (B,K-1,conv);
    state: (B,nh,ds,dh) f32.  Returns (out, new tail, new state)."""
    b = x.shape[0]
    di, ds = d_inner(cfg), cfg.ssm_state
    nh, dh = n_heads(cfg), cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)

    window = torch.cat([conv_tail, xbc_new], dim=1)       # (B,K,conv)
    # Decode convolves in f32 (prefill in the activation dtype), as the
    # reference does.
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    xbc = C.silu(conv + p["conv_b"].float())
    xi, Bv, Cv = xbc[:, :di], xbc[:, di:di + ds], xbc[:, di + ds:]

    A = -torch.exp(p["a_log"].float())
    dtf = softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B,nh)
    a = torch.exp(dtf * A)                                    # (B,nh)
    xh = xi.reshape(b, nh, dh)
    # h <- a h + dt (B ⊗ x)
    state = (state * a[..., None, None]
             + Bv[:, None, :, None] * (xh * dtf[..., None])[:, :, None, :])
    y = torch.einsum("bs,bhsd->bhd", Cv, state)               # (B,nh,dh)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return C.row_parallel_out(y, p["out_proj"]), window[:, 1:], state


# ---------------------------------------------------------------------------
# Whole-model assembly (attention-free stack)
# ---------------------------------------------------------------------------
def init_params(cfg, init: C.Init) -> Dict[str, Any]:
    dt = cfg.param_dtype
    L = cfg.num_layers
    return {
        "embed": C.dense_init(init, (cfg.vocab, cfg.d_model), cfg.d_model,
                              dt),
        "layers": {"ln": C.zeros_init(init, (L, cfg.d_model), dt),
                   "mixer": ssm_init(init, (L,), cfg)},
        "ln_f": C.zeros_init(init, (cfg.d_model,), dt),
    }


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of :func:`init_params`' tree, leaf for leaf."""
    return {
        "embed": ("vocab", "fsdp"),
        "layers": C.stack_axes({"ln": (None,), "mixer": ssm_axes(cfg)}),
        "ln_f": (None,),
    }


def _head(cfg, params, x):
    x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return C.lm_logits(x, params["embed"], tied=True)  # mamba ties them


def _layers(cfg, params):
    return enumerate(C.layer_views(params["layers"], cfg.num_layers))


def forward(cfg, params, tokens, patches=None):
    x = C.embed_tokens(params["embed"], tokens, cfg.dtype)

    def body(lp, x):
        h, _ = ssm_apply(lp["mixer"], cfg,
                         C.rms_norm(x, lp["ln"], cfg.norm_eps))
        return x + h

    body = C.maybe_remat(cfg, body)
    for _, lp in _layers(cfg, params):
        x = body(lp, x)
    return _head(cfg, params, x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    nh, dh, ds = n_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = d_inner(cfg) + 2 * ds
    L = cfg.num_layers
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=C.torch_dtype(cfg.dtype), device=device),
        "state": torch.zeros((L, batch, nh, ds, dh), dtype=torch.float32,
                             device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes(cfg):
    """The logical axes of :func:`init_cache`'s leaves."""
    return {"conv": ("layers", "batch", None, "mlp"),
            "state": ("layers", "batch", None, "state", None),
            "pos": ("batch",)}


def _check_batch(cache, b):
    if cache["conv"].shape[1] != b:
        raise ValueError(f"the cache holds {cache['conv'].shape[1]} rows; "
                         f"the tokens have {b}")


def prefill(cfg, params, tokens, cache, patches=None):
    """Run the prompt, fill the cache (in place), return last-position
    logits and the cache.  The mixer runs whole on every ``model`` rank
    (its ``in_proj`` packs z|x|B|C|dt in one ``mlp`` dim); where the
    placement cuts the conv tail's channels (``mlp`` over ``model``) a
    rank keeps its part of them (``common.store_channels``), and a
    decode step gathers them whole first (``common.read_channels``)."""
    b, s = tokens.shape
    _check_batch(cache, b)
    x = C.embed_tokens(params["embed"], tokens, cfg.dtype)
    for i, lp in _layers(cfg, params):
        h, tail, final = ssm_prefill(lp["mixer"], cfg,
                                     C.rms_norm(x, lp["ln"], cfg.norm_eps))
        x = x + h
        C.store_channels(cache["conv"][i], tail)
        cache["state"][i].copy_(final)
    cache["pos"].fill_(s)
    return _head(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) -> (logits (B,1,V), the cache with
    each layer's conv tail and state rewritten in place)."""
    _check_batch(cache, tokens.shape[0])
    x = C.embed_tokens(params["embed"], tokens, cfg.dtype)
    for i, lp in _layers(cfg, params):
        h, tail, state = ssm_decode(lp["mixer"], cfg,
                                    C.rms_norm(x, lp["ln"], cfg.norm_eps),
                                    C.read_channels(cache["conv"][i]),
                                    cache["state"][i])
        x = x + h
        C.store_channels(cache["conv"][i], tail)
        cache["state"][i].copy_(state)
    cache["pos"].add_(1)
    return _head(cfg, params, x), cache
