"""Mixture-of-Experts FFN with capacity-based dispatch.

The port of ``repro.models.moe`` on one device: mixtral (8 experts
top-2, softmax router) and deepseek-v3 (1 shared + routed top-k,
sigmoid router).  The reference's expert-parallel ``shard_map`` form
(``moe.py:186-214``) is ROADMAP A.14b; with no mesh the reference runs
``_moe_local`` with ``axis=None``, which is what the port computes.

Capacity-based token dropping (``cfg.moe_cf``) keeps every shape static;
which tokens drop depends on the order slots are counted in, which is
the reference's (one choice column at a time).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import common as C


def moe_init(init: C.Init, lead, cfg):
    """Router, expert and (deepseek-v3) shared-expert params, each with
    ``lead`` in front."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = cfg.param_dtype
    p = {
        "router": C.dense_init(init, (*lead, d, e), d, dt),
        "wi_gate": C.dense_init(init, (*lead, e, d, f), d, dt),
        "wi_up": C.dense_init(init, (*lead, e, d, f), d, dt),
        "wo": C.dense_init(init, (*lead, e, f, d), f, dt),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = C.mlp_init(init, lead, d, fs, dt)
    return p


def _top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, the lower
    index first among equal values (a stable descending sort; torch.topk
    does not promise that order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, x, router):
    """Top-k routing in f32.  x: (T, D) -> idx (T,k), weights (T,k), aux."""
    logits = torch.matmul(x.float(), router.float())
    if cfg.router_fn == "softmax":            # mixtral
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, cfg.top_k)
        w = w / torch.sum(w, dim=-1, keepdim=True)
    else:                                      # deepseek-v3 sigmoid router
        scores = torch.sigmoid(logits)
        w, idx = _top_k(scores, cfg.top_k)
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
        probs = scores / (torch.sum(scores, dim=-1, keepdim=True) + 1e-20)
    e = cfg.n_experts
    sel = F.one_hot(idx[:, 0], e).float()
    aux = e * torch.sum(torch.mean(sel, dim=0) * torch.mean(probs, dim=0))
    return idx, w.float(), aux


def _positions(cfg, idx):
    """Capacity slot of each (token, choice) within its expert: exact
    counts, one choice column at a time (the reference's order)."""
    t, k = idx.shape
    e = cfg.n_experts
    base = torch.zeros((e,), dtype=torch.int64, device=idx.device)
    cols = []
    for j in range(k):
        oh = F.one_hot(idx[:, j], e)                        # (T, E) int64
        pos_j = torch.cumsum(oh, dim=0) - 1 + base[None, :]
        cols.append(torch.gather(pos_j, 1, idx[:, j:j + 1])[:, 0])
        base = base + torch.sum(oh, dim=0)
    return torch.stack(cols, dim=1)                         # (T, k)


def _expert_ffn(cfg, buf, wi_gate, wi_up, wo):
    """buf: (E, C, D) -> (E, C, D) through per-expert gated MLPs."""
    h_g = torch.bmm(buf, wi_gate.to(buf.dtype))
    h_u = torch.bmm(buf, wi_up.to(buf.dtype))
    h = C.activation(cfg.mlp_act)(h_g) * h_u
    return torch.bmm(h, wo.to(buf.dtype))


def _moe_local(cfg, x, router, wi_gate, wi_up, wo, *, e_offset=0,
               axis=None):
    """The reference's per-shard MoE on one device: x (T, D), experts
    ``[e_offset, e_offset + E_local)``.  ``axis`` must be None (the
    psum over a mesh axis is ROADMAP A.14b)."""
    if axis is not None:
        raise NotImplementedError(
            "the sharded MoE is not ported yet (ROADMAP A.14b: "
            "sharded models)")
    t, d = x.shape
    e_local = wi_gate.shape[0]
    cap = max(1, int(t * cfg.top_k * cfg.moe_cf / cfg.n_experts))

    idx, w, aux = _route(cfg, x, router)                 # global expert ids
    pos = _positions(cfg, idx)                           # (T, k)

    flat_e = idx.reshape(-1)
    flat_p = pos.reshape(-1)
    mine = ((flat_e >= e_offset) & (flat_e < e_offset + e_local)
            & (flat_p < cap))
    local_e = torch.clamp(flat_e - e_offset, 0, e_local - 1)
    slot = torch.where(mine, local_e * cap + torch.clamp(flat_p, 0, cap - 1),
                       e_local * cap)                    # overflow row

    xk = torch.repeat_interleave(x, cfg.top_k, dim=0)    # (T*k, D)
    # Every kept (token, choice) owns one real slot, and what goes to the
    # overflow row is zeros, so a copy gives the reference's scatter-add
    # deterministically (no atomics into a real slot).
    buf = torch.zeros((e_local * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, torch.where(mine[:, None], xk,
                                         torch.zeros_like(xk)))
    buf = buf[:-1].reshape(e_local, cap, d)

    out_buf = _expert_ffn(cfg, buf, wi_gate, wi_up, wo)

    gathered = torch.cat([out_buf.reshape(e_local * cap, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    yk = gathered[slot] * (w.reshape(-1, 1) * mine[:, None]).to(x.dtype)
    y = torch.sum(yk.reshape(t, cfg.top_k, d), dim=1)
    return y, aux


def moe_apply(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux-loss scalar)."""
    b, s, d = x.shape
    y, aux = _moe_local(cfg, x.reshape(b * s, d), p["router"],
                        p["wi_gate"], p["wi_up"], p["wo"])
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        sp = p["shared"]
        h_g = torch.matmul(x, sp["wi_gate"].to(x.dtype))
        h_u = torch.matmul(x, sp["wi_up"].to(x.dtype))
        y = y + C.row_parallel_out(C.silu(h_g) * h_u, sp["wo"])
    return y, aux
