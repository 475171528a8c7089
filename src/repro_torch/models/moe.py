"""Mixture-of-Experts FFN with capacity-based dispatch.

The port of ``repro.models.moe``: mixtral (8 experts top-2, softmax
router) and deepseek-v3 (1 shared + routed top-k, sigmoid router).

On a live mesh with a ``model`` axis (``distributed.sharding.use_mesh``)
it is the reference's expert-parallel ``shard_map``, written out: the
activations are whole on every rank, each rank routes every token but
runs only its own experts' FFNs, and a sum over ``model`` combines the
outputs (the aux loss, the same on every ``model`` rank, is the
reference's mean over ``model``).  Under autograd the routing weights
and the tokens sent to the experts sum their gradients over ``model``
(each rank's experts see only their own tokens), so the router's and
the input's gradients are whole on every rank.  Two modes, chosen from
(E, model) as the reference's:

* **EP** (E % model == 0): rank r holds experts
  ``[r·E/model, (r+1)·E/model)``;
* **TP** (model % E == 0): every rank holds every expert, a 1/model
  part of each one's hidden width.

The ``batch`` rows stay local to ``data``: each data rank routes its
own rows (so capacity counts them alone, as the reference's shards do)
and the outputs are gathered over ``data``.  In the mesh train step a
rank's inputs are already its rows (``use_mesh(..., local_batch=True)``)
and the step owns the row split: on a mesh with a ``model`` axis the MoE
routes the rows it is given and gathers nothing (the reference's
``shard_map``, whose ``batch`` spec splits the rows, even where
``model`` is 1); on a mesh without one it gathers the microbatch's rows
over the ``batch`` axes, routes them whole as the reference's GSPMD
program does (capacity and aux loss those of the whole microbatch), and
keeps its own rows of the output (:func:`whole_microbatch`).  Weights
may arrive whole
(each rank takes its part, recorded by ``sharding.split_param`` for the
gradient reduce) or already cut to this rank's part
(:func:`local_experts`), which is how a training rank holds only its
experts and their moments.

Capacity-based token dropping (``cfg.moe_cf``) keeps every shape static;
which tokens drop depends on the order slots are counted in, which is
the reference's (one choice column at a time).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import BATCH_AXES, current_mesh, equal_part, \
    local_batch, mesh_axis_names, mesh_axis_size, model_part, split_param, \
    whole_dim
from . import common as C

#: The routed experts' weights: (expert dim, hidden-width dim), counted
#: from the end so a stacked (L, ...) leaf cuts the same way.
_EXPERT_DIMS = {"wi_gate": (-3, -1), "wi_up": (-3, -1), "wo": (-3, -2)}


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


def moe_axes(cfg):
    """Logical axes of :func:`moe_init`'s params (per layer).  EP mode
    shards the expert dim; TP mode (when the active mesh's ``model``
    axis does not divide the experts) the hidden width."""
    ep = True
    mesh = current_mesh()
    if mesh is not None and "model" in mesh_axis_names(mesh):
        ep = cfg.n_experts % mesh_axis_size(mesh, "model") == 0
    if ep:
        p = {"router": (None, None),
             "wi_gate": ("experts", "fsdp", None),
             "wi_up": ("experts", "fsdp", None),
             "wo": ("experts", None, "fsdp")}
    else:
        p = {"router": (None, None),
             "wi_gate": (None, "fsdp", "mlp"),
             "wi_up": (None, "fsdp", "mlp"),
             "wo": (None, "mlp", "fsdp")}
    if cfg.n_shared:
        p["shared"] = C.mlp_axes()
    return p


def _expert_split(cfg, mesh):
    """(parts, this rank's part, EP mode) of the routed experts over the
    ``model`` axis of ``mesh``; None when nothing splits them."""
    if mesh is None:
        return None
    k, i = mesh.split(("model",))
    if k == 1:
        return None
    ep = cfg.n_experts % k == 0
    if not ep and k % cfg.n_experts != 0:
        raise ValueError(f"n_experts={cfg.n_experts} incompatible with "
                         f"model axis {k}")
    return k, i, ep


def local_experts(p, cfg, mesh=None):
    """``p`` (a MoE layer's params, or a stack of them) with the routed
    experts' weights cut to this rank's part on ``mesh`` (default: the
    active one): its experts (EP) or its part of every expert's hidden
    width (TP).  A weight already cut is kept; views, not copies."""
    split = _expert_split(cfg, current_mesh() if mesh is None else mesh)
    if split is None:
        return p
    k, i, ep = split
    out = dict(p)
    for name, (dim, whole) in expert_dims(cfg, ep).items():
        if p[name].shape[dim] == whole:
            out[name] = split_param(p[name], dim, equal_part(whole, k, i))
    return out


def expert_dims(cfg, ep: bool):
    """name -> (the dim the ``model`` axis cuts, its whole size) of each
    routed expert weight: the expert dim (EP) or the hidden width
    (TP)."""
    return {name: ((e_dim, cfg.n_experts) if ep else (f_dim, cfg.moe_d_ff))
            for name, (e_dim, f_dim) in _EXPERT_DIMS.items()}


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
    """The reference's per-shard MoE: x (T_local, D), this rank's
    experts ``[e_offset, e_offset + E_local)``; the output summed over
    the mesh axis ``axis`` of the active mesh (None on one device).  The
    aux loss is the same on every rank of ``axis`` (each routes the same
    tokens), the reference's mean over it."""
    t, d = x.shape
    e_local = wi_gate.shape[0]
    cap = max(1, int(t * cfg.top_k * cfg.moe_cf / cfg.n_experts))

    idx, w, aux = _route(cfg, x, router)                 # global expert ids
    if axis is not None:
        from ..dist.collectives import copy_to_model
        mesh = current_mesh()
        w = copy_to_model(w, (axis,), mesh)
        x = copy_to_model(x, (axis,), mesh)
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
    if axis is not None:
        from ..dist.collectives import reduce_from_model
        y = reduce_from_model(y, (axis,), mesh)
    return y, aux


def whole_microbatch():
    """(mesh, parts, this rank's part) of the ``batch`` rows when this
    rank holds only its rows (the mesh train step) and the reference
    routes the whole microbatch: a mesh with no ``model`` axis, where no
    ``shard_map`` splits the rows.  None otherwise, where a rank routes
    the rows it is given."""
    split = local_batch()
    if split is None or "model" in mesh_axis_names(split[0]):
        return None
    return split


def moe_apply(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux-loss scalar)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    mesh = current_mesh()
    split = _expert_split(cfg, mesh)
    whole = whole_microbatch()
    if whole is not None:
        from ..dist.collectives import gather_rows, local_part
        # every rank's loss reads the gathered rows (the aux loss), so
        # each rank's rows take the sum of the ranks' gradients
        rows = gather_rows(flat, BATCH_AXES, whole[0], dim=0, sum_grad=True)
        y, aux = _moe_local(cfg, rows, p["router"], p["wi_gate"],
                            p["wi_up"], p["wo"])
        y = local_part(y, *whole[1:], 0)
    elif split is None:
        y, aux = _moe_local(cfg, flat, p["router"], p["wi_gate"],
                            p["wi_up"], p["wo"])
    else:
        from ..dist.collectives import gather_rows, local_part
        k, i, ep = split
        lp = local_experts(p, cfg, mesh)
        # the train step's rows are this rank's already; serving's whole
        own = local_batch() is not None or mesh.split(BATCH_AXES)[0] == 1
        rows = flat if own else local_part(flat, *mesh.split(BATCH_AXES), 0)
        y, aux = _moe_local(cfg, rows, p["router"], lp["wi_gate"],
                            lp["wi_up"], lp["wo"],
                            e_offset=i * (cfg.n_experts // k) if ep else 0,
                            axis="model")
        if not own:
            y = gather_rows(y, BATCH_AXES, mesh, dim=0)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        # the shared experts' MLP: in the mesh train step a rank's range
        # of its ``mlp`` columns
        sp = p["shared"]
        cols = model_part(whole_dim(sp["wi_gate"], -1))
        h_g, h_u = C.col_parallel_in(x, (sp["wi_gate"], sp["wi_up"]),
                                     parts=(cols, cols))
        y = y + C.row_parallel_out(C.silu(h_g) * h_u, sp["wo"],
                                   cfg.tp_psum, cols)
    return y, aux
