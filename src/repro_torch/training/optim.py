"""Optimizer: AdamW plus the LR schedules the configs use (cosine and
MiniCPM's WSD) — the port of ``repro.training.optim``.

The state is the reference's: ``{"m": tree, "v": tree, "step": 0-d
int32}``, every tensor on the params' device, so a step never waits on
the host.  :func:`adamw_update` returns new tensors, as the reference's
does; with ``inplace=True`` it writes the params and both moments where
they lie (the reference's donated buffers: at minicpm-2b's widths a
second copy of them would not fit the card beside the first).  On a
mesh the params and moments are the rank's part of each leaf
(``training.train.StateLayout``): the update is elementwise, so each
part's update is the slice of the whole update given the same
gradient, and only the clip's ``grad_norm`` needs the mesh (the caller
passes it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..models.common import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: final fraction spent decaying
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """LR at ``step`` (a tensor or an int) as a 0-d f32 tensor on its
    device.  WSD = warmup/stable/decay (MiniCPM)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = cfg.total_steps
    if cfg.schedule == "constant":
        frac = torch.ones_like(step)
    elif cfg.schedule == "wsd":
        decay_start = t * (1.0 - cfg.decay_frac)
        # stable at 1.0, then linear decay to min_lr_frac
        prog = torch.clamp((step - decay_start) / max(t - decay_start, 1),
                           0.0, 1.0)
        frac = 1.0 - (1.0 - cfg.min_lr_frac) * prog
    else:  # cosine
        prog = torch.clamp(step / t, 0.0, 1.0)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * frac


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and step 0, on their device."""
    zeros = lambda p: tree_map(torch.zeros_like, p)
    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_axes(param_axes) -> Dict[str, Any]:
    """Moment tensors shard like their params (ZeRO via fsdp axes)."""
    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(cfg: OptConfig, params, grads, opt, inplace: bool = False,
                 grad_norm=None):
    """One AdamW step; returns ``(params, opt, metrics)`` with metrics
    ``{"lr", "grad_norm"}`` as 0-d tensors.  The step count is
    incremented first; gradients are clipped by their global f32 norm
    (``grad_norm`` where the caller gives it: a mesh rank that holds
    part of some leaves reduces their squares over the mesh); the
    moments are f32 and bias-corrected; weight decay is decoupled and
    applies to leaves of two or more dims only; each param goes back to
    its own dtype.  ``inplace`` writes ``params``, ``m``, ``v`` and the
    step count where they lie (each keeping its dtype) and returns the
    same trees."""
    step = opt["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        """The new (p, m, v) of one leaf.  In place the same operations
        run in the same order on the state's own tensors (bit-equal to
        the new tensors), with three leaf-sized temporaries."""
        g = g.float() * clip
        if not inplace:
            m, v = m.float().clone(), v.float().clone()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        delta = m / bc1
        delta.div_(torch.sqrt_(v / bc2).add_(cfg.eps))
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        delta.mul_(lr)
        if not inplace:
            return (p.float() - delta).to(p.dtype), m, v
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
        return p, m, v

    paths = [path for path, _ in tree_flatten(params)]
    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(opt["m"]), tree_leaves(opt["v"]))
    metrics = {"lr": lr, "grad_norm": gnorm}
    if inplace:
        with torch.no_grad():
            for p, g, m, v in flat:
                upd(p, g, m, v)
            opt["step"].copy_(step)
        return params, opt, metrics
    out = [upd(p, g, m, v) for p, g, m, v in flat]
    new = [tree_unflatten(paths, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics
