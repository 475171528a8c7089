"""Train-step factory: microbatched gradient accumulation, gradient
compression with error feedback, AdamW — the port of
``repro.training.train`` on one device.

The step runs eagerly: the loss, ``torch.autograd.grad`` over the param
leaves, then AdamW.  The reference's ``lax.scan`` over microbatches is
a Python loop here, each microbatch's graph freed after its backward;
its donated state is an update in place (``donate=True``: every state
tensor keeps its storage).  Params are stacked ``(L, ...)`` leaves, so
an optimizer step is one update per leaf, about 15 leaves of work.

Gradient compression: cross-microbatch gradients are carried in bf16
with an f32 error-feedback accumulator (the round-off is fed back into
the next microbatch's gradient before quantization), so the persistent
accumulator is half-width while the update stays unbiased in
expectation.

A mesh of more than one device needs collectives that autograd
understands (ROADMAP A.15b); a 1-device mesh is the single device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models.api import Model
from ..models.common import tree_flatten, tree_unflatten
from . import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optim.OptConfig = dataclasses.field(default_factory=optim.OptConfig)
    microbatches: int = 1           # grad-accumulation steps
    compress_grads: bool = False    # bf16 accumulator + error feedback
    cast_params: bool = False       # compute layers on a bf16 copy of the
                                    # f32 masters, made once a step
    pregather_params: bool = False  # the reference's placement of that
                                    # copy; the port holds tensors whole,
                                    # so it changes nothing


def init_state(model: Model, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Params drawn from ``seed`` on ``device`` and a fresh AdamW state."""
    params = model.init(seed, device)
    return {"params": params, "opt": optim.adamw_init(params)}


def state_axes(model: Model) -> Dict[str, Any]:
    axes = model.param_axes()
    return {"params": axes, "opt": optim.opt_state_axes(axes)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model: Model, tc: TrainConfig,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "lr", "grad_norm"}`` as 0-d tensors on the state's
    device.  ``batch`` holds numpy arrays or tensors; ``donate`` updates
    the state in place and returns it."""

    def grad_fn(params, batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, the gradient of each param leaf in flatten order, in the
        leaf's dtype).  Under ``cast_params`` the loss runs on a bf16 copy
        of every f32 leaf with two or more dims, and the copy's gradient,
        cast back to f32, is the master's: the reference's gradient
        through the cast."""
        paths, leaves = zip(*tree_flatten(params))
        inputs = []
        for p in leaves:
            if tc.cast_params and p.dtype == torch.float32 and p.ndim >= 2:
                p = p.to(torch.bfloat16)
            inputs.append(p.detach().requires_grad_())
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(list(paths), inputs), batch)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), [g.to(p.dtype) for g, p in zip(grads, leaves)]

    def update(state, grads, loss):
        params, opt, m = optim.adamw_update(
            tc.opt, state["params"], grads, state["opt"], inplace=donate)
        metrics = {"loss": loss, **m}
        return (state if donate else {"params": params, "opt": opt}), metrics

    def as_tree(params, flat):
        return tree_unflatten([p for p, _ in tree_flatten(params)], flat)

    def single(state, batch):
        batch = _on_device(batch, state["opt"]["step"].device)
        loss, grads = grad_fn(state["params"], batch)
        return update(state, as_tree(state["params"], grads), loss)

    def microbatched(state, batch):
        n = tc.microbatches
        batch = _on_device(batch, state["opt"]["step"].device)
        for v in batch.values():
            assert v.shape[0] % n == 0, (v.shape[0], n)
        leaves = [p for _, p in tree_flatten(state["params"])]
        gdtype = torch.bfloat16 if tc.compress_grads else torch.float32
        acc = [torch.zeros(p.shape, dtype=gdtype, device=p.device)
               for p in leaves]
        err = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves] if tc.compress_grads else None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, grads = grad_fn(state["params"], mb)
            for j, g in enumerate(grads):
                if tc.compress_grads:
                    # quantize with error feedback: e <- (g+e) - bf16(g+e)
                    corrected = g.float() + err[j]
                    q = corrected.to(torch.bfloat16)
                    err[j] = corrected - q.float()
                    acc[j] = acc[j] + q
                else:
                    acc[j] = acc[j] + g.float()
            loss_sum = loss_sum + loss
        grads = [a.float() / n for a in acc]
        return update(state, as_tree(state["params"], grads), loss_sum / n)

    return single if tc.microbatches == 1 else microbatched


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    spec = getattr(mesh, "spec", mesh)        # a LiveMesh carries its spec
    from ..dist.mesh import MeshSpec
    return MeshSpec.coerce(spec).size


def make_jitted_train_step(model: Model, tc: TrainConfig, mesh=None,
                           donate: bool = True) -> Callable:
    """The train step for ``mesh`` (None or a 1-device mesh: one device).
    The name is the reference's; the step runs eagerly (capturing it as
    one CUDA graph is later work).  ``donate`` updates the state in
    place, the reference's donated buffers."""
    if _mesh_size(mesh) > 1:
        raise NotImplementedError(
            "a train step over a mesh of more than one device is not "
            "ported yet (ROADMAP A.15b: the mesh train step)")
    return make_train_step(model, tc, donate=donate)
