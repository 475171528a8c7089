"""The ranks of the mesh train-step tests (``test_torch_train_mesh*.py``).

One process a rank of a gloo group on the CPU (``torch.multiprocessing``
with a ``file://`` rendezvous, never a TCP port), spawned once per mesh.
Each rank runs every case of its mesh: three mesh train steps of the
f32 SMOKE config from params drawn with ``np.random.default_rng``, each
against the port's one-device computation of the same step from the
same (gathered) state and global batch, computed in the rank itself.
What it saw goes to ``<out>/<rank>.json``; the tests read the files.
Imports neither jax nor the reference, so the children start fast.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import textwrap

import numpy as np
import torch

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base"]
MOE = ("deepseek-v3-671b", "mixtral-8x22b")
#: The families whose projections ``tp_psum`` splits: transformer, mla,
#: rglru, whisper.
TP_ARCHS = ("qwen2.5-14b", "deepseek-v3-671b", "recurrentgemma-9b",
            "whisper-base")
B, S = 4, 16
STEPS = 3
OPT = dict(lr=1e-3, eps=1e-6, total_steps=10, warmup_steps=0)


def _cases():
    """name -> (mesh, arch, config overrides, TrainConfig overrides,
    masked labels)."""
    out = {}
    for a in ARCHS:
        out[f"data2/{a}"] = ("data=2", a, {}, {}, False)
    for a in MOE:
        out[f"model2/{a}"] = ("model=2", a, {}, {}, False)
    for a in TP_ARCHS:
        out[f"model2_tp/{a}"] = ("model=2", a, {"tp_psum": True}, {}, False)
    for a in ("qwen2.5-14b", "mixtral-8x22b"):
        out[f"data2model2/{a}"] = ("data=2,model=2", a, {}, {}, False)
    out["data2model2_tp/qwen2.5-14b"] = ("data=2,model=2", "qwen2.5-14b",
                                         {"tp_psum": True}, {}, False)
    out["data2_microbatches/minicpm-2b"] = (
        "data=2", "minicpm-2b", {}, {"microbatches": 2}, False)
    out["data2_compress/minicpm-2b"] = (
        "data=2", "minicpm-2b", {}, {"microbatches": 2,
                                     "compress_grads": True}, False)
    out["data2_cast/minicpm-2b"] = (
        "data=2", "minicpm-2b", {}, {"cast_params": True}, False)
    out["data2_microbatches/mixtral-8x22b"] = (
        "data=2", "mixtral-8x22b", {}, {"microbatches": 2}, False)
    out["data2_unequal/minicpm-2b"] = ("data=2", "minicpm-2b", {}, {}, True)
    # the partitioned state under each option that changes its gathers
    # or its accumulator (test_torch_train_placement.py)
    for name, (mesh, arch, over, tc_over) in PLACEMENT_CASES.items():
        out[name] = (mesh, arch, over, tc_over, False)
    for name in THREADED:
        kind, arch = name.split("/")
        mesh = {"model2_tp_threaded": "model=2",
                "data2model2_threaded": "data=2,model=2"}[kind]
        out[name] = (mesh, arch, {"tp_psum": True} if "tp" in kind else {},
                     {}, False)
    return out


#: name -> (mesh, arch, config overrides, TrainConfig overrides): the
#: partitioned state with microbatches, ``compress_grads`` (its bf16
#: accumulator of the parts' global gradients) and ``cast_params`` with
#: and without ``pregather_params`` (the bf16 copy gathered at use or
#: once a step).
MICRO_COMPRESS = {"microbatches": 2, "compress_grads": True}
PREGATHER = {"cast_params": True, "pregather_params": True}
PLACEMENT_CASES = {
    "place_data2_pregather/minicpm-2b": ("data=2", "minicpm-2b", {},
                                         PREGATHER),
    "place_data2_micro/mixtral-8x22b": (
        "data=2", "mixtral-8x22b", {}, {"microbatches": 2}),
    "place_model2_tp_micro/qwen2.5-14b": (
        "model=2", "qwen2.5-14b", {"tp_psum": True}, {"microbatches": 2}),
    "place_model2_pregather/qwen2.5-14b": (
        "model=2", "qwen2.5-14b", {}, {**PREGATHER, "microbatches": 2}),
    "place_model2_cast/minicpm-2b": ("model=2", "minicpm-2b", {},
                                     {"cast_params": True}),
    "place_model2_micro/deepseek-v3-671b": (
        "model=2", "deepseek-v3-671b", {"tp_psum": True},
        {"microbatches": 2}),
    "place_data2model2_micro_compress/qwen2.5-14b": (
        "data=2,model=2", "qwen2.5-14b", {}, MICRO_COMPRESS),
    "place_data2model2_cast/qwen2.5-14b": (
        "data=2,model=2", "qwen2.5-14b", {},
        {"cast_params": True, "microbatches": 2}),
    "place_data2model2_micro_compress/mixtral-8x22b": (
        "data=2,model=2", "mixtral-8x22b", {}, MICRO_COMPRESS),
    "place_data2model2_pregather/mixtral-8x22b": (
        "data=2,model=2", "mixtral-8x22b", {}, PREGATHER),
    "place_data2model2_micro/whisper-base": (
        "data=2,model=2", "whisper-base", {"tp_psum": True},
        {"microbatches": 2}),
}


#: Cases whose backward runs on a thread of its own, as autograd runs a
#: CUDA backward on its device thread: a layer recomputed under ``remat``
#: there must see the forward's mesh.
THREADED = ("model2_tp_threaded/qwen2.5-14b",
            "data2model2_threaded/mixtral-8x22b")


def _grad_on_a_thread(real):
    """``torch.autograd.grad`` run on a new thread."""
    import threading

    def grad(*args, **kw):
        out = []
        t = threading.Thread(target=lambda: out.append(real(*args, **kw)))
        t.start()
        t.join()
        return out[0]
    return grad


#: name -> (mesh, arch, config overrides, TrainConfig overrides): the
#: compute split over ``model`` with no ``tp_psum`` (the row-parallel
#: sums in f32): every SMOKE config on ``model=2``, four families on
#: ``data=2,model=2``, and an uneven split on ``model=4`` (6 heads over
#: 2 KV heads, a vocab and an MLP width that 4 does not divide: ranges of
#: 2, 1, 2, 1 heads, a KV head computed on two ranks, weights gathered
#: whole and sliced), and whisper-base with 2 heads on ``model=4``
#: (``FEW_HEADS``: fewer heads than ranks, computed whole on every rank).
FEW_HEADS = "tp_model4_fewheads/whisper-base"
UNEVEN = {"n_heads": 6, "n_kv_heads": 2, "vocab": 250, "d_ff": 130}
TP_CASES = {
    **{f"tp_model2/{a}": ("model=2", a, {}, {}) for a in ARCHS},
    **{f"tp_data2model2/{a}": ("data=2,model=2", a, {}, {})
       for a in ("qwen2.5-14b", "deepseek-v3-671b", "whisper-base",
                 "recurrentgemma-9b")},
    "tp_model4_uneven/qwen2.5-14b": ("model=4", "qwen2.5-14b", UNEVEN, {}),
    FEW_HEADS: ("model=4", "whisper-base", {"n_heads": 2}, {}),
}

CASES = _cases()
CASES.update({n: (*c, False) for n, c in TP_CASES.items()})
GROUPS = {"data=2": 2, "model=2": 2, "data=2,model=2": 4, "model=4": 4}


def config(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", **kw)


def make_batch(cfg, b=B, s=S, seed=1, masked=False):
    """Seeded tokens and labels, the family's extra input; ``masked``
    hides 9 of row 0's labels and 2 of row 3's, so two row parts count
    different numbers of labels."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if masked:
        batch["labels"][0, :9] = -1
        batch["labels"][3, 5:7] = -1
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def draw_params(model, seed=0):
    """Every param leaf drawn with ``np.random.default_rng(seed)`` in
    flatten order: a standard normal over sqrt(its second-last dim) for
    matrices, x 0.1 for vectors."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    rng = np.random.default_rng(seed)
    flat = tree_flatten(model.init(0, "meta"))
    leaves = []
    for _, t in flat:
        scale = 1.0 / np.sqrt(t.shape[-2]) if t.ndim >= 2 else 0.1
        leaves.append(torch.from_numpy(
            (rng.standard_normal(tuple(t.shape)) * scale).astype(np.float32)))
    return tree_unflatten([p for p, _ in flat], leaves)


def part_rows(global_batch, n, k, part):
    """Row part ``part`` of ``k`` of each of ``n`` microbatches."""
    per = global_batch // (n * k)
    return [(i * (global_batch // n) + part * per,
             i * (global_batch // n) + (part + 1) * per) for i in range(n)]


def rows_of(batch, rows):
    return {key: np.concatenate([v[lo:hi] for lo, hi in rows])
            for key, v in batch.items()}


def expected_step(model, tc, params, batch, k_rows, device="cpu",
                  model_axis=False):
    """The port's one-device computation of the mesh step on this global
    batch: (loss, gradients in flatten order, grad_norm).

    The one-device step on the global batch itself, except where the
    mesh step's arithmetic is per row part by design, where each
    microbatch's gradient is the mean over the row parts of the
    one-device gradient on each part's rows: the bf16 gradients of
    ``cast_params`` are each rank's before the reduce; ``compress_grads``
    rounds the reduced mean of each microbatch to bf16 (so the mean the
    error feedback starts from is the mesh's, bit for bit); and on a
    mesh with a ``model`` axis (``model_axis``) a MoE routes each part's
    rows alone (capacity and aux loss per part, the reference's
    ``shard_map``), its reported loss carrying the first part's aux
    loss.  On a mesh without one a MoE routes the whole microbatch: the
    one-device step."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.training import global_norm
    from repro_torch.training.train import _accumulate
    n = tc.microbatches
    moe = bool(model.cfg.n_experts) and model_axis
    tb = lambda b: {k: torch.as_tensor(v, device=device)
                    for k, v in b.items()}
    per_part = k_rows > 1 and (moe or tc.cast_params or tc.compress_grads)
    if not per_part:
        loss, grads = _accumulate(model, tc, params, tb(batch))
        grads = [g.float() for g in grads]
    else:
        one = dataclasses.replace(tc, microbatches=1, compress_grads=False)
        loss, acc, err = 0.0, None, None
        for i in range(n):
            parts = [_accumulate(model, one, params, tb(rows_of(
                batch, part_rows(B, n, k_rows, d)[i:i + 1])))
                for d in range(k_rows)]
            loss = loss + sum(p[0] for p in parts) / k_rows
            g = [sum(x.float() for x in gs) / k_rows
                 for gs in zip(*(p[1] for p in parts))]
            if tc.compress_grads:
                err = err or [torch.zeros_like(x) for x in g]
                corrected = [x + e for x, e in zip(g, err)]
                g = [c.to(torch.bfloat16) for c in corrected]
                err = [c - q.float() for c, q in zip(corrected, g)]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        loss = loss / n
        grads = [a.float() / n for a in acc]
        if moe:
            fwd = params if not tc.cast_params else tree_unflatten(
                [p for p, _ in tree_flatten(params)],
                [t.to(torch.bfloat16) if t.ndim >= 2 else t
                 for _, t in tree_flatten(params)])
            with torch.no_grad():
                for i in range(n):
                    aux = [float(model.forward(fwd, tb(rows_of(
                        batch, part_rows(B, n, k_rows, d)[i:i + 1])))[1][
                        "aux_loss"]) for d in range(k_rows)]
                    loss = loss + (aux[0] - sum(aux) / k_rows) / n
    paths = [p for p, _ in tree_flatten(params)]
    return (float(loss), grads,
            float(global_norm(tree_unflatten(paths, grads))))


def _sha(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def _tree(leaves, like):
    from repro_torch.models.common import tree_flatten, tree_unflatten
    return tree_unflatten([p for p, _ in tree_flatten(like)], list(leaves))


def replicated(state, layout):
    """Every rank's whole copy of ``state`` (``params``, and ``opt`` when
    it has one): each part gathered over its axes, each leaf a copy."""
    return _tree([t.clone() for t in layout.gathered(state)], state)


#: The param axes a whole (replicated) state maps to no mesh axis.
WHOLE_RULES = {a: None for a in ("fsdp", "heads", "kv_heads", "mlp",
                                 "vocab", "experts")}


def rounds_split_grads(mesh, tc_over) -> bool:
    """Whether a case's gradients are rounded to bf16 (``cast_params``'
    bf16 copies, ``compress_grads``' accumulator) on a mesh whose compute
    splits over ``model``: the split sums its f32 products in another
    order than one device, so a value near a bf16 rounding boundary may
    round the other way, one bf16 ulp.  Such a case's gradient leaves are
    held to the same mesh's step on the whole (replicated) state, which
    rounds at the same points, and to one device's within one bf16 ulp
    (:func:`bf16_ulps`); its loss and ``grad_norm`` to one device."""
    return "model" in mesh and bool(tc_over.get("cast_params")
                                    or tc_over.get("compress_grads"))


def bf16_ulps(got, want) -> float:
    """The largest difference of ``got`` from ``want``, in bf16 ulps at
    ``want``'s largest magnitude (the spacing of bf16 values in its
    binade, 2^(e - 7) for a largest magnitude in [2^e, 2^(e+1)))."""
    top = float(want.abs().max())
    diff = float((got - want).abs().max())
    if top == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / 2.0 ** (math.floor(math.log2(top)) - 7)


def _whole_state_grads(model, tc, live, before, rows, seen):
    """The reduced gradients (whole leaves, flatten order) of one step of
    the same mesh on the whole state ``before`` (every param axis mapped
    to no mesh axis, so nothing is held in part), taken from ``seen``,
    where the patched optimizer of :func:`run_case` puts them."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.training import make_jitted_train_step
    with use_mesh(None, WHOLE_RULES):
        step = make_jitted_train_step(model, tc, mesh=live)
    step(tree_map(lambda t: t.clone(), before), rows)
    return seen.pop()


def run_case(name, live, device="cpu"):
    """Three mesh steps of ``name`` against the one-device computation,
    on ``device`` (the gradients of a case that :func:`rounds_split_grads`
    against the same mesh's step on the whole state)."""
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten, tree_leaves, \
        tree_map
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_jitted_train_step)
    from repro_torch.training import optim
    from repro_torch.training.train import local_batch, param_plans, \
        rank_rows, shard_state
    _, arch, over, tc_over, masked = CASES[name]
    model = get_model(config(arch, **over))
    tc = TrainConfig(opt=OptConfig(**OPT), **tc_over)
    params = shard_state(model, tree_map(lambda t: t.to(device),
                                         draw_params(model)), live)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_jitted_train_step(model, tc, mesh=live)
    layout = step.layout
    k_rows = live.split(("pod", "data"))[0]
    model_axis = "model" in live.spec.names
    seen = []
    real = optim.adamw_update

    def capture(cfg, p, grads, opt, inplace=False, grad_norm=None):
        seen.append([g.clone() for _, g in tree_flatten(grads)])
        return real(cfg, p, grads, opt, inplace=inplace, grad_norm=grad_norm)

    res = {"loss": [], "loss_want": [], "norm": [], "norm_want": [],
           "grad_ratio": [], "worst_leaf": [], "param_sha": [],
           "moment_sha": [], "whole_equal": [], "finite": True,
           "coords": live.coords,
           "rows": rank_rows(B, tc.microbatches, live),
           "parts": sorted(p for p in layout.parts if p.startswith("params/")),
           "held": sorted(p for p, plan in param_plans(model, live,
                                                       layout)[0].items()
                          if plan.held is not None),
           "cut_axes": {p: sorted({a for _, axes in cuts for a in axes})
                        for p, cuts in layout.parts.items()}}
    optim.adamw_update = capture
    real_grad = torch.autograd.grad
    if name in THREADED:
        torch.autograd.grad = _grad_on_a_thread(real_grad)
    try:
        for s in range(STEPS):
            gb = make_batch(model.cfg, seed=s + 1, masked=masked)
            before = replicated(state, layout)
            whole = before["params"]
            want_loss, want_grads, want_norm = expected_step(
                model, tc, whole, gb, k_rows, device, model_axis)
            rows = local_batch(gb, tc.microbatches, live)
            one_grads = None
            if rounds_split_grads(CASES[name][0], tc_over):
                one_grads = want_grads
                want_grads = _whole_state_grads(model, tc, live, before,
                                                rows, seen)
            state, met = step(state, rows)
            # the replicated layout's update: AdamW on the whole state with
            # the whole reduced gradients, bit-equal to the parts' gathered
            grads = replicated({"params": _tree(seen[-1], state["params"])},
                               layout)["params"]
            new_p, new_opt, _ = real(tc.opt, before["params"], grads,
                                     before["opt"],
                                     grad_norm=met["grad_norm"])
            res["whole_equal"].append(all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves({"params": new_p, "opt": new_opt}),
                    tree_leaves(replicated(state, layout)))))
            if s == 0:
                res["cut"] = list(step.cut_leaves)
            ratio, worst = 0.0, None
            flat = tree_flatten(state["params"])
            for (path, leaf), got, want in zip(flat, seen[-1], want_grads):
                want = layout.local("params/" + path, want)
                scale = max(1.0, float(want.abs().max()))
                r = float((got - want).abs().max()) / scale
                if r > ratio:
                    ratio, worst = r, path
            res["grad_ratio"].append(ratio)
            res["worst_leaf"].append(worst)
            if one_grads is not None:
                res.setdefault("one_ulps", []).append(max(
                    bf16_ulps(got, layout.local("params/" + path, one))
                    for (path, _), got, one in zip(flat, seen[-1],
                                                   one_grads)))
            res["loss"].append(float(met["loss"]))
            res["loss_want"].append(want_loss)
            res["norm"].append(float(met["grad_norm"]))
            res["norm_want"].append(want_norm)
            res["param_sha"].append({p: _sha(t) for p, t in flat})
            res["moment_sha"].append(
                {p: _sha(t) for p, t in tree_flatten(state["opt"])})
            res["finite"] &= all(bool(torch.isfinite(t).all())
                                 for _, t in flat)
    finally:
        optim.adamw_update = real
        torch.autograd.grad = real_grad
    return res


def collective_checks(live):
    """Each conjugate pair's forward and backward on ``live``'s ``model``
    axis against the one-process computation over every rank's inputs
    (each rank's inputs seeded by its part)."""
    from repro_torch.dist import collectives as col
    k, me = live.split(("model",))
    ax = ("model",)
    rng = lambda r: np.random.default_rng(100 + r)
    draw = lambda r, *shape: torch.from_numpy(
        rng(r).standard_normal(shape).astype(np.float32))
    whole = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 12)).astype(np.float32))
    c = [draw(r, 4, 12) for r in range(k)]
    out = {}

    x = whole.clone().requires_grad_()
    (col.copy_to_model(x, ax, live) * c[me]).sum().backward()
    out["copy_to_model"] = bool(torch.allclose(x.grad, sum(c), atol=1e-6))

    xs = [draw(r, 4, 12) for r in range(k)]
    x = xs[me].clone().requires_grad_()
    y = col.reduce_from_model(x, ax, live)
    (y * c[0]).sum().backward()
    out["reduce_from_model"] = bool(torch.allclose(y, sum(xs), atol=1e-6)
                                    and torch.equal(x.grad, c[0]))

    x = xs[me].clone().requires_grad_()
    y = col.gather_rows(x, ax, live, dim=0)
    cc = torch.cat(c, 0)
    (y * cc).sum().backward()
    out["gather_rows"] = bool(torch.equal(y, torch.cat(xs, 0))
                              and torch.equal(x.grad, c[me]))

    x = whole.clone().requires_grad_()
    y = col.split_to_model(x, ax, live, dim=-1)
    (y * c[me][:, :12 // k]).sum().backward()
    out["split_to_model"] = bool(
        torch.equal(y, whole[:, me * 12 // k:(me + 1) * 12 // k])
        and torch.equal(x.grad, torch.cat([cr[:, :12 // k] for cr in c], 1)))

    # the uneven gather of ranges (``sharding.unit_range`` of 2k + 1
    # columns) and its reduce-scatter backward; the max outside autograd
    from repro_torch.distributed.sharding import unit_range
    n = 2 * k + 1
    lo, hi = unit_range(n, k, me)
    wide = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, n)).astype(np.float32))
    x = wide[:, lo:hi].clone().requires_grad_()
    y = col.gather_part(x, ax, live, -1, n)
    cw = [draw(r, 4, n) for r in range(k)]
    (y * cw[me]).sum().backward()
    out["gather_part"] = bool(torch.equal(y, wide) and torch.allclose(
        x.grad, sum(cw)[:, lo:hi], atol=1e-6))
    out["all_max"] = bool(torch.equal(col.all_max(xs[me], ax, live),
                                      torch.stack(xs).amax(0)))

    g = xs[me].clone()
    col.all_reduce_(g, ax, live)
    out["all_reduce_"] = bool(torch.allclose(g, sum(xs), atol=1e-6))
    out["forward_alone_equal"] = bool(torch.equal(
        col.reduce_from_model(xs[me], ax, live), g))

    # a mesh the group does not fill exactly is refused, never trained on
    from repro_torch.dist import MeshUnavailableError
    from repro_torch.models import get_model
    from repro_torch.training import TrainConfig, make_jitted_train_step
    m = get_model(config("minicpm-2b"))
    world = live.spec.size
    refusals = [("larger_mesh_refused", f"data=2,model={world}",
                 MeshUnavailableError)]
    if world > 2:               # a mesh of 2..world-1 ranks leaves some out
        refusals.append(("smaller_mesh_refused", "data=2", ValueError))
    for key, spec, err in refusals:
        try:
            make_jitted_train_step(m, TrainConfig(), mesh=spec,
                                   device="cpu")
            out[key] = False
        except err:
            out[key] = True
    # a state whose experts are whole, where this rank holds its part
    from repro_torch.training import adamw_init
    moe = get_model(config("mixtral-8x22b"))
    params = moe.init(0, "cpu")
    step = make_jitted_train_step(moe, TrainConfig(), mesh=live)
    try:
        step({"params": params, "opt": adamw_init(params)},
             make_batch(moe.cfg, b=B // live.split(("pod", "data"))[0]))
        out["whole_state_refused"] = False
    except ValueError:
        out["whole_state_refused"] = True
    return out


def checkpoint_checks(live, out_dir):
    """mixtral-8x22b SMOKE with its experts cut over ``model``: a mesh
    save (the parts gathered, rank 0 writing) against rank 0's
    one-device save of the gathered state; a restore of each rank's part
    and a whole restore on one device."""
    import filecmp
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.training import init_state
    from repro_torch.training.train import StateLayout
    model = get_model(config("mixtral-8x22b"))
    state = init_state(model, 3, "cpu", mesh=live)
    state["opt"]["m"] = tree_map(lambda t: t + 0.5, state["opt"]["m"])
    layout = StateLayout(model, live)
    mesh_dir = os.path.join(out_dir, "ck_mesh")
    Checkpointer(mesh_dir).save(4, state, blocking=True, layout=layout)
    whole = layout.whole_leaves(state)
    out = {"parts": sorted(layout.parts)}
    one_dir = os.path.join(out_dir, "ck_one")
    if whole is not None:
        paths = [p for p, _ in tree_flatten(state)]
        from repro_torch.models.common import tree_unflatten
        whole = tree_unflatten(paths, whole)
        Checkpointer(one_dir).save(4, whole, blocking=True)
        a, b = (os.path.join(d, "step_000000004") for d in (mesh_dir, one_dir))
        names = sorted(os.listdir(a))
        out["byte_equal"] = names == sorted(os.listdir(b)) and all(
            filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
            for n in names)
        one = Checkpointer(mesh_dir).restore(
            4, init_state(model, 0, "cpu"))
        out["one_device_equal"] = all(
            torch.equal(x, y) for x, y in zip(
                [t for _, t in tree_flatten(one)],
                [t for _, t in tree_flatten(whole)]))
    dist.barrier()
    like = init_state(model, 0, "cpu", mesh=live)
    back = Checkpointer(mesh_dir).restore(4, like, layout=layout)
    out["rank_equal"] = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_flatten(back), tree_flatten(state)))
    return out


#: The partitioned checkpoint's config and step: saved on
#: ``data=2,model=2`` (``ck_save``), restored on another mesh
#: (``ck_restore=<dir>``) and by the reference.
CK_ARCH, CK_STEP = "qwen2.5-14b", 4


def placement_checkpoint(live, out_dir, name):
    """``ck_save``: a partitioned state (every leaf in part) saved on
    ``live``, against rank 0's one-device save of the gathered state
    (byte-equal), restored whole on one device and in part on each rank
    (bit-equal), in ``<out_dir>/ck_place``.  ``ck_restore=<dir>``: that
    checkpoint restored into this mesh's parts, against the one-device
    restore cut to them."""
    import filecmp
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.training import init_state
    from repro_torch.training.train import StateLayout
    model = get_model(config(CK_ARCH))
    layout = StateLayout(model, live)
    like = init_state(model, 0, "cpu", mesh=live)
    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_flatten(a), tree_flatten(b)))
    if name.startswith("ck_restore="):
        src = name.split("=", 1)[1]
        back = Checkpointer(src).restore(CK_STEP, like, layout=layout)
        whole = Checkpointer(src).restore(CK_STEP, init_state(model, 0,
                                                              "cpu"))
        mine = _tree([layout.local(p, t) for p, t in tree_flatten(whole)],
                     whole)
        return {"parts": len(layout.parts), "rank_equal": same(back, mine)}
    state = init_state(model, 3, "cpu", mesh=live)
    state["opt"]["m"] = tree_map(lambda t: t + 0.5, state["opt"]["m"])
    state["opt"]["step"].fill_(CK_STEP)
    mesh_dir = os.path.join(out_dir, "ck_place")
    Checkpointer(mesh_dir).save(CK_STEP, state, blocking=True, layout=layout)
    whole = layout.whole_leaves(state)
    out = {"parts": len(layout.parts), "dir": mesh_dir}
    if whole is not None:
        whole = _tree(whole, state)
        one_dir = os.path.join(out_dir, "ck_place_one")
        Checkpointer(one_dir).save(CK_STEP, whole, blocking=True)
        a, b = (os.path.join(d, f"step_{CK_STEP:09d}")
                for d in (mesh_dir, one_dir))
        names = sorted(os.listdir(a))
        out["byte_equal"] = names == sorted(os.listdir(b)) and all(
            filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                        shallow=False) for n in names)
        out["one_device_equal"] = same(Checkpointer(mesh_dir).restore(
            CK_STEP, init_state(model, 0, "cpu")), whole)
    dist.barrier()
    out["rank_equal"] = same(Checkpointer(mesh_dir).restore(
        CK_STEP, like, layout=layout), state)
    return out


def run_group(rank: int, world: int, init_file: str, mesh: str,
              out_dir: str, names, oracle=None, device="cpu") -> None:
    """One rank: every case of ``names`` on ``mesh`` (and, given the
    oracle script's files ``{arch: path}``, the reference's SPMD steps),
    the results to a JSON file."""
    import torch.distributed as dist
    from repro_torch.dist import MeshSpec
    from repro_torch.dist.collectives import LiveMesh, destroy_process_group
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        live = LiveMesh(MeshSpec.parse(mesh), torch.device(device))
        results = {name: placement_checkpoint(live, out_dir, name)
                   if name.startswith("ck_") else run_case(name, live, device)
                   for name in names}
        for arch, path in (oracle or {}).items():
            results[f"oracle/{arch}"] = run_oracle(arch, path, live)
        if "model" in mesh:
            results["collectives"] = collective_checks(live)
        if mesh == "model=2":
            results["checkpoint"] = checkpoint_checks(live, out_dir)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        destroy_process_group()


def spawn_group(mesh: str, world: int, out_dir: str, names,
                oracle=None, device="cpu") -> None:
    """Run ``world`` ranks of ``mesh`` over ``names`` to their end."""
    import torch.multiprocessing as mp
    init_file = os.path.join(out_dir, "rendezvous")
    mp.spawn(run_group, args=(world, init_file, mesh, out_dir, list(names),
                              oracle, device), nprocs=world, join=True)


#: The reference's SPMD train test's settings (``tests/test_sharding.py``),
#: at f32, on ``data=2,model=2`` and on ``data=2`` (a mesh without
#: ``model``, where the reference routes a MoE's whole microbatch).
ORACLE_ARCHS = ("qwen2.5-14b", "mixtral-8x22b")
ORACLE_OPT = dict(lr=1e-3, total_steps=4, warmup_steps=0)
ORACLE_MICROBATCHES = 2

#: The reference's jitted mesh step, run by :func:`reference_oracle` in a
#: process of its own: argv is the mesh (``data=2,model=2`` or
#: ``data=2``) then (case, output file) pairs, a case an arch with the
#: TrainConfig flags it turns on after a colon, joined by ``+``
#: (``qwen2.5-14b:compress_grads``).  The mesh is built with
#: Auto axes: under jax 0.9 ``jax.make_mesh`` makes Explicit ones, which
#: the reference's ``with_sharding_constraint`` refuses.
ORACLE_SCRIPT = textwrap.dedent("""
    import math, os, sys
    axes = [a.split("=") for a in sys.argv[1].split(",")]
    names, shape = tuple(a for a, _ in axes), tuple(int(n) for _, n in axes)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{math.prod(shape)}")
    import dataclasses
    sys.path.insert(0, "src")
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import get_model
    from repro.training import OptConfig, TrainConfig, init_state, \\
        make_jitted_train_step
    from repro.distributed import sharding as shd

    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(names))
    for case, out in zip(sys.argv[2::2], sys.argv[3::2]):
        arch, _, opts = case.partition(":")
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        m = get_model(cfg)
        tc = TrainConfig(opt=OptConfig(lr=1e-3, total_steps=4,
                                       warmup_steps=0), microbatches=2,
                         **{o: True for o in opts.split("+") if o})
        with shd.use_mesh(mesh):
            state = init_state(m, jax.random.PRNGKey(0))
            params = {
                "params/" + "/".join(str(k.key) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(state["params"])[0]}
            step = make_jitted_train_step(m, tc, mesh=mesh, donate=False)
            batch = {
                "tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 32),
                                             0, cfg.vocab),
                "labels": jax.random.randint(jax.random.PRNGKey(2), (4, 32),
                                             0, cfg.vocab),
            }
            losses = []
            for _ in range(3):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
        np.savez(out, tokens=np.asarray(batch["tokens"]),
                 labels=np.asarray(batch["labels"]),
                 losses=np.asarray(losses), **params)
    print("ORACLE_OK")
""")


def reference_oracle(mesh: str, out_dir: str, root: str,
                     cases=ORACLE_ARCHS):
    """Run the reference's mesh step on ``mesh`` for each of ``cases``
    (archs, each with its TrainConfig flags: ``ORACLE_SCRIPT``) in a
    subprocess; {case: the file of its params, batch and 3 losses}."""
    import subprocess
    import sys
    files = {a: os.path.join(out_dir, a.replace(":", "__") + ".npz")
             for a in cases}
    args = [x for a, f in files.items() for x in (a, f)]
    out = subprocess.run([sys.executable, "-c", ORACLE_SCRIPT, mesh, *args],
                         capture_output=True, text=True, cwd=root,
                         timeout=600)
    assert "ORACLE_OK" in out.stdout, out.stdout + out.stderr
    return files


def load_oracle(path):
    """(the reference's params as the port's tree, its batch, its 3
    losses) from the file the oracle script wrote."""
    from repro_torch.models.common import tree_unflatten
    from repro_torch.weights import params_from_reference
    with np.load(path) as z:
        keys = [k for k in z.files if k.startswith("params/")]
        params = tree_unflatten([k[len("params/"):] for k in keys],
                                [z[k] for k in keys])
        batch = {"tokens": z["tokens"], "labels": z["labels"]}
        losses = [float(x) for x in z["losses"]]
    return params_from_reference(params), batch, losses


def run_oracle(case, path, live):
    """The port's mesh step from the reference's params and batch (with
    the case's TrainConfig flags): its 3 losses and the reference's."""
    from repro_torch.models import get_model
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_jitted_train_step)
    from repro_torch.training.train import local_batch, shard_state
    params, batch, want = load_oracle(path)
    arch, _, opts = case.partition(":")
    model = get_model(config(arch))
    tc = TrainConfig(opt=OptConfig(**ORACLE_OPT),
                     microbatches=ORACLE_MICROBATCHES,
                     **{o: True for o in opts.split("+") if o})
    params = shard_state(model, params, live)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_jitted_train_step(model, tc, mesh=live)
    rows = local_batch(batch, tc.microbatches, live)
    got = []
    for _ in range(3):
        state, met = step(state, rows)
        got.append(float(met["loss"]))
    return {"loss": got, "want": want}


def launcher_twin(rank: int, world: int, init_file: str, out_dir: str,
                  steps: int, args) -> None:
    """One rank of the launcher's loop (``repro_torch.launch.train`` with
    ``--smoke --device cpu --mesh host``), written out with the library:
    the host mesh's step on ``init_state(..., mesh=)``, the launcher's
    synthetic batches, schedule and checkpoint steps (``args``: the
    launcher's ``--arch``, ``--batch``, ``--seq``, ``--lr``,
    ``--ckpt-every``); rank 0's logged metrics, rounded as the launcher
    rounds them, to ``<out_dir>/log.json`` and the checkpoints under
    ``<out_dir>/ck``."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.dist.collectives import destroy_process_group
    from repro_torch.launch.mesh import host_mesh_spec
    from repro_torch.models import get_model
    from repro_torch.training import (OptConfig, TrainConfig, init_state,
                                      make_jitted_train_step)
    from repro_torch.training.train import rank_rows
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config(args["arch"], smoke=True)
        model = get_model(cfg)
        tc = TrainConfig(opt=OptConfig(
            lr=args["lr"], total_steps=steps,
            warmup_steps=max(1, steps // 20), schedule=cfg.lr_schedule))
        step = make_jitted_train_step(model, tc, mesh=host_mesh_spec(),
                                      device="cpu")
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab,
                                          global_batch=args["batch"],
                                          seq_len=args["seq"]))
        rows = rank_rows(args["batch"], 1, step.mesh)
        state = init_state(model, 0, "cpu", mesh=step.mesh)
        ck = Checkpointer(os.path.join(out_dir, "ck"))
        log = {}
        for i in range(steps):
            batch = {k: torch.as_tensor(v)
                     for k, v in data.batch_rows(i, rows).items()}
            state, met = step(state, batch)
            log[i] = {"loss": round(float(met["loss"]), 4),
                      "lr": float(met["lr"]),
                      "grad_norm": round(float(met["grad_norm"]), 3)}
            if (i > 0 and i % args["ckpt_every"] == 0) or i == steps - 1:
                ck.save(i, state, blocking=True, layout=step.layout)
        if rank == 0:
            with open(os.path.join(out_dir, "log.json"), "w") as f:
                json.dump(log, f)
    finally:
        destroy_process_group()


def run_launcher_twin(out_dir: str, steps: int, args) -> dict:
    """Run :func:`launcher_twin` over two ranks; ``{step: metrics}``."""
    import torch.multiprocessing as mp
    mp.spawn(launcher_twin, args=(2, os.path.join(out_dir, "rendezvous"),
                                  out_dir, steps, args), nprocs=2, join=True)
    with open(os.path.join(out_dir, "log.json")) as f:
        return {int(k): v for k, v in json.load(f).items()}
