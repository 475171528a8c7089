"""The port's training loss and its gradients against the JAX package's.

The same params (``repro.models.get_model(cfg).init(PRNGKey(0))``,
carried across with ``params_from_reference``) and the same seeded
batch go through ``Model.loss`` and its gradient in both packages on the
CPU, for the ten ``SMOKE`` configs (the port under its default
``remat="full"``, the reference under its scan's):

* at f32: the loss within 1e-5 x max(1, |loss|), every gradient leaf
  within 1e-4 x max(1, max|g|), the gradients' global norm within 1e-5
  relative;
* at the configured bf16: the loss within the reference's low-precision
  budget, 0.05 x max(1, |loss|);
* deepseek-v3's multi-token-prediction logits within 1e-5 x max(1,
  max|logits|).

Then, in the port alone: gradients bit-equal under ``remat`` ``none``,
``full`` and ``dots``, and through the ``torch.unbind`` layer views and
``t[i]`` ones; ``full`` and ``dots`` run each layer again in backward.
JAX is compiled once per arch and dtype."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.models import common as C
from repro_torch.models import get_model, transformer
from repro_torch.training import global_norm
from repro_torch.weights import params_from_reference

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_TOL = 1e-5
MTP_TOL = 1e-5
BF16_BUDGET = 0.05
B, S = 2, 16


def make_batch(cfg, b=B, s=S, seed=1):
    """Seeded tokens and labels, and the family's extra input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def port_grads(model, params, batch):
    """(loss, [gradient of each leaf in flatten order]) in the port."""
    paths, leaves = zip(*C.tree_flatten(params))
    ins = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(C.tree_unflatten(list(paths), ins), batch)
    grads = torch.autograd.grad(loss, ins, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, reference params, the port's copy of them)."""
    a = request.param
    rp = ref_model(ref_config(a, smoke=True)).init(jax.random.PRNGKey(0))
    return a, rp, params_from_reference(jax.tree.map(np.asarray, rp))


def _models(a, dtype):
    return (ref_model(dataclasses.replace(ref_config(a, smoke=True),
                                          dtype=dtype)),
            get_model(dataclasses.replace(get_config(a, smoke=True),
                                          dtype=dtype)))


def test_f32_loss_and_gradients_match_reference(arch):
    a, rp, pp = arch
    rm, pm = _models(a, "float32")
    batch = make_batch(rm.cfg)
    r_loss, r_grads = jax.jit(jax.value_and_grad(rm.loss))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    p_loss, p_grads = port_grads(pm, pp, batch)
    r_loss = float(r_loss)
    assert abs(float(p_loss) - r_loss) <= LOSS_TOL * max(1.0, abs(r_loss))
    paths = [p for p, _ in C.tree_flatten(pp)]
    r_leaves = [np.asarray(g, np.float32) for g in jax.tree.leaves(r_grads)]
    assert len(r_leaves) == len(p_grads)
    for path, want, got in zip(paths, r_leaves, p_grads):
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (a, path, err, scale)
    r_norm = float(np.sqrt(sum(float(np.sum(np.square(
        g.astype(np.float64)))) for g in r_leaves)))
    p_norm = float(global_norm(dict(zip(paths, p_grads))))
    assert abs(p_norm - r_norm) <= NORM_TOL * r_norm, (p_norm, r_norm)


def test_bf16_loss_within_budget(arch):
    a, rp, pp = arch
    rm, pm = _models(a, ref_config(a, smoke=True).dtype)
    assert rm.cfg.dtype == "bfloat16"
    batch = make_batch(rm.cfg)
    r_loss = float(jax.jit(rm.loss)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()}))
    p_loss, p_grads = port_grads(pm, pp, batch)
    assert abs(float(p_loss) - r_loss) <= BF16_BUDGET * max(1.0, abs(r_loss))
    assert all(bool(torch.isfinite(g).all()) for g in p_grads)


def test_mtp_logits_match_reference():
    from repro.models import transformer as ref_transformer
    a = "deepseek-v3-671b"
    rm, pm = _models(a, "float32")
    assert rm.cfg.mtp
    rp = rm.init(jax.random.PRNGKey(0))
    pp = params_from_reference(jax.tree.map(np.asarray, rp))
    batch = make_batch(rm.cfg)
    toks = jnp.asarray(batch["tokens"])
    _, r_extras = jax.jit(rm.forward)(rp, {"tokens": toks})
    want = np.asarray(jax.jit(
        lambda p, h, t: ref_transformer.mtp_logits(rm.cfg, p, h, t))(
        rp, r_extras["mtp_hidden"], toks))
    with torch.no_grad():
        _, p_extras = pm.forward(pp, batch)
        got = transformer.mtp_logits(
            pm.cfg, pp, p_extras["mtp_hidden"],
            torch.as_tensor(batch["tokens"])).numpy()
    assert got.shape == want.shape == (B, S, rm.cfg.vocab)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= MTP_TOL * scale


# ---------------------------------------------------------------------------
# The port alone: remat policies and layer views
# ---------------------------------------------------------------------------
REMAT_ARCHS = ["minicpm-2b", "deepseek-v3-671b", "mixtral-8x22b",
               "mamba2-780m", "recurrentgemma-9b", "whisper-base"]


def _f32_port(a, **kw):
    cfg = dataclasses.replace(get_config(a, smoke=True), dtype="float32",
                              **kw)
    model = get_model(cfg)
    return model, model.init(0, "cpu"), make_batch(cfg)


@pytest.mark.parametrize("a", REMAT_ARCHS)
def test_remat_policies_give_equal_gradients(a):
    results = {}
    for remat in ("none", "full", "dots"):
        model, params, batch = _f32_port(a, remat=remat)
        results[remat] = port_grads(model, params, batch)
    loss, grads = results["none"]
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], loss), remat
        for g0, g1 in zip(grads, results[remat][1]):
            assert torch.equal(g0, g1), remat


def _indexed_views(stacked, n):
    return [C.tree_map(lambda t: t[i], stacked) for i in range(n)]


@pytest.mark.parametrize("a", REMAT_ARCHS)
def test_unbind_and_index_layer_views_give_equal_gradients(a, monkeypatch):
    model, params, batch = _f32_port(a)
    loss, grads = port_grads(model, params, batch)
    monkeypatch.setattr(C, "layer_views", _indexed_views)
    loss1, grads1 = port_grads(model, params, batch)
    assert torch.equal(loss, loss1)
    for g0, g1 in zip(grads, grads1):
        assert torch.equal(g0, g1)


def test_layer_views_unbind_only_leaves_autograd_records():
    t = torch.randn(3, 4, requires_grad=True)
    cache = torch.zeros(3, 4)
    with torch.no_grad():
        views = C.layer_views({"w": t}, 3)
    assert views[0]["w"].grad_fn is None
    views = C.layer_views({"w": t, "c": cache}, 3)
    assert type(views[1]["w"].grad_fn).__name__.startswith("Unbind")
    views[2]["c"].fill_(1.0)              # a cache view is written in place
    assert cache[2].eq(1.0).all() and cache[:2].eq(0.0).all()


@pytest.mark.parametrize("remat,recomputed", [("none", 0), ("full", 2),
                                              ("dots", 2)])
def test_remat_recomputes_each_layer_in_backward(remat, recomputed,
                                                 monkeypatch):
    model, params, batch = _f32_port("minicpm-2b", remat=remat)
    calls = []
    real = transformer.layer_apply

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "layer_apply", counted)
    paths, leaves = zip(*C.tree_flatten(params))
    ins = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(C.tree_unflatten(list(paths), ins), batch)
    forward = len(calls)
    torch.autograd.grad(loss, ins)
    assert forward == model.cfg.num_layers == 2
    assert len(calls) - forward == recomputed
    with torch.no_grad():             # serving never recomputes
        calls.clear()
        model.forward(params, batch)
        assert len(calls) == 2
