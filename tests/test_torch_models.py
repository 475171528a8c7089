"""The port's transformer-family LLM stack against the JAX package's.

The same params (``repro.models.get_model(cfg).init(PRNGKey(0))``, carried
across with ``repro_torch.weights.params_from_reference``) and the same
seeded tokens go through both packages on the CPU, for the seven
transformer-family ``SMOKE`` configs:

* forward logits at ``dtype="float32"`` within 1e-4 (abs and rel);
* prefill + decode steps within 1e-4 on the same tokens, and greedy
  generation giving the reference's tokens;
* ``prefill_chunk`` bit-equal to the port's own full ``prefill``;
* forward at the configured bf16 within the reference's low-precision
  budget, 0.05 x max(1, max|logits|) (``repro/core/passes/quantize.py:64``).

JAX is compiled once per arch (module fixtures) and reused by the tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.weights import params_from_reference

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b"]
F32_TOL = 1e-4
BF16_BUDGET = 0.05
B, S, EXTRA = 2, 24, 4


def make_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


class Pair:
    """One arch in both packages at one activation dtype."""

    def __init__(self, arch, dtype, ref_params, port_params):
        self.rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                                        dtype=dtype)
        self.pcfg = dataclasses.replace(get_config(arch, smoke=True),
                                        dtype=dtype)
        self.rm, self.pm = ref_model(self.rcfg), get_model(self.pcfg)
        self.rp, self.pp = ref_params, port_params
        self.r_fwd = jax.jit(lambda p, b: self.rm.forward(p, b)[0])
        self.r_prefill = jax.jit(self.rm.prefill)
        self.r_decode = jax.jit(self.rm.decode_step)


@pytest.fixture(scope="module", params=ARCHS)
def params(request):
    arch = request.param
    rp = ref_model(ref_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    return arch, rp, params_from_reference(jax.tree.map(np.asarray, rp))


@pytest.fixture(scope="module")
def f32(params):
    return Pair(params[0], "float32", params[1], params[2])


@pytest.fixture(scope="module")
def bf16(params):
    return Pair(params[0], "bfloat16", params[1], params[2])


def test_forward_f32_matches_reference(f32):
    batch = make_batch(f32.rcfg, B, S + EXTRA, seed=1)
    want = as_np(f32.r_fwd(f32.rp, batch))
    got, extras = f32.pm.forward(f32.pp, to_torch(batch))
    assert got.shape == (B, S + EXTRA, f32.pcfg.vocab)
    np.testing.assert_allclose(as_np(got), want, rtol=F32_TOL, atol=F32_TOL)
    _, ref_extras = jax.jit(f32.rm.forward)(f32.rp, batch)
    np.testing.assert_allclose(float(extras["aux_loss"]),
                               float(ref_extras["aux_loss"]),
                               rtol=F32_TOL, atol=1e-6)


def _greedy(step, logits, n):
    """n greedy tokens: each the argmax of the previous logits."""
    toks = []
    for _ in range(n):
        tok = np.argmax(as_np(logits)[:, -1], axis=-1).astype(np.int32)
        toks.append(tok)
        logits = step(tok[:, None])
    return np.stack(toks, axis=1)


def test_prefill_decode_f32_matches_reference(f32):
    batch = make_batch(f32.rcfg, B, S + EXTRA, seed=2)
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    rc = f32.rm.init_cache(B, S + 2 * EXTRA)
    pc = f32.pm.init_cache(B, S + 2 * EXTRA, device="cpu")
    rl, rc = f32.r_prefill(f32.rp, pre, rc)
    pl, pc = f32.pm.prefill(f32.pp, to_torch(pre), pc)
    np.testing.assert_allclose(as_np(pl), as_np(rl), rtol=F32_TOL,
                               atol=F32_TOL, err_msg="prefill")
    assert pc["pos"].tolist() == np.asarray(rc["pos"]).tolist()
    for t in range(EXTRA):
        tok = batch["tokens"][:, S + t:S + t + 1]
        rl, rc = f32.r_decode(f32.rp, rc, tok)
        pl, pc = f32.pm.decode_step(f32.pp, pc, torch.as_tensor(tok))
        np.testing.assert_allclose(as_np(pl), as_np(rl), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"decode {t}")
    np.testing.assert_allclose(as_np(pc["c1"]), as_np(rc["c1"]),
                               rtol=F32_TOL, atol=F32_TOL)

    # Greedy generation from here: the same tokens.
    state = {"r": rc, "p": pc}

    def r_step(tok):
        lg, state["r"] = f32.r_decode(f32.rp, state["r"], tok)
        return lg

    def p_step(tok):
        lg, state["p"] = f32.pm.decode_step(f32.pp, state["p"],
                                            torch.as_tensor(tok))
        return lg

    want = _greedy(r_step, rl, EXTRA)
    got = _greedy(p_step, pl, EXTRA)
    np.testing.assert_array_equal(got, want)


def test_prefill_chunk_bit_equal_to_prefill(f32):
    """Chunked prefill gives the port's full prefill bit for bit: the
    last real token's logits and every cache row the prompt wrote (vlm
    prompts without their patches; MLA caches have no chunked form)."""
    assert f32.pm.supports_chunked_prefill() == (
        f32.pcfg.family != "vlm" and not f32.pcfg.mla)
    if f32.pcfg.mla:
        with pytest.raises(NotImplementedError, match="MLA"):
            f32.pm.prefill_chunk(
                f32.pp, torch.zeros((B, 8), dtype=torch.int32),
                f32.pm.init_cache(B, 32, device="cpu"), 0, 8)
        return
    max_len = S + 8
    if f32.pcfg.pattern == "swa":            # a full-context cache only
        max_len = min(max_len, f32.pcfg.window)
    s, c = max_len - 3, 8
    toks = make_batch(f32.rcfg, B, s, seed=3)["tokens"]
    want_l, want_c = f32.pm.prefill(f32.pp, {"tokens": torch.as_tensor(toks)},
                                    f32.pm.init_cache(B, max_len, "cpu"))
    cache = f32.pm.init_cache(B, max_len, "cpu")
    for start in range(0, s, c):
        n = min(c, s - start)
        chunk = np.zeros((B, c), np.int32)
        chunk[:, :n] = toks[:, start:start + n]
        got_l, cache = f32.pm.prefill_chunk(f32.pp, torch.as_tensor(chunk),
                                            cache, start, n)
    assert torch.equal(got_l, want_l)
    assert torch.equal(cache["c1"][:, :, :s], want_c["c1"][:, :, :s])
    assert torch.equal(cache["c2"][:, :, :s], want_c["c2"][:, :, :s])
    assert cache["pos"].tolist() == [s] * B


def test_forward_bf16_within_budget(bf16):
    batch = make_batch(bf16.rcfg, B, S + EXTRA, seed=4)
    want = as_np(bf16.r_fwd(bf16.rp, batch))
    got, _ = bf16.pm.forward(bf16.pp, to_torch(batch))
    assert got.dtype == torch.float32            # lm_logits run in f32
    err = float(np.abs(as_np(got) - want).max())
    limit = BF16_BUDGET * max(1.0, float(np.abs(want).max()))
    assert err <= limit, (f"{bf16.pcfg.name}: bf16 logits differ by {err} "
                          f"from the reference's (limit {limit})")
    print(f"{bf16.pcfg.name} bf16 max_abs_err {err} limit {limit}")
