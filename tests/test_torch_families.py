"""The port's SSM, hybrid and audio families against the JAX package's.

mamba2 (``models/ssm.py``), recurrentgemma (``models/rglru.py``) and
whisper (``models/whisper.py``).  The same params
(``repro.models.get_model(cfg).init(PRNGKey(0))``, carried across with
``repro_torch.weights.params_from_reference``) and the same tokens and
frames (drawn here from ``np.random.default_rng(seed)``) go through both
packages on the CPU, for the three ``SMOKE`` configs:

* forward logits at ``dtype="float32"`` within 1e-4 x max(1, max|logits|);
* prefill, then 8 greedy decode steps: logits within 1e-4 of the
  reference's at every step, the same tokens, the same caches.  The
  prompt (37 tokens) is not a multiple of mamba2's ``ssm_chunk`` (16), so
  the padded chunk runs, and is longer than recurrentgemma's window
  (16), so its ring is rolled at prefill and wraps in decode;
* forward at the configured bf16 within the reference's low-precision
  budget, 0.05 x max(1, max|logits|);
* the port's decode against its own forward at f32;
* the SSD scan against a naive per-token recurrence, and the RG-LRU
  scan against ``jax.lax.associative_scan`` and a sequential loop;
* ``param_count`` and the param tree at the published widths, the
  ``fold_norms`` note, and the engine target's serialize round trip.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch
from repro.configs import get_config as ref_config
from repro.inference import fold_norms as ref_fold_norms
from repro.models import get_model as ref_model
from repro.models import ssm as ref_ssm
from repro.models import whisper as ref_whisper
from repro_torch.configs import get_config
from repro_torch.inference import fold_norms
from repro_torch.models import common as PC
from repro_torch.models import get_model, rglru, ssm, whisper
from repro_torch.weights import params_from_reference

ARCHS = ["mamba2-780m", "recurrentgemma-9b", "whisper-base"]
PARAMS = {"mamba2-780m": 780_148_992, "recurrentgemma-9b": 9_396_195_328,
          "whisper-base": 70_686_208}
F32_TOL = 1e-4
BF16_BUDGET = 0.05
B, S, STEPS = 2, 37, 8


def make_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, tol, what):
    err = float(np.abs(as_np(got) - as_np(want)).max())
    limit = tol * max(1.0, float(np.abs(as_np(want)).max()))
    assert err <= limit, f"{what}: {err} > {limit}"
    return err


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


def test_forward_f32_matches_reference(f32):
    batch = make_batch(f32.rcfg, B, S + STEPS, seed=1)
    got, extras = f32.pm.forward(f32.pp, to_torch(batch))
    assert got.shape == (B, S + STEPS, f32.pcfg.vocab)
    assert float(extras["aux_loss"]) == 0.0
    assert_close(got, f32.r_fwd(f32.rp, batch), F32_TOL, f32.pcfg.name)


def test_prefill_decode_f32_matches_reference(f32):
    """Prefill, then 8 greedy steps in each package: logits within 1e-4
    at every step, the same tokens, and the same caches after."""
    cfg = f32.pcfg
    batch = make_batch(f32.rcfg, B, S, seed=2)
    rc = f32.rm.init_cache(B, S + STEPS)
    pc = f32.pm.init_cache(B, S + STEPS, device="cpu")
    rl, rc = f32.r_prefill(f32.rp, batch, rc)
    pl, pc = f32.pm.prefill(f32.pp, to_torch(batch), pc)
    assert_close(pl, rl, F32_TOL, "prefill")
    assert pc["pos"].tolist() == [S] * B
    if cfg.family == "ssm":
        assert S % cfg.ssm_chunk                 # the padded chunk runs
    if cfg.family == "hybrid":
        assert S > cfg.window == pc["attn_k"].shape[2]   # a rolled ring
    r_toks, p_toks = [], []
    for t in range(STEPS):
        rt = np.argmax(as_np(rl)[:, -1], -1).astype(np.int32)[:, None]
        pt = pl[:, -1].argmax(-1).to(torch.int32)[:, None]
        r_toks.append(rt)
        p_toks.append(pt.numpy())
        rl, rc = f32.r_decode(f32.rp, rc, rt)
        pl, pc = f32.pm.decode_step(f32.pp, pc, pt)
        assert_close(pl, rl, F32_TOL, f"decode {t}")
    np.testing.assert_array_equal(np.concatenate(p_toks, 1),
                                  np.concatenate(r_toks, 1))
    assert sorted(pc) == sorted(rc)
    for name in rc:
        assert pc[name].dtype == getattr(torch, str(rc[name].dtype)), name
        assert_close(pc[name], rc[name], F32_TOL, f"cache {name}")


def test_forward_bf16_within_budget(params):
    bf16 = Pair(params[0], "bfloat16", params[1], params[2])
    batch = make_batch(bf16.rcfg, B, S + STEPS, seed=4)
    got, _ = bf16.pm.forward(bf16.pp, to_torch(batch))
    assert got.dtype == torch.float32            # lm_logits run in f32
    err = assert_close(got, bf16.r_fwd(bf16.rp, batch), BF16_BUDGET,
                       f"{bf16.pcfg.name} bf16")
    print(f"{bf16.pcfg.name} bf16 max_abs_err {err}")


def test_decode_matches_forward_f32(f32):
    """The port against itself, as the reference's own
    ``test_decode_matches_forward_f32``: prefill S tokens, decode the
    next ones teacher-forced, and each step's logits equal the forward's
    at that position."""
    batch = make_batch(f32.rcfg, B, S + STEPS, seed=5)
    full, _ = f32.pm.forward(f32.pp, to_torch(batch))
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    cache = f32.pm.init_cache(B, S + STEPS, device="cpu")
    lg, cache = f32.pm.prefill(f32.pp, to_torch(pre), cache)
    assert_close(lg[:, 0], full[:, S - 1], F32_TOL, "prefill")
    for t in range(STEPS):
        tok = torch.as_tensor(batch["tokens"][:, S + t:S + t + 1])
        lg, cache = f32.pm.decode_step(f32.pp, cache, tok)
        assert_close(lg[:, 0], full[:, S + t], F32_TOL, f"step {t}")


# ---------------------------------------------------------------------------
# The scans
# ---------------------------------------------------------------------------
def _naive_ssd(x, dt, B_, C_, a_log):
    """The recurrence the SSD computes, one token at a time:
    h = exp(dt A) h + dt B ⊗ x;  y = C · h."""
    b, s, nh, dh = x.shape
    A = -np.exp(a_log.astype(np.float64))
    dtf = np.logaddexp(dt.astype(np.float64), 0.0)
    h = np.zeros((b, nh, B_.shape[-1], dh))
    ys = []
    for t in range(s):
        a = np.exp(dtf[:, t] * A)                               # (b,nh)
        h = (h * a[..., None, None] + dtf[:, t, :, None, None]
             * B_[:, t, None, :, None] * x[:, t, :, None, :])
        ys.append(np.einsum("bs,bhsd->bhd", C_[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("s", [48, 37, 5], ids=["whole", "padded", "short"])
def test_ssd_scan_matches_naive_recurrence(s):
    cfg = get_config("mamba2-780m", smoke=True)
    nh, dh, ds = ssm.n_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, s, nh, dh)).astype(np.float32)
    dt = rng.standard_normal((2, s, nh)).astype(np.float32)
    B_ = rng.standard_normal((2, s, ds)).astype(np.float32)
    C_ = rng.standard_normal((2, s, ds)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    y, final = ssm.ssd_scan(cfg, *map(torch.as_tensor, (x, dt, B_, C_,
                                                        a_log)))
    want_y, want_h = _naive_ssd(x, dt, B_, C_, a_log)
    assert final.shape == (2, nh, ds, dh)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), want_h, rtol=1e-4, atol=1e-4)
    ry, rh = ref_ssm.ssd_scan(cfg, x, dt, B_, C_, a_log)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(rh), rtol=1e-4,
                               atol=1e-4)


def _lru_inputs(s, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    bx = rng.standard_normal((2, s, 8)).astype(np.float32)
    return a, bx


@pytest.mark.parametrize("s", [1, 2, 7, 16, 37, 64])
def test_rglru_scan_matches_reference_and_a_loop(s):
    """The log-depth scan against ``jax.lax.associative_scan`` with the
    reference's combine and against the plain loop h_t = a_t h_{t-1} +
    bx_t, within 1e-5 (f32)."""
    a, bx = _lru_inputs(s)
    got_a, got_h = rglru.associative_scan(
        rglru._lru_combine, [torch.as_tensor(a), torch.as_tensor(bx)], dim=1)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    want_a, want_h = jax.lax.associative_scan(combine, (a, bx), axis=1)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               rtol=1e-5, atol=1e-5)
    h = np.zeros((2, 8), np.float32)
    loop = []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        loop.append(h)
    np.testing.assert_allclose(got_h.numpy(), np.stack(loop, 1),
                               rtol=1e-5, atol=1e-5)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) beyond torch's threshold
    of 20 too."""
    x = np.array([-80.0, -20.5, -1.0, 0.0, 0.5, 19.0, 20.5, 30.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=0)


def test_sinusoid_matches_reference():
    """Equal up to the exponential: XLA's ``exp`` and torch's differ by
    an ulp (6e-8 relative) at some frequencies, which an angle of ~1000
    radians carries into its sine as ~6e-5."""
    pos = np.arange(40)[None, :] + np.array([[0], [1000]])
    for d in (2, 64, 512):
        got = whisper._sinusoid(torch.as_tensor(pos), d).numpy()
        want = np.asarray(ref_whisper._sinusoid(jnp.asarray(pos), d))
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=4e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=1040 * 1.2e-7)


# ---------------------------------------------------------------------------
# Published configs, trees, folding, the engine target
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    cfg = get_config(arch)
    assert cfg.param_count() == ref_config(arch).param_count() == PARAMS[arch]
    assert cfg.active_param_count() == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Keys, stacked shapes and dtypes leaf for leaf, so
    ``params_from_reference`` fills the tree ``Model.init`` makes and a
    serialized tree loads back in the same order."""
    want = jax.eval_shape(
        lambda: ref_model(ref_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0)))
    got = get_model(get_config(arch, smoke=True)).init(device="meta")
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = PC.tree_flatten(got)
    assert [p for p, _ in got_flat] == [
        "/".join(k.key for k in path) for path, _ in want_flat]
    for (_, g), (_, w) in zip(got_flat, want_flat):
        assert tuple(g.shape) == tuple(w.shape)
        assert PC.dtype_name(g.dtype) == str(w.dtype)


def test_init_constants_match_reference(params):
    """The leaves the reference initialises to constants (mamba2's
    ``a_log``/``d_skip``, the RG-LRU's ``a_param``, LayerNorm's gains)
    are the same in the port's own init."""
    arch, rp, _ = params
    got = dict(PC.tree_flatten(
        get_model(get_config(arch, smoke=True)).init(0, "cpu")))
    rflat = jax.tree_util.tree_flatten_with_path(rp)[0]
    n = 0
    for path, r in rflat:
        key = "/".join(k.key for k in path)
        if any(w in key for w in ("a_log", "d_skip", "a_param", "/g",
                                  "conv_b", "norm", "ln")):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(r),
                                       rtol=1e-6, atol=0, err_msg=key)
            n += 1
    assert n > 0


def test_fold_norms_note_matches_reference(params):
    arch, rp, pp = params
    _, r_rep = ref_fold_norms(ref_config(arch, smoke=True), rp)
    out, p_rep = fold_norms(get_config(arch, smoke=True), pp)
    assert p_rep == r_rep and out is pp


def test_engine_roundtrip_gives_equal_logits(params):
    arch, _, pp = params
    cfg = get_config(arch, smoke=True)
    for precision in ("exact", "bf16"):
        exe = repro_torch.compile(cfg, target="engine", device="cpu",
                                  precision=precision,
                                  params=pp)
        back = repro_torch.deserialize(exe.serialize())
        assert back.cfg == cfg
        for (path, g), (_, w) in zip(PC.tree_flatten(back.params),
                                     PC.tree_flatten(exe.params)):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        batch = make_batch(cfg, B, 12, seed=8)
        assert exe.signature.input_names == ("tokens",) + tuple(
            k for k in batch if k != "tokens")
        assert torch.equal(back(**batch)["logits"], exe(**batch)["logits"])
