"""The port's MoE, MLA and attention building blocks against the JAX
package's, on the CPU.

* ``_route``, ``_positions`` and ``moe_apply`` on inputs built to hold
  router scores tied between two experts (``jax.lax.top_k`` takes the
  lower index) and more tokens than an expert's capacity (dropped);
* ``mla_decode`` (the absorbed form) against ``mla_apply`` (the naive
  expansion), and both against the reference's;
* ``chunked_attention`` and ``decode_attention_jnp`` at windows 0 and 7,
  with chunk sizes that do not divide the sequence, soft-capping,
  ``q_offset``, ``causal_skip`` and a row that sees no key;
* the small pieces: norms, rope, ``ring_insert``'s two modes,
  ``cross_entropy``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import common as RC
from repro.models import get_model as ref_model
from repro.models import mla as RMLA
from repro.models import moe as RMOE
from repro_torch.configs import get_config
from repro_torch.models import common as PC
from repro_torch.models import mla as PMLA
from repro_torch.models import moe as PMOE
from repro_torch.weights import params_from_reference

TOL = 1e-5


def T(a, dtype=None):
    """A numpy/jax array as a torch tensor (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def N(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(N(got), N(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# MoE routing, capacity and dispatch
# ---------------------------------------------------------------------------
MOE_ARCHS = {"mixtral-8x22b": "softmax", "deepseek-v3-671b": "sigmoid"}


def _moe_case(arch, moe_cf):
    """Layer 0's FFN params of ``arch`` (f32 activations) with router
    columns 1 and 2 made equal, so every token's scores for experts 1
    and 2 tie, and tokens that repeat, so experts overflow."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               dtype="float32", moe_cf=moe_cf)
    pcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", moe_cf=moe_cf)
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    ffn = jax.tree.map(lambda t: np.array(t[0]), rp["layers"]["ffn"])
    ffn["router"][:, 2] = ffn["router"][:, 1]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, rcfg.d_model)).astype(np.float32)
    x[:, 6:] = x[:, :1]                        # one token six times a row
    return rcfg, pcfg, ffn, params_from_reference(ffn), x


@pytest.mark.parametrize("arch", list(MOE_ARCHS))
def test_route_ties_take_the_lower_expert(arch):
    rcfg, pcfg, ffn, pffn, x = _moe_case(arch, 1.0)
    assert pcfg.router_fn == MOE_ARCHS[arch]
    flat = x.reshape(-1, rcfg.d_model)
    r_idx, r_w, r_aux = RMOE._route(rcfg, jnp.asarray(flat), ffn["router"])
    p_idx, p_w, p_aux = PMOE._route(pcfg, T(flat), pffn["router"])
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
    close(p_w, r_w)
    close(p_aux, r_aux)
    # the tie is really there, and decided by index
    both = np.isin(np.asarray(r_idx), [1, 2]).sum(axis=1) == 2
    assert both.any()
    for row in np.asarray(r_idx)[both]:
        assert list(row).index(1) < list(row).index(2)


def test_top_k_is_stable_on_exact_ties():
    scores = torch.tensor([[0.5, 0.9, 0.9, 0.9, 0.1],
                           [0.2, 0.2, 0.2, 0.2, 0.2]])
    vals, idx = PMOE._top_k(scores, 3)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("arch", list(MOE_ARCHS))
@pytest.mark.parametrize("moe_cf", [0.5, 1.0, 8.0])
def test_positions_and_moe_apply_match_reference(arch, moe_cf):
    rcfg, pcfg, ffn, pffn, x = _moe_case(arch, moe_cf)
    flat = x.reshape(-1, rcfg.d_model)
    r_idx, _, _ = RMOE._route(rcfg, jnp.asarray(flat), ffn["router"])
    r_pos = RMOE._positions(rcfg, r_idx)
    p_pos = PMOE._positions(pcfg, torch.as_tensor(np.array(r_idx)).long())
    np.testing.assert_array_equal(p_pos.numpy(), np.asarray(r_pos))
    cap = max(1, int(flat.shape[0] * rcfg.top_k * moe_cf / rcfg.n_experts))
    if moe_cf < 8.0:
        assert (np.asarray(r_pos) >= cap).any()          # tokens drop
    r_y, r_aux = RMOE.moe_apply(ffn, rcfg, jnp.asarray(x))
    p_y, p_aux = PMOE.moe_apply(pffn, pcfg, T(x))
    close(p_y, r_y)
    close(p_aux, r_aux)


def test_moe_dispatch_is_deterministic():
    _, pcfg, _, pffn, x = _moe_case("mixtral-8x22b", 0.5)
    a, _ = PMOE.moe_apply(pffn, pcfg, T(x))
    b, _ = PMOE.moe_apply(pffn, pcfg, T(x))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MLA: absorbed decode against the naive expansion
# ---------------------------------------------------------------------------
def _mla_case():
    rcfg = dataclasses.replace(ref_config("deepseek-v3-671b", smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                               dtype="float32")
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    attn = jax.tree.map(lambda t: np.asarray(t[0]), rp["layers"]["attn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, attn, params_from_reference(attn), x


def test_mla_apply_matches_reference():
    rcfg, pcfg, attn, pattn, x = _mla_case()
    pos = np.arange(10)[None]
    r_y, (r_c, r_r) = RMLA.mla_apply(attn, rcfg, jnp.asarray(x),
                                     jnp.asarray(pos), jnp.int32(0))
    p_y, (p_c, p_r) = PMLA.mla_apply(pattn, pcfg, T(x), T(pos), 0)
    close(p_y, r_y)
    close(p_c, r_c)
    close(p_r, r_r)


def test_mla_decode_matches_apply_and_reference():
    """Each position's absorbed decode over the latents of the positions
    before it gives the naive expansion's output at that position."""
    rcfg, pcfg, attn, pattn, x = _mla_case()
    s = x.shape[1]
    full, _ = PMLA.mla_apply(pattn, pcfg, T(x), T(np.arange(s)[None]), 0)
    c = torch.zeros((2, s, 1, pcfg.kv_lora_rank))
    r = torch.zeros((2, s, 1, pcfg.qk_rope_dim))
    rc, rr = jnp.zeros(c.shape), jnp.zeros(r.shape)
    for t in range(s):
        lengths = torch.full((2,), t, dtype=torch.int32)
        y, (c, r) = PMLA.mla_decode(pattn, pcfg, T(x[:, t:t + 1]), c, r,
                                    lengths, 0)
        ry, (rc, rr) = RMLA.mla_decode(attn, rcfg, jnp.asarray(x[:, t:t + 1]),
                                       rc, rr, jnp.asarray(lengths.numpy()),
                                       jnp.int32(0))
        close(y[:, 0], full[:, t], tol=1e-4)
        close(y, ry)
    close(c, rc)
    close(r, rr)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _qkv(b, sq, sk, h, hkv, d, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dv or d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("chunks", [(8, 12), (5, 29), (29, 4)])
@pytest.mark.parametrize("causal_skip", [False, True])
def test_chunked_attention_matches_reference(window, chunks, causal_skip):
    q_chunk, kv_chunk = chunks
    q, k, v = _qkv(2, 29, 29, 6, 2, 8, dv=5)
    kw = dict(causal=True, window_arr=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk, causal_skip=causal_skip)
    want = RC.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    got = PC.chunked_attention(T(q), T(k), T(v), **kw)
    close(got, want)


@pytest.mark.parametrize("window", [0, 7])
def test_chunked_attention_offsets_softcap_and_scale(window):
    """A prefill chunk's queries (``q_offset``) over a longer key run,
    soft-capped and scaled, as ``attn_chunk`` calls it."""
    q, k, v = _qkv(1, 6, 23, 4, 4, 8, seed=1)
    kw = dict(causal=True, window_arr=window, q_offset=11, q_chunk=4,
              kv_chunk=10, softcap=2.5, scale=0.3)
    want = RC.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    close(PC.chunked_attention(T(q), T(k), T(v), **kw), want)
    for skip in (False, True):
        close(PC.chunked_attention(T(q), T(k), T(v), causal_skip=skip, **kw),
              want)


def test_chunked_attention_row_without_keys():
    """Queries whose window holds no key at all give the reference's
    output (zeros), not NaN."""
    q, k, v = _qkv(1, 4, 9, 2, 1, 8, seed=2)
    kw = dict(causal=True, window_arr=3, q_offset=40, q_chunk=4, kv_chunk=4)
    want = RC.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    got = PC.chunked_attention(T(q), T(k), T(v), **kw)
    assert not np.isnan(N(want)).any()
    np.testing.assert_array_equal(N(got), N(want))


def test_chunked_attention_bf16_compute():
    q, k, v = _qkv(2, 13, 13, 4, 2, 8, seed=5)
    kw = dict(causal=True, q_chunk=4, kv_chunk=6,
              compute_dtype="bfloat16")
    want = RC.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    close(PC.chunked_attention(T(q), T(k), T(v), **kw), want, tol=1e-4)


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("softcap", [0.0, 3.0])
def test_decode_attention_matches_reference(window, softcap):
    q, k, v = _qkv(3, 1, 29, 6, 2, 8, dv=5, seed=4)
    lengths = np.array([29, 1, 17], np.int32)
    kw = dict(window_arr=window, softcap=softcap)
    want = RC.decode_attention_jnp(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths), **kw)
    got = PC.decode_attention_jnp(T(q[:, 0]), T(k), T(v), T(lengths), **kw)
    close(got, want)


def test_decode_attention_long_cache_matches_reference():
    """A cache long enough that p.V is cut into parts (PV_SPLIT keys)."""
    s = 3 * PC.PV_SPLIT
    q, k, v = _qkv(2, 1, s, 8, 2, 16, seed=9)
    lengths = np.array([s, 1537], np.int32)
    want = RC.decode_attention_jnp(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths))
    got = PC.decode_attention_jnp(T(q[:, 0]), T(k), T(v), T(lengths))
    close(got, want)


def test_decode_attention_is_chunked_attention_at_the_last_row():
    q, k, v = _qkv(1, 17, 17, 4, 2, 8, seed=6)
    for window in (0, 7):
        full = PC.chunked_attention(T(q), T(k), T(v), window_arr=window,
                                    q_chunk=8, kv_chunk=5)
        last = PC.decode_attention_jnp(T(q[:, -1]), T(k), T(v),
                                       torch.tensor([17]), window=window)
        close(last, full[:, -1])


# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["where", "scatter"])
def test_ring_insert_modes_match_reference(mode):
    rng = np.random.default_rng(8)
    cache = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4)).astype(np.float32)
    pos = np.array([0, 7, 4], np.int32)                # 7 wraps to slot 2
    want = RC.ring_insert(jnp.asarray(cache), jnp.asarray(new),
                          jnp.asarray(pos), mode)
    got = T(cache)
    assert PC.ring_insert(got, T(new), T(pos), mode) is got   # in place
    np.testing.assert_array_equal(N(got), N(want))


def test_norms_rope_and_cross_entropy_match_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    g = rng.standard_normal((8,)).astype(np.float32)
    beta = rng.standard_normal((8,)).astype(np.float32)
    close(PC.rms_norm(T(x), T(g), 1e-6), RC.rms_norm(jnp.asarray(x), g, 1e-6))
    close(PC.layer_norm(T(x), T(g), T(beta), 1e-5),
          RC.layer_norm(jnp.asarray(x), g, beta, 1e-5))
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        N(PC.rms_norm(T(xb), T(g), 1e-6)), N(RC.rms_norm(xb, g, 1e-6)))
    pos = np.arange(5)[None] + 4090
    close(PC.apply_rope(T(x), T(pos), 1e6),
          RC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), tol=1e-4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    close(PC.cross_entropy(T(logits), T(labels)),
          RC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
