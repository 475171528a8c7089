"""The port's kernel modules against the JAX reference's kernels.

On the CPU each wrapper runs its plain torch version, which is what the
CUDA kernel is held to on the card (``chip_smoke.py``).  Here the plain
versions meet the reference's Pallas kernels run in interpret mode on
the same numpy inputs.  Tolerance 1e-5 absolute plus 1e-5 relative:
the reference already drifts from itself by ~1e-7 (ROADMAP C), and the
fast exp reaches e^9 on these inputs, where one f32 ulp is ~1e-3.  The
fast exp against the reference's compiled kernel needs more (EXP_TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.fast_act import ref as ref_fa_ref
from repro.kernels.fast_act.ops import fast_act as ref_fast_act
from repro.kernels.fast_act.ops import fast_softmax as ref_fast_softmax
from repro.kernels.fused_matmul.ops import fused_matmul as ref_fused_matmul

from repro_torch.kernels.fast_act import ref as fa_ref
from repro_torch.kernels.fast_act.ops import fast_act, fast_softmax
from repro_torch.kernels.fused_matmul.ops import fused_matmul

TOL = dict(rtol=1e-5, atol=1e-5)
#: The Schraudolph exp against the reference's compiled code: XLA on the
#: CPU contracts ``A*x + (B-C)`` into one FMA, which rounds the ~2^30
#: intermediate once instead of twice and can move the integer by one f32
#: ulp of it (128), i.e. 2^-16 of the result.  The reference drifts from
#: its own eager jnp form by exactly that (ROADMAP C); the port's plain
#: form is bit-equal to the eager one (test_fast_forms_bit_equal_*).
EXP_TOL = dict(rtol=2.0 ** -15, atol=1e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _both(x, w, b=None, s=None, o=None, **kw):
    want = ref_fused_matmul(x, w, b, s, o, use_pallas=True, **kw)
    got = fused_matmul(_t(x), _t(w), _t(b), _t(s), _t(o), **kw)
    return np.asarray(want, np.float32), got.numpy()


# ---------------------------------------------------------------------------
# fused matmul + epilogue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (32, 64, 48), (1, 128, 256),
                                   (100, 30, 17)])
@pytest.mark.parametrize("fn", [None, "relu", "tanh"])
@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_fused_matmul_sweep(m, k, n, fn, w_layout):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n) if w_layout == "io" else (n, k))
         * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want, got = _both(x, w, b, fn=fn, w_layout=w_layout)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["relu6", "leaky_relu", "hard_sigmoid", "elu",
                                "sigmoid"])
@pytest.mark.parametrize("fast", [False, True])
def test_fused_matmul_epilogues(fn, fast):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 40)) * 2).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32) * 0.3
    b = rng.standard_normal(24).astype(np.float32)
    attrs = {"alpha": 0.2} if fn == "leaky_relu" else {}
    want, got = _both(x, w, b, fn=fn, fast=fast, w_layout="oi", attrs=attrs)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["tanh", "sigmoid"])
@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_fused_matmul_fast_forms(fn, w_layout):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((33, 20)) * 3).astype(np.float32)
    w = rng.standard_normal((20, 7) if w_layout == "io" else (7, 20)) \
        .astype(np.float32)
    want, got = _both(x, w, None, fn=fn, fast=True, w_layout=w_layout)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_fused_matmul_affine_epilogue(w_layout):
    """Folded-BN scale/offset after the activation (paper §3.5)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 24) if w_layout == "io" else (24, 32))
         * 0.1).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    o = rng.standard_normal(24).astype(np.float32)
    want, got = _both(x, w, b, s, o, fn="relu", w_layout=w_layout)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_fused_matmul_bf16_operands(w_layout):
    """bf16 operands, f32 accumulation and output, in both packages."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((16, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 32) if w_layout == "io"
                                        else (32, 64)) * 0.1, jnp.bfloat16)
    b = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(ref_fused_matmul(x, w, b, fn="relu", w_layout=w_layout,
                                       use_pallas=True))
    xt = _t(np.asarray(x, np.float32)).to(torch.bfloat16)
    wt = _t(np.asarray(w, np.float32)).to(torch.bfloat16)
    got = fused_matmul(xt, wt, _t(b), fn="relu", w_layout=w_layout)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_matmul_higher_rank():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    want, got = _both(x, w)
    assert got.shape == (2, 3, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError):
        fused_matmul(x, w, w_layout="ko")
    with pytest.raises(ValueError):
        fused_matmul(x, torch.zeros(5, 3))
    with pytest.raises(ValueError):
        fused_matmul(x, w, None, torch.ones(3), None)
    with pytest.raises(NotImplementedError):
        fused_matmul(x, w, fn="gelu")
    # A tensor on neither the CPU nor CUDA: no silent plain version.
    with pytest.raises(ValueError, match="unsupported device"):
        fused_matmul(x.to("meta"), w.to("meta"))
    assert fused_matmul.launches == 0


# ---------------------------------------------------------------------------
# fast activations (paper §3.4)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["exp", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", [(16,), (4, 33), (2, 3, 5), (300, 129)])
def test_fast_act_matches_reference_kernel(fn, shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    want = np.asarray(ref_fast_act(jnp.asarray(x), fn, use_pallas=True))
    got = fast_act(_t(x), fn).numpy()
    np.testing.assert_allclose(got, want, **(EXP_TOL if fn == "exp" else TOL))


@pytest.mark.parametrize("fn", ["exp", "tanh", "sigmoid"])
def test_fast_act_bf16_matches_reference_kernel(fn):
    """bf16 in and out, f32 inside, rounded once on the way out."""
    rng = np.random.default_rng(9)
    xb = jnp.asarray(rng.standard_normal((8, 130)) * 3, jnp.bfloat16)
    want = np.asarray(ref_fast_act(xb, fn, use_pallas=True), np.float32)
    got = fast_act(_t(np.asarray(xb, np.float32)).to(torch.bfloat16), fn)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fn", ["exp", "tanh", "sigmoid"])
def test_fast_forms_bit_equal_reference_ref(fn):
    """The plain torch forms round like the reference's jnp forms, over
    the whole range including both clamps."""
    x = np.linspace(-120.0, 120.0, 48001, dtype=np.float32)
    want = np.asarray(ref_fa_ref.FAST[fn](jnp.asarray(x)))
    got = fa_ref.FAST[fn](_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [-1, 1])
def test_fast_softmax_matches_reference(axis):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((8, 64)) * 5).astype(np.float32)
    want = np.asarray(ref_fast_softmax(jnp.asarray(x), axis=axis,
                                       use_pallas=True))
    got = fast_softmax(_t(x), axis=axis).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fast_act_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        fast_act(torch.zeros(3), "gelu")
    with pytest.raises(ValueError, match="unsupported device"):
        fast_act(torch.zeros(3, device="meta"), "exp")
    assert fast_act.launches == 0
