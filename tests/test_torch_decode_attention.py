"""The port's decode attention against the JAX reference's.

Same numpy inputs through both packages on the CPU, where the wrapper
runs a plain form: the one-pass softmax (the reference's ``jit`` and
``interpret`` targets) or the online softmax over 512-row tiles (the
reference's Pallas kernel in interpret mode, which the CUDA kernel
follows).  Tolerances, each with its reason:

* exact: rtol 2e-5, atol 2e-6, the reference's own bound between its
  targets (``tests/test_registry.py``): f32 sums in another order.
* fast: rtol 2^-15, atol 1e-5 (``EXP_TOL`` of the kernel tests).  XLA
  contracts the reference's Schraudolph ``A*x + (B-C)`` into one FMA,
  which moves each exp by up to 2^-16 (ROADMAP C), and so an output of
  unit size by up to ~1.5e-5; the port rounds after every operation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
from repro.core import ModelBuilder as RefBuilder
from repro.kernels.decode_attention import ref as ref_da
from repro.kernels.decode_attention.ops import decode_attention as ref_decode

import repro_torch
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.decode_attention.ops import decode_attention

EXACT_TOL = dict(rtol=2e-5, atol=2e-6)
FAST_TOL = dict(rtol=2.0 ** -15, atol=1e-5)


def _qkv(b, h, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,h,hkv,d,s", [(2, 4, 2, 16, 64), (1, 8, 1, 32, 100),
                                         (3, 6, 6, 8, 48)])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_one_pass_form_matches_reference_ref(b, h, hkv, d, s, with_lengths):
    q, k, v = _qkv(b, h, hkv, d, s, seed=b * 100 + s)
    lengths = (np.asarray([s - i * 7 for i in range(b)], np.int32).clip(1)
               if with_lengths else None)
    want = np.asarray(ref_da.decode_attention_ref(
        q, k, v, None if lengths is None else jnp.asarray(lengths)))
    got = da_ref.decode_attention_ref(
        *_t(q, k, v), None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, **EXACT_TOL)
    # The wrapper on the CPU takes the one-pass form when exact, and fills
    # in every row when lengths are missing.
    wrapped = decode_attention(
        *_t(q, k, v), None if lengths is None else torch.from_numpy(lengths))
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("lengths", [[1100, 700], [1024, 513], [1, 1100]])
def test_tiled_form_matches_reference_kernel(fast, lengths):
    """D=128, S=1100: three 512-row tiles, the last ragged; lengths that
    end inside a tile, on a tile edge, and at the first row."""
    q, k, v = _qkv(2, 8, 2, 128, 1100, seed=7)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(ref_decode(q, k, v, jnp.asarray(lens), fast=fast,
                                 use_pallas=True))
    got = da_ref.decode_attention_tiled(*_t(q, k, v), torch.from_numpy(lens),
                                        fast=fast)
    np.testing.assert_allclose(got.numpy(), want,
                               **(FAST_TOL if fast else EXACT_TOL))
    if fast:
        # The CPU wrapper takes the tiled form under fast, as the kernel does.
        assert torch.equal(decode_attention(*_t(q, k, v),
                                            torch.from_numpy(lens), fast=True),
                           got)


def test_fast_forms_differ_as_the_reference_targets_do():
    """Under fast the one-pass and tiled forms are different functions
    (the Schraudolph exp does not compose); each matches its own
    reference counterpart, and they are further apart than either is
    from it."""
    q, k, v = _qkv(1, 4, 1, 128, 1100, seed=8)
    q = q * 4.0                      # sharp scores, so alpha matters
    lens = np.asarray([1100], np.int32)
    one = da_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens),
                                      fast=True).numpy()
    tiled = da_ref.decode_attention_tiled(*_t(q, k, v), torch.from_numpy(lens),
                                          fast=True).numpy()
    want_one = np.asarray(ref_da.decode_attention_ref(
        q, k, v, jnp.asarray(lens), fast=True))
    want_tiled = np.asarray(ref_decode(q, k, v, jnp.asarray(lens), fast=True,
                                       use_pallas=True))
    np.testing.assert_allclose(one, want_one, **FAST_TOL)
    np.testing.assert_allclose(tiled, want_tiled, **FAST_TOL)
    assert np.abs(one - tiled).max() > np.abs(tiled - want_tiled).max()


@pytest.mark.parametrize("form", ["one_pass", "tiled"])
def test_rows_past_a_length_do_not_change_the_output(form):
    q, k, v = _qkv(2, 4, 2, 16, 700, seed=9)
    lens = torch.tensor([600, 10], dtype=torch.int32)
    fn = (da_ref.decode_attention_ref if form == "one_pass"
          else da_ref.decode_attention_tiled)
    out1 = fn(*_t(q, k, v), lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 600:], v2[0, 600:] = 99.0, -99.0
    k2[1, 10:], v2[1, 10:] = -99.0, 99.0
    out2 = fn(*_t(q, k2, v2), lens)
    assert torch.equal(out1, out2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _t(*_qkv(1, 4, 2, 8, 16, seed=10))
    with pytest.raises(ValueError):
        decode_attention(q, k, v[:, :8])
    with pytest.raises(ValueError):
        decode_attention(q[:, :3], k, v)                 # H % Hkv != 0
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                         torch.full((1,), 16, dtype=torch.int32, device="meta"))
    assert decode_attention.launches == 0


# ---------------------------------------------------------------------------
# the graph op on every target
# ---------------------------------------------------------------------------
def _graph(builder, h=8, hkv=2, d=128, s=1100, lengths=True):
    mb = builder()
    q = mb.input((h, d), name="q")
    k = mb.input((s, hkv, d), name="k")
    v = mb.input((s, hkv, d), name="v")
    ins = [q, k, v]
    if lengths:
        ins.append(mb.input((), name="lens", dtype="int32"))
    return mb.build([mb.decode_attention(*ins)])


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("ref_target,port_target", [
    ("interpret", "interpret"), ("jit", "jit"), ("pallas", "cuda")])
@pytest.mark.parametrize("lengths", [True, False])
def test_op_matches_reference_on_every_target(ref_target, port_target,
                                              precision, lengths):
    """At D=128 the reference's pallas target runs its kernel (the tiled
    form) and its other targets the one-pass form; the port's targets
    follow the same split.  The oracle is exact at either precision."""
    ref_g, port_g = _graph(RefBuilder, lengths=lengths), \
        _graph(repro_torch.ModelBuilder, lengths=lengths)
    q, k, v = _qkv(2, 8, 2, 128, 1100, seed=11)
    feeds = {"q": q, "k": k, "v": v}
    if lengths:
        feeds["lens"] = np.asarray([1100, 600], np.int32)
    want = repro.compile(ref_g, repro.CompileOptions(
        target=ref_target, precision=precision))(**feeds)
    exe = repro_torch.compile(port_g, target=port_target,
                              precision=precision, device="cpu")
    got = exe(**feeds)
    tol = FAST_TOL if precision == "fast" and ref_target != "interpret" \
        else EXACT_TOL
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **tol)
    if port_target == "cuda":
        (choice,) = exe.cost_summary()["kernel_selection"][2]
        assert choice["kernel"] == "cuda.decode_attention"
        assert "H=8 Hkv=2 D=128 S=1100" in choice["reason"]


@pytest.mark.parametrize("target,calls", [("jit", 0), ("interpret", 0),
                                          ("cuda", 1)])
def test_cuda_target_sends_every_decode_node_to_the_wrapper(
        monkeypatch, target, calls):
    from repro_torch.core import lowering

    seen = []

    def counted(*a, **kw):
        seen.append(kw.get("fast"))
        return wrapped(*a, **kw)

    wrapped = lowering.decode_attention
    monkeypatch.setattr(lowering, "decode_attention", counted)
    g = _graph(repro_torch.ModelBuilder, d=16, s=40)
    q, k, v = _qkv(2, 8, 2, 16, 40, seed=12)
    exe = repro_torch.compile(g, target=target, precision="fast", device="cpu")
    for _ in range(2):
        exe(q=q, k=k, v=v, lens=np.asarray([40, 3], np.int32))
    assert seen == [True] * (2 * calls)


def test_decode_op_compiles_at_any_head_dim_on_cuda():
    """The reference's lane gate (D % 128) has no counterpart: D=64 runs
    the kernel's tiled form on ``cuda``, where the reference's pallas
    target falls back to its one-pass form (ROADMAP C)."""
    g = _graph(repro_torch.ModelBuilder, h=4, hkv=1, d=64, s=600)
    exe = repro_torch.compile(g, target="cuda", precision="fast", device="cpu")
    q, k, v = _qkv(1, 4, 1, 64, 600, seed=13)
    lens = np.asarray([600], np.int32)
    got = exe(q=q, k=k, v=v, lens=lens)
    want = da_ref.decode_attention_tiled(*_t(q, k, v), torch.from_numpy(lens),
                                         fast=True)
    assert torch.equal(next(iter(got.values())), want)
    assert exe.cost_summary()["kernel_selection"][1][0]["kernel"] \
        == "cuda.decode_attention"
