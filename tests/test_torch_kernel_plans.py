"""The algorithms of the port's redesigned CUDA kernels, in plain torch.

``fused_matmul`` splits K across blocks and sums the partials in split
order; ``decode_attention`` splits S into chunks of 512-row tiles and
combines them in chunk order.  The CUDA kernels cannot run here, so their
algorithms' plain emulations (``fused_matmul_split_ref``,
``decode_attention_split``) meet the single-pass plain versions and the
JAX reference's Pallas kernels in interpret mode on the same numpy
inputs, and the host's plans are tested as the pure functions they are.
Tolerances, each with its reason:

* matmul: 1e-5 absolute plus relative, as ``test_torch_kernels.py``:
  f32 sums in another order.
* decode attention, ``EXACT_TOL`` and ``FAST_TOL`` of
  ``test_torch_decode_attention.py``: f32 sums in another order; under
  fast, the reference's XLA contracts the Schraudolph exp into an FMA
  (ROADMAP C).  The split keeps every p and alpha of the tiled form, so
  it stays that close to it even on sharp scores, where the one-pass
  form is ~1e-2 away.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as ref_decode
from repro.kernels.fused_matmul.ops import fused_matmul as ref_fused_matmul

from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.fused_matmul import kernel as fm_kernel
from repro_torch.kernels.fused_matmul import ref as fm_ref
from repro_torch.kernels.tiles import (CUDA_BLOCK, GEMV_MAX_M,
                                       SMEM_BUDGET_BYTES, STATIC_SMEM_BYTES)

TOL = dict(rtol=1e-5, atol=1e-5)
EXACT_TOL = dict(rtol=2e-5, atol=2e-6)
FAST_TOL = dict(rtol=2.0 ** -15, atol=1e-5)
#: The compiler's main-path dense shapes (K, N), as chip_smoke.py drives them.
MAIN_DENSE_KN = [(128, 16), (16, 4), (256, 32), (32, 2), (256, 128),
                 (128, 128), (128, 10)]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# fused_matmul: split K
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (16, 256, 32), (17, 257, 40),
                                   (256, 256, 128), (1, 2048, 96),
                                   (64, 130, 10)])
@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_split_k_matches_single_pass_and_reference_kernel(m, k, n, w_layout):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n) if w_layout == "io" else (n, k))
         * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    s = rng.uniform(0.5, 1.5, n).astype(np.float32)
    o = rng.standard_normal(n).astype(np.float32)
    p = fm_kernel.plan(m, k, n, w_layout=w_layout)
    kw = dict(fn="relu", w_layout=w_layout)
    got = fm_ref.fused_matmul_split_ref(*_t(x, w, b, s, o), splits=p.splits,
                                        ksplit=p.ksplit, **kw)
    one = fm_ref.fused_matmul_ref(*_t(x, w, b, s, o), **kw)
    want = np.asarray(ref_fused_matmul(x, w, b, s, o, use_pallas=True, **kw))
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_k_sums_in_split_order(splits):
    """Each split's partial is one matmul over its K range; the order of
    the sum is fixed, so the result is the same from call to call."""
    rng = np.random.default_rng(splits)
    x, w = _t(rng.standard_normal((5, 256)).astype(np.float32),
              rng.standard_normal((256, 12)).astype(np.float32))
    ksplit = -(-256 // splits)
    got = fm_ref.fused_matmul_split_ref(x, w, splits=splits, ksplit=ksplit)
    want = sum((x[:, i * ksplit:(i + 1) * ksplit]
                @ w[i * ksplit:(i + 1) * ksplit] for i in range(1, splits)),
               x[:, :ksplit] @ w[:ksplit])
    assert torch.equal(got, want)
    assert torch.equal(got, fm_ref.fused_matmul_split_ref(
        x, w, splits=splits, ksplit=ksplit))


_PLAN_SHAPES = ([(m, k, n) for k, n in MAIN_DENSE_KN for m in (1, 256)]
                + [(m, 256, 128) for m in (1, 16, 17, 256)]
                + [(256, 2048, 128), (1, 2048, 96), (300, 257, 130),
                   (2, 0, 5), (100000, 3, 1)])


@pytest.mark.parametrize("m,k,n", _PLAN_SHAPES)
@pytest.mark.parametrize("w_layout", ["io", "oi"])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_covers_every_output_once(m, k, n, w_layout, itemsize):
    p = fm_kernel.plan(m, k, n, w_layout=w_layout, itemsize=itemsize)
    assert p.path == ("gemv" if m <= GEMV_MAX_M else "tiled")
    rows, cols = (m, p.block[1]) if p.path == "gemv" else p.block
    gy = 1 if p.path == "gemv" else p.grid[1]
    # Each output row and column lies in exactly one block tile.
    assert (p.grid[0] - 1) * cols < n <= p.grid[0] * cols
    assert (gy - 1) * rows < m <= gy * rows
    # The K splits tile [0, K) in order, each edge on a SPLIT_ALIGN step.
    edges = p.split_edges(k)
    assert edges[0][0] == 0 and edges[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(edges, edges[1:]))
    assert all(k0 < k1 for k0, k1 in edges) or k == 0
    assert p.ksplit % fm_kernel.SPLIT_ALIGN == 0
    assert p.grid[2 if p.path == "tiled" else 1] == p.splits
    assert p.smem_bytes <= min(SMEM_BUDGET_BYTES, STATIC_SMEM_BYTES)
    if p.path == "gemv":   # the staged x fits the kernel's buffer
        assert fm_kernel.gemv_rows(m) * p.ksplit * 4 <= p.smem_bytes
    else:
        assert p.ksplit % CUDA_BLOCK[1] == 0 and p.splits <= fm_kernel.MAX_SPLITS


@pytest.mark.parametrize("k,n", MAIN_DENSE_KN)
def test_main_path_shapes_get_the_paths_named(k, n):
    """M=1 runs the GEMV path and M=256 the tiled one; the split brings
    the grid to the plan's target of blocks unless one more split would
    be shallower than MIN_KSPLIT (M=256 N=128: 64 blocks, not the 8 of
    one 64x64 tile each)."""
    for m, path in ((1, "gemv"), (256, "tiled")):
        p = fm_kernel.plan(m, k, n, w_layout="oi")
        assert p.path == path
        assert (p.blocks >= fm_kernel.TARGET_BLOCKS
                or (p.splits + 1) * fm_kernel.MIN_KSPLIT > k)
        assert p.splits == 1 or p.ksplit >= fm_kernel.MIN_KSPLIT
    assert fm_kernel.plan(256, 256, 128).blocks >= 64


# ---------------------------------------------------------------------------
# decode_attention: S split into chunks
# ---------------------------------------------------------------------------
def _qkv(b, h, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("lengths", [[1100, 700], [1024, 513], [1, 1100]])
@pytest.mark.parametrize("tpc", [1, 2, 3])
def test_split_matches_tiled_form_and_reference_kernel(tpc, lengths, fast):
    """D=128, S=1100: three 512-row tiles, the last ragged; at two tiles
    a chunk S is not a multiple of the chunk.  Lengths end inside a tile,
    on a tile edge, and at the first row."""
    q, k, v = _qkv(2, 8, 2, 128, 1100, seed=7)
    lens = np.asarray(lengths, np.int32)
    got = da_ref.decode_attention_split(*_t(q, k, v), torch.from_numpy(lens),
                                        tiles_per_chunk=tpc, fast=fast)
    tiled = da_ref.decode_attention_tiled(*_t(q, k, v),
                                          torch.from_numpy(lens), fast=fast)
    want = np.asarray(ref_decode(q, k, v, jnp.asarray(lens), fast=fast,
                                 use_pallas=True))
    tol = FAST_TOL if fast else EXACT_TOL
    np.testing.assert_allclose(got.numpy(), tiled.numpy(), **tol)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("tpc", [1, 2, 3])
def test_split_keeps_the_fast_semantics_on_sharp_scores(tpc):
    """Sharp scores (q x 4), where alpha matters: the split stays with the
    tiled form and the reference's kernel, far closer than the one-pass
    form, which is another function under fast."""
    q, k, v = _qkv(1, 4, 1, 128, 1100, seed=8)
    q = q * 4.0
    lens = np.asarray([1100], np.int32)
    got = da_ref.decode_attention_split(*_t(q, k, v), torch.from_numpy(lens),
                                        tiles_per_chunk=tpc, fast=True).numpy()
    tiled = da_ref.decode_attention_tiled(*_t(q, k, v), torch.from_numpy(lens),
                                          fast=True).numpy()
    one = da_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens),
                                      fast=True).numpy()
    want = np.asarray(ref_decode(q, k, v, jnp.asarray(lens), fast=True,
                                 use_pallas=True))
    np.testing.assert_allclose(got, tiled, **FAST_TOL)
    np.testing.assert_allclose(got, want, **FAST_TOL)
    assert np.abs(one - tiled).max() > 100 * np.abs(got - tiled).max()


def test_split_ignores_rows_past_a_length():
    q, k, v = _qkv(2, 4, 2, 16, 1300, seed=9)
    lens = torch.tensor([600, 10], dtype=torch.int32)
    out1 = da_ref.decode_attention_split(*_t(q, k, v), lens, tiles_per_chunk=1)
    k2, v2 = k.copy(), v.copy()
    k2[0, 600:], v2[0, 600:] = 99.0, float("nan")
    k2[1, 10:], v2[1, 10:] = -99.0, float("nan")
    out2 = da_ref.decode_attention_split(*_t(q, k2, v2), lens,
                                         tiles_per_chunk=1)
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("b,hkv,s", [(1, 8, 32768), (8, 8, 32768),
                                     (2, 1, 4096), (2, 36, 4096), (2, 2, 1500),
                                     (1, 1, 1), (3, 4, 700)])
def test_chunk_plan(b, hkv, s):
    """Chunks are whole 512-row tiles that cover S once; batch 1 at
    qwen2.5-14b's 8 KV heads and S=32768 gives a few hundred blocks."""
    tpc, chunks = da_kernel.chunk_plan(b, hkv, s)
    ntiles = -(-s // da_ref.DEFAULT_BS)
    assert 1 <= tpc <= da_kernel.MAX_TILES_PER_CHUNK
    assert (chunks - 1) * tpc < ntiles <= chunks * tpc
    assert b * hkv * chunks >= da_kernel.TARGET_BLOCKS or tpc == 1
    if (b, hkv, s) == (1, 8, 32768):
        assert 200 <= b * hkv * chunks <= 600
