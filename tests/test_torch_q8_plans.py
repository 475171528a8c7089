"""The redesigned int8 kernel's plan and split, and fast_act's host side.

``fused_matmul_q8`` (``csrc/fused_matmul_q8.cu``) runs the plan of
``kernels/fused_matmul/kernel.py::plan_q8``: a GEMV path for M <= 16 and
s8 ``mma.sync`` tiles above, K split across blocks and summed in int32.
The kernel cannot run here, so the plan is tested as the pure function it
is (the kernel's index map over it covers every output once), and the
split's plain emulation (``fused_matmul_q8_split_ref``) meets the
single-pass plain version and the JAX reference's ``fused_matmul_q8_p``
in interpret mode on the same numpy inputs.  All comparisons are
bit-equal: the int32 sums are exact in any order and the dequant and
epilogue are the same rounded f32 operations.  With a bias the reference
is its plain (lax) path: its Pallas kernel in interpret mode contracts
``acc * deq + bias`` into one FMA (ROADMAP C).

``fast_act`` (``csrc/fast_act.cu``) loads 16 bytes a thread from x's
first 16-byte boundary; its wrapper allocates the output in x's phase.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import qmath as ref_qmath
from repro.kernels.fused_matmul.ops import fused_matmul_q8 as ref_fused_matmul_q8

from repro_torch.kernels import qmath
from repro_torch.kernels.fast_act import kernel as fa_kernel
from repro_torch.kernels.fast_act import ref as fa_ref
from repro_torch.kernels.fast_act.ops import fast_act
from repro_torch.kernels.fused_matmul import kernel as fm_kernel
from repro_torch.kernels.fused_matmul import ref as fm_ref
from repro_torch.kernels.tiles import (GEMV_MAX_M, Q8_BK, Q8_GEMV_CHUNKS,
                                       Q8_GEMV_MAX_THREADS, Q8_GEMV_X_BYTES,
                                       Q8_MAX_KSPLIT, Q8_TILED_THREADS,
                                       Q8_TILES,
                                       STATIC_SMEM_BYTES, ceil_to)

#: The int8 path's dense shapes (K, N), as chip_smoke.py drives them.
MAIN_DENSE_KN = [(128, 16), (16, 4), (256, 32), (32, 2), (256, 128),
                 (128, 128), (128, 10)]


def _coverage(p, m, n):
    """How many blocks of plan ``p`` store each output element, following
    the kernel's index map (GEMV: all rows, ``block[1]`` columns a block
    along gridDim.x; tiled: ``block`` tiles over gridDim.x/y); gridDim.y
    (GEMV) or .z (tiled) are the K splits, reduced by one block a tile."""
    count = np.zeros((m, n), np.int64)
    rows, cols = (m, p.block[1]) if p.path == "gemv" else p.block
    gy = 1 if p.path == "gemv" else p.grid[1]
    for by in range(gy):
        for bx in range(p.grid[0]):
            count[by * rows:(by + 1) * rows, bx * cols:(bx + 1) * cols] += 1
    return count


_PLAN_SHAPES = ([(m, k, n) for k, n in MAIN_DENSE_KN for m in (1, 16, 17, 256)]
                + [(300, 257, 130), (33, 256, 128), (256, 2048, 128),
                   (1, 2048, 96), (7, 1000, 9), (2, 0, 5), (100000, 3, 1)])


@pytest.mark.parametrize("m,k,n", _PLAN_SHAPES)
@pytest.mark.parametrize("w_layout", ["io", "oi"])
def test_plan_q8_covers_every_output_once(m, k, n, w_layout):
    p = fm_kernel.plan_q8(m, k, n, w_layout=w_layout)
    assert p.path == ("gemv" if m <= GEMV_MAX_M else "tiled")
    assert (_coverage(p, m, n) == 1).all()
    # The K splits tile [0, K) in order, each edge on a Q8_BK step.
    edges = p.split_edges(k)
    assert edges[0][0] == 0 and edges[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(edges, edges[1:]))
    assert all(k0 < k1 for k0, k1 in edges) or k == 0
    assert p.ksplit % Q8_BK == 0 and p.splits <= 65535
    assert p.grid[2 if p.path == "tiled" else 1] == p.splits
    assert p.smem_bytes <= STATIC_SMEM_BYTES
    if p.path == "tiled":
        assert p.block in Q8_TILES and p.ksplit <= Q8_MAX_KSPLIT
        assert p.threads == Q8_TILED_THREADS[min(k, p.ksplit)
                                             >= fm_kernel.Q8_WIDE_K]
        assert p.grid[1] <= 65535 and m <= fm_kernel.MAX_M_Q8
    else:   # the staged q(x) fits its buffer; the lanes split a warp
        assert fm_kernel.gemv_rows(m) * ceil_to(p.ksplit, 16) <= Q8_GEMV_X_BYTES
        if w_layout == "oi":
            lanes = p.lanes
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
            assert p.threads % 32 == 0 and p.threads <= Q8_GEMV_MAX_THREADS
            assert p.block[1] == p.threads // lanes
            chunks = -(-min(k, p.ksplit) // 16)
            assert chunks <= lanes * Q8_GEMV_CHUNKS or lanes == 32
        else:
            assert p.lanes == 0 and p.block[1] == 32


@pytest.mark.parametrize("k,n", MAIN_DENSE_KN)
def test_q8_main_path_shapes_get_the_paths_named(k, n):
    """What the kernel's note and PERF.md name for the int8 path ("oi",
    as the layout pass stores every Table-1 int8 site): M=1 takes the
    GEMV path, a column on part of a warp, each lane one or two 16-byte
    loads; M=256 the s8 mma tiles with the whole K range of a block
    staged at once.  No main-path K (<= 256) is split: a split costs the
    reducing block more than it saves at these depths (the sweep's
    readings in PERF.md).  dense_39 (M=256 K=256 N=128) runs on 64
    blocks, not the 8 of the kernel it replaces, and at M=1 on 16."""
    p1 = fm_kernel.plan_q8(1, k, n, w_layout="oi")
    assert p1.path == "gemv" and p1.lanes < 32
    assert -(-min(k, p1.ksplit) // 16) <= p1.lanes * Q8_GEMV_CHUNKS
    p = fm_kernel.plan_q8(256, k, n, w_layout="oi")
    assert p.path == "tiled" and p.ksplit <= Q8_MAX_KSPLIT
    for q in (p1, p):
        assert q.splits == 1 or q.ksplit >= fm_kernel.Q8_MIN_KSPLIT
        assert (q.blocks >= fm_kernel.Q8_TARGET_BLOCKS
                or (q.splits + 1) * fm_kernel.Q8_MIN_KSPLIT > k)
    assert p.splits == p1.splits == 1
    if (k, n) == (256, 128):
        assert p.blocks == 64 and p1.blocks == 16 and p1.lanes == 8


def _q8_operands(m, k, n, w_layout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_io = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    w = w_io if w_layout == "io" else np.ascontiguousarray(w_io.T)
    b = rng.standard_normal(n).astype(np.float32)
    xs = ref_qmath.tensor_scale(float(np.abs(x).max()) * 0.8)  # some clip
    ws = ref_qmath.channel_scales(w_io, 1)
    return x, w, b, xs, ws


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (16, 256, 32),
                                   (17, 257, 40), (256, 256, 128),
                                   (1, 2048, 96), (64, 130, 10), (33, 16, 4)])
@pytest.mark.parametrize("w_layout", ["io", "oi"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_q8_split_is_bit_equal_to_single_pass_and_reference(m, k, n, w_layout,
                                                            with_bias):
    x, w, b, xs, ws = _q8_operands(m, k, n, w_layout, seed=m * 7 + k + n)
    b = b if with_bias else None
    wq, deq = qmath.quantize_weight(torch.from_numpy(w), xs, ws, w_layout)
    xq = qmath.quantize_q8(torch.from_numpy(x), xs)
    bt = None if b is None else torch.from_numpy(b)
    p = fm_kernel.plan_q8(m, k, n, w_layout=w_layout)
    kw = dict(fn="relu", w_layout=w_layout)
    got = fm_ref.fused_matmul_q8_split_ref(xq, wq, deq, bt, splits=p.splits,
                                           ksplit=p.ksplit, **kw)
    one = fm_ref.fused_matmul_q8_ref(xq, wq, deq, bt, **kw)
    want = np.asarray(ref_fused_matmul_q8(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        x_scale=xs, w_scales=ws, use_pallas=not with_bias, **kw))
    assert torch.equal(got, one)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_q8_split_sums_int32_partials(splits):
    """Each split's partial is an exact int32 sum over its K range; any
    split gives the single pass's bits."""
    x, w, b, xs, ws = _q8_operands(9, 256, 12, "io", seed=splits)
    wq, deq = qmath.quantize_weight(torch.from_numpy(w), xs, ws, "io")
    xq = qmath.quantize_q8(torch.from_numpy(x), xs)
    ksplit = ceil_to(-(-256 // splits), Q8_BK)
    got = fm_ref.fused_matmul_q8_split_ref(xq, wq, deq, splits=-(-256 // ksplit),
                                           ksplit=ksplit)
    acc = sum((xq[:, i:i + ksplit].int() @ wq[i:i + ksplit].int()
               for i in range(ksplit, 256, ksplit)),
              xq[:, :ksplit].int() @ wq[:ksplit].int())
    assert torch.equal(got, acc.float() * deq)
    assert torch.equal(got, fm_ref.fused_matmul_q8_ref(xq, wq, deq))


# ---------------------------------------------------------------------------
# fast_act: the output in x's 16-byte phase
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 3, 5])
def test_fast_act_output_shares_the_inputs_phase(dtype, offset):
    """A view ``offset`` elements into its storage is contiguous; the
    output starts as far past a 16-byte boundary, so the kernel's vector
    loads and stores line up, and the plain version gives the same
    values as on the whole tensor."""
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.standard_normal(4103).astype(np.float32) * 5)
    base = base.to(dtype)
    x = base.view(-1)[offset:offset + 4097]
    assert x.is_contiguous()
    y = fa_kernel.empty_in_phase(x)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    for fn in ("exp", "tanh", "sigmoid"):
        got = fast_act(x, fn)
        want = fa_ref.FAST[fn](x.float()).to(dtype)
        assert torch.equal(got, want)
