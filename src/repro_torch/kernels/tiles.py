"""Tile geometry: the reference's TPU granules, and the port's Hopper tile.

Two parts, kept apart on purpose:

* **TPU granules** (``LANE``, ``SUBLANE``, ``ceil_to``).  The layout
  pass (``core/passes/layout.py``) pads dense ``cout`` to a ``LANE``
  multiple exactly as the reference does, so the port's optimized graphs
  stay ``structure_hash``-identical to the JAX package's.  Nothing on
  the GPU tiles against these numbers.
* **Hopper geometry** for the CUDA ``fused_matmul`` and
  ``fused_matmul_q8`` kernels, their plans
  (``kernels/fused_matmul/kernel.py::plan`` and ``plan_q8``) and their
  selector
  (``core/selection.py``): the block tiles the kernels are compiled
  with (``csrc/fused_matmul.cu`` and ``csrc/fused_matmul_q8.cu`` must
  agree), and the shared memory a block may claim on an H100.
"""

from __future__ import annotations

from typing import Tuple

# ---------------------------------------------------------------------------
# TPU granules (graph identity with the reference; see the module note)
# ---------------------------------------------------------------------------
#: MXU/VPU lane width the layout pass pads dense outputs to.
LANE = 128
#: f32 sublane granule; the layout pass stores dense kernels "oi" when a
#: matmul sees fewer rows than this per example.
SUBLANE = 8


def ceil_to(n: int, align: int) -> int:
    """Round ``n`` up to a multiple of ``align``."""
    return -(-n // align) * align


# ---------------------------------------------------------------------------
# Hopper (sm_90a) geometry of the CUDA fused_matmul kernel
# ---------------------------------------------------------------------------
#: The tiled path's output rows, K depth of one shared-memory stage, and
#: output columns (``BM``/``BK``/``BN`` in ``csrc/fused_matmul.cu``).  128
#: threads each hold a 2x4 register sub-tile of the 32x32 output tile.
CUDA_BLOCK: Tuple[int, int, int] = (32, 32, 32)   # (bm, bk, bn)
#: Stages of the tiled path's cp.async ring (``kStages``): three in flight
#: while the fourth is read.
CUDA_STAGES = 4
#: Products with at most this many rows take the GEMV path.
GEMV_MAX_M = 16
#: Threads of a GEMV block (8 warps), and the f32 values of x it stages
#: (``kGemvXFloats``: M rounded up to a power of two, times its K range).
GEMV_THREADS = 256
GEMV_X_FLOATS = 4096
#: Shared memory one block may use on an H100 (227 KB of the SM's 256 KB;
#: above 48 KB only as dynamic shared memory).
SMEM_BUDGET_BYTES = 227 * 1024
#: Static shared memory a block may declare without opting in.
STATIC_SMEM_BYTES = 48 * 1024


def tiled_smem_bytes(bm: int, bk: int, bn: int, itemsize: int,
                     stages: int) -> int:
    """Shared memory of one tiled fused_matmul block: per stage the x
    (bm, bk) tile and the W tile, (bn, bk) "oi" or (bk, bn) "io", held in
    the operand dtype, each row padded by 16 bytes (which keeps the
    cp.async rows aligned and the float4 reads off each other's banks)."""
    vec = 16 // itemsize
    x = bm * (bk + vec)
    w = max(bn * (bk + vec), bk * (bn + vec))
    return stages * (x + w) * itemsize


def gemv_smem_bytes(rows: int, w_layout: str) -> int:
    """Shared memory of one GEMV block: the staged x, and for "io" the
    8 warps' partial sums of ``rows`` x 32 columns."""
    red = 0 if w_layout == "oi" else (GEMV_THREADS // 32) * rows * 32
    return 4 * (GEMV_X_FLOATS + red)


#: The int8 kernel's geometry (``csrc/fused_matmul_q8.cu``; its plan is
#: ``kernels/fused_matmul/kernel.py::plan_q8``).
#:
#: Tiled path (M > GEMV_MAX_M): output tiles (bm, bn) of ``Q8_TILES``,
#: the tiles the kernel is compiled for (the plan picks one and a thread
#: count of ``Q8_TILED_THREADS``): four warps on the tile's ``mma.sync``
#: m16n8k32 s8 tiles (``Q8_BK`` deep, the instruction's depth) in each of
#: two or four K groups; a block's whole K range of at most
#: ``Q8_MAX_KSPLIT`` values is staged at once.
Q8_TILES: Tuple[Tuple[int, int], ...] = ((16, 32), (16, 64), (32, 16))
Q8_BK = 32
Q8_TILED_THREADS: Tuple[int, int] = (256, 512)
Q8_MAX_KSPLIT = 256
#: GEMV path (M <= GEMV_MAX_M): on "oi", a column of Wq per group of
#: lanes, each lane issuing up to ``Q8_GEMV_CHUNKS`` 16-byte loads of its
#: row before q(x) is staged, at most ``Q8_GEMV_MAX_THREADS`` a block.
#: On "io", 256 threads, lanes on 32 neighbouring columns.  q(x) is
#: staged as int8: M rounded up to a power of two, times the K range
#: rounded up to 16, within ``Q8_GEMV_X_BYTES``.
Q8_GEMV_CHUNKS = 2
Q8_GEMV_MAX_THREADS = 256
Q8_GEMV_IO_THREADS = 256
Q8_GEMV_X_BYTES = 16384


def q8_tiled_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one tiled fused_matmul_q8 block: x in f32 for the
    whole K range (bm x Q8_MAX_KSPLIT), and Wq and q(x) K-major in int8
    (bn and bm rows of Q8_MAX_KSPLIT bytes, each padded by 16, which
    keeps the fragment reads off each other's banks), and the int32 sums
    the K groups add up (bm x bn).  The accumulators live in
    registers."""
    return (4 * bm * Q8_MAX_KSPLIT + (bn + bm) * (Q8_MAX_KSPLIT + 16)
            + 4 * bm * bn)


def q8_gemv_smem_bytes(rows: int, w_layout: str) -> int:
    """Shared memory of one GEMV fused_matmul_q8 block: the staged q(x),
    and for "io" the 8 warps' int32 partial sums of ``rows`` x 32
    columns."""
    red = 0 if w_layout == "oi" else 4 * (Q8_GEMV_IO_THREADS // 32) * rows * 32
    return Q8_GEMV_X_BYTES + red


assert max(tiled_smem_bytes(*CUDA_BLOCK, itemsize, CUDA_STAGES)
           for itemsize in (2, 4)) <= STATIC_SMEM_BYTES, \
    "CUDA_BLOCK's stages outgrow a block's static shared memory"
assert gemv_smem_bytes(GEMV_MAX_M, "io") <= STATIC_SMEM_BYTES, \
    "the GEMV path outgrows a block's static shared memory"
assert max(q8_tiled_smem_bytes(bm, bn) for bm, bn in Q8_TILES) \
    <= STATIC_SMEM_BYTES, "a Q8_TILES tile outgrows static shared memory"
assert q8_gemv_smem_bytes(GEMV_MAX_M, "io") <= STATIC_SMEM_BYTES, \
    "the int8 GEMV path outgrows a block's static shared memory"


# ---------------------------------------------------------------------------
# The autotuner's tactic grids (``autotune/tactics.py`` enumerates them)
# ---------------------------------------------------------------------------
#: The plan overrides each tuned kernel is measured at, by parameter of
#: its plan function: B1 ``fused_matmul`` (``kernel.plan``), B2
#: ``fused_matmul_q8`` (``kernel.plan_q8``; ``tile`` is one of Q8_TILES,
#: split into ``tile_m`` and ``tile_n`` in a tactic), B4
#: ``decode_attention`` (``kernel.chunk_plan``; the 512-row tile depth is
#: no tactic, it changes the ``fast`` result).  B3 ``fast_act`` has no
#: plan, so no grid.  The values bracket the committed constants, which
#: benchmarks/plan_sweep_torch.py chose at the main path's shapes.
B1_GRID = {"target_blocks": (16, 32, 64, 128),
           "min_ksplit": (32, 64, 128, 256)}
B2_GRID = {"tile": Q8_TILES, "wide_k": (32, 128, 512),
           "min_ksplit": (64, 128, 256), "gemv_cols": (2, 4, 8, 16)}
B4_GRID = {"tiles_per_chunk": (1, 2, 4, 8),
           "target_blocks": (132, 256, 512)}
#: The grid of each tuned kernel, by its selector name.
TACTIC_GRIDS = {"cuda.fused_matmul": B1_GRID,
                "cuda.fused_matmul_q8": B2_GRID,
                "cuda.decode_attention": B4_GRID}
#: The parameters of a tactic, in the order of ``KernelChoice.tactic``.
TACTIC_PARAMS = {
    "cuda.fused_matmul": ("target_blocks", "min_ksplit"),
    "cuda.fused_matmul_q8": ("tile_m", "tile_n", "wide_k", "min_ksplit",
                             "gemv_cols"),
    "cuda.decode_attention": ("tiles_per_chunk", "target_blocks"),
}
#: Largest gridDim.y and gridDim.z of a launch.
MAX_GRID_YZ = 65535
