"""Tile geometry: the reference's TPU granules, and the port's Hopper tile.

Two parts, kept apart on purpose:

* **TPU granules** (``LANE``, ``SUBLANE``, ``ceil_to``).  The layout
  pass (``core/passes/layout.py``) pads dense ``cout`` to a ``LANE``
  multiple exactly as the reference does, so the port's optimized graphs
  stay ``structure_hash``-identical to the JAX package's.  Nothing on
  the GPU tiles against these numbers.
* **Hopper geometry** for the CUDA ``fused_matmul`` and
  ``fused_matmul_q8`` kernels, their plan
  (``kernels/fused_matmul/kernel.py::plan``) and their selector
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


#: The int8 kernel's tile (``csrc/fused_matmul_q8.cu``): a 64x64 output
#: tile and 4x4 register sub-tile, K in steps of 32 int8 values.
CUDA_Q8_BLOCK: Tuple[int, int, int] = (64, 32, 64)   # (bm, bk, bn)


def q8_block_bytes(bm: int, bk: int, bn: int) -> Tuple[int, int]:
    """(shared memory, accumulator) bytes of one fused_matmul_q8 block.

    The operand tiles are int8, packed four along K per 32-bit word, one
    word of padding per row against bank conflicts: ``bk/4 * (bm+1)``
    and ``bk/4 * (bn+1)`` words.  The int32 accumulator tile (bm x bn)
    lives in registers, not shared memory; it is counted apart, as the
    reference's ``block_vmem_bytes(..., acc_itemsize)`` counts it."""
    smem = 4 * (bk // 4) * ((bm + 1) + (bn + 1))
    return smem, 4 * bm * bn


assert max(tiled_smem_bytes(*CUDA_BLOCK, itemsize, CUDA_STAGES)
           for itemsize in (2, 4)) <= STATIC_SMEM_BYTES, \
    "CUDA_BLOCK's stages outgrow a block's static shared memory"
assert gemv_smem_bytes(GEMV_MAX_M, "io") <= STATIC_SMEM_BYTES, \
    "the GEMV path outgrows a block's static shared memory"
assert q8_block_bytes(*CUDA_Q8_BLOCK)[0] <= SMEM_BUDGET_BYTES, \
    "CUDA_Q8_BLOCK's tiles outgrow one block's shared memory"
