"""Tile geometry: the reference's TPU granules, and the port's Hopper tile.

Two parts, kept apart on purpose:

* **TPU granules** (``LANE``, ``SUBLANE``, ``ceil_to``).  The layout
  pass (``core/passes/layout.py``) pads dense ``cout`` to a ``LANE``
  multiple exactly as the reference does, so the port's optimized graphs
  stay ``structure_hash``-identical to the JAX package's.  Nothing on
  the GPU tiles against these numbers.
* **Hopper geometry** for the CUDA ``fused_matmul`` and
  ``fused_matmul_q8`` kernels and their selector
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
#: Output rows, K depth and output columns of one thread block's tile
#: (``BM``/``BK``/``BN`` in ``csrc/fused_matmul.cu``).  256 threads each
#: hold a 4x4 register sub-tile of the 64x64 output tile.
CUDA_BLOCK: Tuple[int, int, int] = (64, 16, 64)   # (bm, bk, bn)
#: Shared memory one block may use on an H100 (227 KB of the SM's 256 KB;
#: above 48 KB only as dynamic shared memory).
SMEM_BUDGET_BYTES = 227 * 1024


def block_smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Shared memory of one fused_matmul block: the x (bk, bm) and w
    (bk, bn) tiles, each row padded by one f32 against bank conflicts,
    both held as f32 whatever the operand dtype (bf16 operands are
    widened as they are loaded)."""
    return 4 * bk * ((bm + 1) + (bn + 1))


#: The int8 kernel's tile (``csrc/fused_matmul_q8.cu``): the same 64x64
#: output tile and 4x4 register sub-tile, K in steps of 32 int8 values.
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


assert block_smem_bytes(*CUDA_BLOCK) <= SMEM_BUDGET_BYTES, \
    "CUDA_BLOCK's tiles outgrow one block's shared memory"
assert q8_block_bytes(*CUDA_Q8_BLOCK)[0] <= SMEM_BUDGET_BYTES, \
    "CUDA_Q8_BLOCK's tiles outgrow one block's shared memory"
