"""Tile geometry: the reference's TPU granules, and the port's Hopper tile.

Two parts, kept apart on purpose:

* **TPU granules** (``LANE``, ``SUBLANE``, ``ceil_to``).  The layout
  pass (``core/passes/layout.py``) pads dense ``cout`` to a ``LANE``
  multiple exactly as the reference does, so the port's optimized graphs
  stay ``structure_hash``-identical to the JAX package's.  Nothing on
  the GPU tiles against these numbers.
* **Hopper geometry** for the CUDA ``fused_matmul`` kernel and its
  selector (``core/selection.py``): the block tile the kernel is
  compiled with (``csrc/fused_matmul.cu`` must agree), and the shared
  memory a block may claim on an H100.
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


assert block_smem_bytes(*CUDA_BLOCK) <= SMEM_BUDGET_BYTES, \
    "CUDA_BLOCK's tiles outgrow one block's shared memory"
