"""Launch bindings of the CUDA ``fused_matmul`` kernel
(``csrc/fused_matmul.cu``) and of its int8 twin ``fused_matmul_q8``
(``csrc/fused_matmul_q8.cu``), and :func:`plan`, which picks the f32/bf16
kernel's path, tile and K split.

They replace the TPU kernels ``fused_matmul_p`` and ``fused_matmul_q8_p``
of ``src/repro/kernels/fused_matmul/kernel.py``; the source notes of the
``.cu`` files say what bounds them on the H100 and what their designs do
about it.  Callers go through :func:`ops.fused_matmul` and
:func:`ops.fused_matmul_q8`, which validate the tensors and count
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..tiles import (CUDA_BLOCK, CUDA_STAGES, GEMV_MAX_M, GEMV_THREADS,
                     GEMV_X_FLOATS, ceil_to, gemv_smem_bytes, tiled_smem_bytes)

#: Activation codes of ``repro_fused_matmul`` (``csrc/fused_matmul.cu::Act``).
ACT_CODES = {None: 0, "linear": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
             "hard_sigmoid": 4, "elu": 5, "tanh": 6, "sigmoid": 7}
#: Largest M the wrappers take: (M + 31) // 32 blocks along gridDim.y of
#: the tiled path.
MAX_M = 65535 * CUDA_BLOCK[0]
#: The plan splits K until the grid has this many blocks, but never into
#: splits of fewer than MIN_KSPLIT values; split edges fall on SPLIT_ALIGN
#: multiples.  A split costs the reducing block about three dependent
#: round trips to memory (its partials out, the counter, the partials
#: in), so it pays only where it divides a long K loop: on the H100 the
#: main-path rows ran fastest with these two
#: (benchmarks/plan_sweep_torch.py, readings in PERF.md).
TARGET_BLOCKS = 64
MIN_KSPLIT = 128
SPLIT_ALIGN = CUDA_BLOCK[1]
#: Most K splits of the tiled path.
MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one (M, K, N) product runs: ``path`` "gemv" (M <= 16) or
    "tiled"; the output block tile (rows, columns); K cut into ``splits``
    ranges of ``ksplit`` values (the last may be shorter), reduced inside
    the launch when ``splits > 1``; the grid (x, y, z) and the shared
    memory of one block."""

    path: str
    block: Tuple[int, int]
    splits: int
    ksplit: int
    grid: Tuple[int, int, int]
    smem_bytes: int

    @property
    def tiles(self) -> int:
        """Output tiles, one split counter each."""
        return self.grid[0] * self.grid[1]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def split_edges(self, k: int):
        """The K ranges [k0, k1) of the splits, in order."""
        return [(i * self.ksplit, min(k, (i + 1) * self.ksplit))
                for i in range(self.splits)]

    def pad_waste(self, m: int, k: int, n: int) -> float:
        """Padded over logical MACs: the masked rows and columns of the
        tiles (and K rounded to whole 4-deep steps on the tiled path),
        i.e. the share of the threads' slots that idle."""
        bm, bn = self.block
        if self.path == "gemv":
            return ceil_to(n, bn) / float(n)
        kp = sum(ceil_to(k1 - k0, 4) for k0, k1 in self.split_edges(k))
        return ceil_to(m, bm) * kp * ceil_to(n, bn) / float(m * max(k, 1) * n)

    def describe(self) -> str:
        if self.path == "gemv":
            how = f"GEMV over {self.block[1]}-column blocks"
        else:
            how = f"tiles to {self.block[0]}x{self.block[1]}"
        split = (f"K split {self.splits} ways of {self.ksplit}"
                 if self.splits > 1 else "K unsplit")
        return f"{how}, {split}, {self.blocks} blocks"


def gemv_rows(m: int) -> int:
    """The GEMV kernel's row template for M: the next power of two."""
    mm = 1
    while mm < m:
        mm *= 2
    return mm


def _split(k: int, tiles: int, max_ksplit: Optional[int],
           max_splits: int) -> Tuple[int, int]:
    """(splits, ksplit): enough splits that ``tiles * splits`` reaches
    TARGET_BLOCKS, none shallower than MIN_KSPLIT nor deeper than
    ``max_ksplit``, each a SPLIT_ALIGN multiple."""
    want = -(-TARGET_BLOCKS // tiles)
    want = min(want, max(1, k // MIN_KSPLIT), max_splits)
    if max_ksplit is not None:
        want = max(want, -(-k // max_ksplit))
    ksplit = max(SPLIT_ALIGN, ceil_to(-(-k // want), SPLIT_ALIGN))
    splits = max(1, -(-k // ksplit))
    return splits, ksplit


def plan(m: int, k: int, n: int, *, w_layout: str = "io",
         itemsize: int = 4) -> Plan:
    """The f32/bf16 kernel's plan for x (M, K) . W -> (M, N): the GEMV
    path for M <= GEMV_MAX_M, else 32x32 tiles; K split to cover the
    card.  Pure: the wrapper launches it and the selector reports it."""
    if m <= GEMV_MAX_M:
        cols = GEMV_THREADS // 32 if w_layout == "oi" else 32
        gx = -(-n // cols)
        splits, ksplit = _split(k, gx, GEMV_X_FLOATS // gemv_rows(m), 65535)
        return Plan("gemv", (m, cols), splits, ksplit, (gx, splits, 1),
                    gemv_smem_bytes(gemv_rows(m), w_layout))
    bm, _, bn = CUDA_BLOCK
    gx, gy = -(-n // bn), -(-m // bm)
    splits, ksplit = _split(k, gx * gy, None, MAX_SPLITS)
    return Plan("tiled", (bm, bn), splits, ksplit, (gx, gy, splits),
                tiled_smem_bytes(*CUDA_BLOCK, itemsize, CUDA_STAGES))


#: Per device: the split counters (int32 zeros; each reducing block sets
#: its own back to 0), grown as larger plans need more.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, tiles: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, w: torch.Tensor, bias, scale, offset,
           out: torch.Tensor, *, fn: Optional[str], alpha: float,
           fast: bool, w_layout: str) -> None:
    """out(M, N) = epilogue(x(M, K) . W) on the current stream of
    ``x``'s device, as :func:`plan` lays it out: one launch, its K-split
    partials in a scratch tensor.  The wrapper has checked devices,
    dtypes, shapes and contiguity."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    p = plan(m, k, n, w_layout=w_layout, itemsize=x.element_size())
    part = counters = None
    if p.splits > 1:
        part = torch.empty(p.splits * m * n, dtype=torch.float32,
                           device=x.device)
        counters = _counters(x.device, p.tiles)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul(
            x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(scale), _ptr(offset),
            out.data_ptr(), m, k, n, int(w_layout == "oi"),
            int(x.dtype == torch.bfloat16), ACT_CODES[fn], float(alpha),
            int(bool(fast)), int(p.path == "tiled"), p.splits, p.ksplit,
            _ptr(part), _ptr(counters), stream)
    build.check(lib, rc, "fused_matmul")


def launch_q8(x: torch.Tensor, wq: torch.Tensor, deq: torch.Tensor, bias,
              scale, offset, out: torch.Tensor, *, x_scale: float,
              fn: Optional[str], alpha: float, fast: bool,
              w_layout: str) -> None:
    """out(M, N) = epilogue(deq * (q(x)(M, K) . Wq)) on the current stream
    of ``x``'s device, x quantized with ``x_scale`` as it is loaded.  The
    wrapper has checked devices, dtypes, shapes and contiguity."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul_q8(
            x.data_ptr(), wq.data_ptr(), deq.data_ptr(), _ptr(bias),
            _ptr(scale), _ptr(offset), out.data_ptr(), m, k, n,
            int(w_layout == "oi"), float(x_scale), ACT_CODES[fn],
            float(alpha), int(bool(fast)), stream)
    build.check(lib, rc, "fused_matmul_q8")
