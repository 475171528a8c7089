"""Launch bindings of the CUDA ``fused_matmul`` kernel
(``csrc/fused_matmul.cu``) and of its int8 twin ``fused_matmul_q8``
(``csrc/fused_matmul_q8.cu``), and their plans: :func:`plan` picks the
f32/bf16 kernel's path, tile and K split, :func:`plan_q8` the int8
kernel's.

They replace the TPU kernels ``fused_matmul_p`` and ``fused_matmul_q8_p``
of ``src/repro/kernels/fused_matmul/kernel.py``; the source notes of the
``.cu`` files say what bounds them on the H100 and what their designs do
about it.  Callers go through :func:`ops.fused_matmul` and
:func:`ops.fused_matmul_q8`, which validate the tensors and count
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..tiles import (CUDA_BLOCK, CUDA_STAGES, GEMV_MAX_M, GEMV_THREADS,
                     GEMV_X_FLOATS, Q8_BK, Q8_GEMV_CHUNKS, Q8_GEMV_IO_THREADS,
                     Q8_GEMV_MAX_THREADS, Q8_GEMV_X_BYTES, Q8_MAX_KSPLIT,
                     Q8_TILED_THREADS, Q8_TILES, ceil_to, gemv_smem_bytes,
                     q8_gemv_smem_bytes, q8_tiled_smem_bytes,
                     tiled_smem_bytes)

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

#: The int8 plan's constants, in the same roles: the tiled path's output
#: tile (one of ``tiles.Q8_TILES``), and the K range from which its block
#: takes 512 threads (four K groups) rather than 256, which keep more of
#: the quantize's divisions in flight but cost a shallow product more
#: than they save; the blocks the K split aims for and the shallowest
#: split; and the GEMV path's fewest columns a block on "oi"
#: (benchmarks/plan_sweep_torch.py, readings in PERF.md).
Q8_TILE: Tuple[int, int] = (16, 32)
Q8_WIDE_K = 128
Q8_TARGET_BLOCKS = 64
Q8_MIN_KSPLIT = 256
Q8_GEMV_COLS = 8
#: Largest M the int8 wrapper takes: gridDim.y of its smallest tile.
MAX_M_Q8 = 65535 * min(bm for bm, _ in Q8_TILES)


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
    #: The int8 kernel's: its threads a block, the lanes that share a
    #: column on the GEMV path's "oi" (0: not that path), and the depth
    #: K is padded to per split (4 for fused_matmul's 4-deep steps, 32
    #: for the s8 mma on the int8 tiled path).
    threads: int = 0
    lanes: int = 0
    kstep: int = 4

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
        kp = sum(ceil_to(k1 - k0, self.kstep)
                 for k0, k1 in self.split_edges(k))
        return ceil_to(m, bm) * kp * ceil_to(n, bn) / float(m * max(k, 1) * n)

    def describe(self) -> str:
        if self.path == "gemv":
            how = f"GEMV over {self.block[1]}-column blocks"
            if self.lanes:
                how += f", {self.lanes} lanes a column"
        elif self.kstep == Q8_BK:
            how = (f"s8 mma.sync tiles to {self.block[0]}x{self.block[1]} "
                   f"on {self.threads} threads")
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


def _split(k: int, tiles: int, max_ksplit: Optional[int], max_splits: int,
           target: int, min_ksplit: int, align: int) -> Tuple[int, int]:
    """(splits, ksplit): enough splits that ``tiles * splits`` reaches
    ``target`` blocks, none shallower than ``min_ksplit`` nor deeper than
    ``max_ksplit``, each an ``align`` multiple."""
    want = -(-target // tiles)
    want = min(want, max(1, k // min_ksplit), max_splits)
    if max_ksplit is not None:
        want = max(want, -(-k // max_ksplit))
    ksplit = max(align, ceil_to(-(-k // want), align))
    splits = max(1, -(-k // ksplit))
    return splits, ksplit


def plan(m: int, k: int, n: int, *, w_layout: str = "io",
         itemsize: int = 4, target_blocks: Optional[int] = None,
         min_ksplit: Optional[int] = None) -> Plan:
    """The f32/bf16 kernel's plan for x (M, K) . W -> (M, N): the GEMV
    path for M <= GEMV_MAX_M, else 32x32 tiles; K split to cover the
    card.  ``target_blocks`` and ``min_ksplit`` override TARGET_BLOCKS
    and MIN_KSPLIT (the autotuner's tactics, ``tiles.B1_GRID``); left
    None, the plan is the heuristic's.  Pure: the wrapper launches it
    and the selector reports it."""
    target = TARGET_BLOCKS if target_blocks is None else int(target_blocks)
    shallowest = MIN_KSPLIT if min_ksplit is None else int(min_ksplit)
    if target < 1 or shallowest < 1:
        raise ValueError(f"plan: target_blocks {target} and min_ksplit "
                         f"{shallowest} must be positive")
    if m <= GEMV_MAX_M:
        cols = GEMV_THREADS // 32 if w_layout == "oi" else 32
        gx = -(-n // cols)
        splits, ksplit = _split(k, gx, GEMV_X_FLOATS // gemv_rows(m), 65535,
                                target, shallowest, SPLIT_ALIGN)
        return Plan("gemv", (m, cols), splits, ksplit, (gx, splits, 1),
                    gemv_smem_bytes(gemv_rows(m), w_layout))
    bm, _, bn = CUDA_BLOCK
    gx, gy = -(-n // bn), -(-m // bm)
    splits, ksplit = _split(k, gx * gy, None, MAX_SPLITS, target,
                            shallowest, SPLIT_ALIGN)
    return Plan("tiled", (bm, bn), splits, ksplit, (gx, gy, splits),
                tiled_smem_bytes(*CUDA_BLOCK, itemsize, CUDA_STAGES))


def plan_q8(m: int, k: int, n: int, *, w_layout: str = "io",
            tile: Optional[Tuple[int, int]] = None,
            wide_k: Optional[int] = None, min_ksplit: Optional[int] = None,
            gemv_cols: Optional[int] = None) -> Plan:
    """The int8 kernel's plan for q(x) (M, K) . Wq -> (M, N): the GEMV
    path for M <= GEMV_MAX_M, else ``Q8_TILE`` tiles on s8 ``mma.sync``
    with a block's K range of at most Q8_MAX_KSPLIT staged at once; K
    split to cover the card.  On the GEMV path's "oi", a column's row of
    Wq is read 16 bytes a lane by just enough lanes (a power of two) that
    each issues at most Q8_GEMV_CHUNKS loads.  ``tile`` (one of
    ``tiles.Q8_TILES``), ``wide_k``, ``min_ksplit`` and ``gemv_cols``
    override Q8_TILE, Q8_WIDE_K, Q8_MIN_KSPLIT and Q8_GEMV_COLS (the
    autotuner's tactics, ``tiles.B2_GRID``); left None, the plan is the
    heuristic's.  Pure: the wrapper launches it and the selector reports
    it."""
    tile = Q8_TILE if tile is None else tuple(int(t) for t in tile)
    wide_k = Q8_WIDE_K if wide_k is None else int(wide_k)
    shallowest = Q8_MIN_KSPLIT if min_ksplit is None else int(min_ksplit)
    gemv_cols = Q8_GEMV_COLS if gemv_cols is None else int(gemv_cols)
    if tile not in Q8_TILES:
        raise ValueError(f"plan_q8: tile {tile} is none of {Q8_TILES}")
    if shallowest < 1 or not 1 <= gemv_cols <= Q8_GEMV_MAX_THREADS:
        raise ValueError(f"plan_q8: min_ksplit {shallowest} and gemv_cols "
                         f"{gemv_cols} out of range")

    def split(tiles, max_ksplit):
        return _split(k, tiles, max_ksplit, 65535, Q8_TARGET_BLOCKS,
                      shallowest, Q8_BK)

    if m <= GEMV_MAX_M:
        rows = gemv_rows(m)
        if w_layout == "oi":
            splits, ksplit = split(-(-n // gemv_cols),
                                   Q8_GEMV_X_BYTES // rows)
            chunks = -(-min(k, ksplit) // 16)
            lanes = min(32, gemv_rows(-(-chunks // Q8_GEMV_CHUNKS)))
            threads = min(Q8_GEMV_MAX_THREADS,
                          max(32, gemv_cols * lanes))
        else:
            lanes, threads = 0, Q8_GEMV_IO_THREADS
            splits, ksplit = split(-(-n // 32), Q8_GEMV_X_BYTES // rows)
        cols = threads // lanes if lanes else 32
        gx = -(-n // cols)
        return Plan("gemv", (m, cols), splits, ksplit, (gx, splits, 1),
                    q8_gemv_smem_bytes(rows, w_layout), threads=threads,
                    lanes=lanes, kstep=Q8_BK)
    bm, bn = tile
    gx, gy = -(-n // bn), -(-m // bm)
    splits, ksplit = split(gx * gy, Q8_MAX_KSPLIT)
    threads = Q8_TILED_THREADS[min(k, ksplit) >= wide_k]
    return Plan("tiled", (bm, bn), splits, ksplit, (gx, gy, splits),
                q8_tiled_smem_bytes(bm, bn), threads=threads, kstep=Q8_BK)


def check_plan(p: Plan, m: int, k: int, n: int, what: str) -> None:
    """Raise unless ``p`` lays out an (M, K) . (K, N) product: its block
    rows and grid cover M and N and its splits cover K with none empty
    (a ready plan a caller passes to a wrapper, made for another shape,
    would read out of bounds)."""
    bm, bn = p.block
    if p.path == "gemv":
        grid = (-(-n // bn), p.splits, 1)
        ok = bm == m and m <= GEMV_MAX_M
    else:
        grid = (-(-n // bn), -(-m // bm), p.splits)
        ok = m > GEMV_MAX_M
    ok &= p.grid == grid and p.splits * p.ksplit >= k \
        and (p.splits - 1) * p.ksplit < max(k, 1)
    if not ok:
        raise ValueError(f"{what}: the plan {p} does not lay out "
                         f"M={m} K={k} N={n}")


class SplitCounters:
    """The split counters of one owner, per device: int32 zeros (each
    reducing block sets its own back to 0), grown as larger plans need
    more.  Each prepared program holds its own (``LoweringContext.
    counters``), so two programs running at once on two streams (a
    bucket captured in the background while another replays) never
    share one.  An outgrown buffer is kept, never freed: a CUDA graph
    captured with it keeps reading its address at every replay."""

    def __init__(self) -> None:
        self._bufs: Dict[torch.device, List[torch.Tensor]] = {}

    def get(self, device: torch.device, tiles: int) -> torch.Tensor:
        bufs = self._bufs.setdefault(device, [])
        if not bufs or bufs[-1].numel() < tiles:
            bufs.append(torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                    device=device))
        return bufs[-1]


#: The counters of wrapper calls made outside a prepared program.
SHARED_COUNTERS = SplitCounters()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, w: torch.Tensor, bias, scale, offset,
           out: torch.Tensor, *, fn: Optional[str], alpha: float,
           fast: bool, w_layout: str, counters: SplitCounters,
           p: Plan) -> None:
    """out(M, N) = epilogue(x(M, K) . W) on the current stream of
    ``x``'s device, as the plan ``p`` lays it out: one launch, its
    K-split partials in a scratch tensor, reduced through ``counters``.
    The wrapper has checked devices, dtypes, shapes, contiguity and the
    plan."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    part = tile_counters = None
    if p.splits > 1:
        part = torch.empty(p.splits * m * n, dtype=torch.float32,
                           device=x.device)
        tile_counters = counters.get(x.device, p.tiles)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul(
            x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(scale), _ptr(offset),
            out.data_ptr(), m, k, n, int(w_layout == "oi"),
            int(x.dtype == torch.bfloat16), ACT_CODES[fn], float(alpha),
            int(bool(fast)), int(p.path == "tiled"), p.splits, p.ksplit,
            _ptr(part), _ptr(tile_counters), stream)
    build.check(lib, rc, "fused_matmul")


def launch_q8(x: torch.Tensor, wq: torch.Tensor, deq: torch.Tensor, bias,
              scale, offset, out: torch.Tensor, *, x_scale: float,
              fn: Optional[str], alpha: float, fast: bool,
              w_layout: str, counters: SplitCounters, p: Plan) -> None:
    """out(M, N) = epilogue(deq * (q(x)(M, K) . Wq)) on the current stream
    of ``x``'s device, x quantized with ``x_scale`` as it is loaded, as
    the plan ``p`` lays it out: one launch, its K-split int32 partials in
    a scratch tensor.  An int32 ``out`` (``deq`` None) takes the exact
    sums themselves (the ``sums`` mode).  The wrapper has checked
    devices, dtypes, shapes, contiguity and the plan."""
    from .. import build

    lib = build.load()
    m, k = x.shape
    n = out.shape[1]
    part = tile_counters = None
    if p.splits > 1:
        part = torch.empty(p.splits * m * n, dtype=torch.int32,
                           device=x.device)
        tile_counters = counters.get(x.device, p.tiles)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_fused_matmul_q8(
            x.data_ptr(), wq.data_ptr(), _ptr(deq), _ptr(bias),
            _ptr(scale), _ptr(offset), out.data_ptr(), m, k, n,
            int(w_layout == "oi"), float(x_scale), ACT_CODES[fn],
            float(alpha), int(bool(fast)), int(p.path == "tiled"),
            p.block[0] if p.path == "tiled" else 0, p.block[1], p.threads,
            p.lanes, p.splits, p.ksplit, _ptr(part), _ptr(tile_counters),
            int(out.dtype == torch.int32), stream)
    build.check(lib, rc, "fused_matmul_q8")
