"""Launch binding of the CUDA ``decode_attention`` kernels
(``csrc/decode_attention.cu``), and :func:`chunk_plan`, which cuts S
into the chunks its blocks take.

Replaces the TPU kernel ``decode_attention_p`` of
``src/repro/kernels/decode_attention/kernel.py``; the source note of the
``.cu`` file says what bounds it on the H100 and what its design does
about it.  Callers go through :func:`ops.decode_attention`, which
validates the tensors and counts calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import DEFAULT_BS

#: The largest G = H / Hkv and head dim D the kernel takes (G: 16 in
#: recurrentgemma-9b; D: 256, its head_dim, the largest of the repo's
#: configs).
MAX_GROUP = 16
MAX_HEAD_DIM = 256
#: Kernels one call launches: scores, p.V, combine.
KERNELS_PER_CALL = 3
#: The chunk plan aims for at least this many (chunk, KV head, batch)
#: blocks (132 SMs on an H100), with at most MAX_TILES_PER_CHUNK tiles a
#: chunk (on path B two ran fastest at batch 1 and within 3% of the best
#: at batch 8: benchmarks/plan_sweep_torch.py, readings in PERF.md).
TARGET_BLOCKS = 256
MAX_TILES_PER_CHUNK = 2


def chunk_plan(b: int, hkv: int, s: int, *,
               tiles_per_chunk: Optional[int] = None,
               target_blocks: Optional[int] = None) -> Tuple[int, int]:
    """(tiles per chunk, chunks): the most tiles a chunk, up to
    MAX_TILES_PER_CHUNK, that still give ``b * hkv * chunks`` >=
    TARGET_BLOCKS, else one.  ``tiles_per_chunk`` and ``target_blocks``
    override MAX_TILES_PER_CHUNK and TARGET_BLOCKS (the autotuner's
    tactics, ``tiles.B4_GRID``); left None, the plan is the heuristic's.
    The 512-row tile depth is no tactic: under ``fast`` it changes the
    result, the chunking does not.  Pure; chunk edges fall on 512-row
    tiles."""
    most = MAX_TILES_PER_CHUNK if tiles_per_chunk is None \
        else int(tiles_per_chunk)
    target = TARGET_BLOCKS if target_blocks is None else int(target_blocks)
    if most < 1 or target < 1:
        raise ValueError(f"chunk_plan: tiles_per_chunk {most} and "
                         f"target_blocks {target} must be positive")
    ntiles = -(-s // DEFAULT_BS)
    for tpc in range(most, 0, -1):
        chunks = -(-ntiles // tpc)
        if b * hkv * chunks >= target or tpc == 1:
            return tpc, chunks
    raise AssertionError("unreachable")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, out: torch.Tensor, *, scale: float,
           fast: bool, tpc: int) -> None:
    """out(B, H, D) = attention of q(B, H, D) over K/V(B, S, Hkv, D) up to
    ``lengths`` (B,), on the current stream of ``q``'s device, S cut into
    chunks of ``tpc`` tiles: the three kernels of one call, their scratch
    from ``torch.empty``.  The wrapper has checked devices, dtypes, shapes
    and contiguity."""
    from .. import build

    lib = build.load()
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    ntiles = -(-s // DEFAULT_BS)
    chunks = -(-ntiles // tpc)
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, h, s), **f32)
    tmax = torch.empty((b, h, ntiles), **f32)
    pacc = torch.empty((b, hkv, chunks, g, d), **f32)
    pl = torch.empty((b, hkv, chunks, g), **f32)
    pa = torch.empty((b, hkv, chunks, g), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, s, hkv, g, d, float(scale), int(bool(fast)),
            tpc, scores.data_ptr(), tmax.data_ptr(), pacc.data_ptr(),
            pl.data_ptr(), pa.data_ptr(), stream)
    build.check(lib, rc, "decode_attention")
