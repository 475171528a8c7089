"""Sweep the launch plans of the port's B1, B2 and B4 CUDA kernels on one GPU.

    python3 benchmarks/plan_sweep_torch.py [fused_matmul] [fused_matmul_q8]
                                           [decode_attention] > sweep.jsonl

(no names: all three).  Run from the repository root on a machine with
an H100 and ``nvcc``.  It sets the plans' constants in turn and times
each kernel from a cold L2 (``chip_smoke.cold_ms``) at the shapes the
main paths give it:

* ``fused_matmul`` (f32, both layouts, relu epilogue, M 1 and 256 at
  chip_smoke.MAIN_DENSE_KN) for ``TARGET_BLOCKS`` x ``MIN_KSPLIT``, and
  the ``F.linear`` + relu yardstick once per shape;
* ``fused_matmul_q8`` ("oi", relu epilogue, M 1 and 256 at
  chip_smoke.MAIN_DENSE_KN: the int8 path's 14 rows) for
  ``Q8_MIN_KSPLIT`` x (``Q8_TILE`` x ``Q8_WIDE_K`` at M 256,
  ``Q8_GEMV_COLS`` at M 1), and the ``torch._int_mm`` yardstick once per
  shape where it runs (``Q8_TARGET_BLOCKS`` matters only where K is at
  least twice ``Q8_MIN_KSPLIT``, which no main-path row is);
* ``decode_attention`` at path B's inputs (qwen2.5-14b widths, S 32768,
  batch 1 and 8) for ``MAX_TILES_PER_CHUNK``.

One JSON line per setting, after the card's ``nvidia-smi`` name and power
limit.  The plans' committed constants come from its readings.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def sweep_fused_matmul(torch, F, cs, gen) -> None:
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul.ops import fused_matmul

    shapes = [(m, k, n) for m in (1, 256) for k, n in cs.MAIN_DENSE_KN]
    ops = {}
    lib = {}
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((n, k), generator=gen, device="cuda")
        b = torch.randn((n,), generator=gen, device="cuda")
        ops[m, k, n] = (x, w, w.T.contiguous(), b)
        lib[f"{m}x{k}x{n}"] = cs.cold_ms(lambda: F.relu(F.linear(x, w, b)))
    print(json.dumps({"kernel": "fused_matmul", "library_ms": lib}), flush=True)
    saved = fm_k.TARGET_BLOCKS, fm_k.MIN_KSPLIT
    for target in (16, 32, 64):
        for min_ksplit in (32, 64, 128, 256):
            fm_k.TARGET_BLOCKS, fm_k.MIN_KSPLIT = target, min_ksplit
            row = {"kernel": "fused_matmul", "TARGET_BLOCKS": target,
                   "MIN_KSPLIT": min_ksplit, "ms": {}}
            for (m, k, n), (x, w_oi, w_io, b) in ops.items():
                for layout, w in (("oi", w_oi), ("io", w_io)):
                    row["ms"][f"{m}x{k}x{n} {layout}"] = cs.cold_ms(
                        lambda: fused_matmul(x, w, b, fn="relu",
                                             w_layout=layout))
            print(json.dumps(row), flush=True)
    fm_k.TARGET_BLOCKS, fm_k.MIN_KSPLIT = saved


def sweep_fused_matmul_q8(torch, cs, gen) -> None:
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8
    from repro_torch.kernels.tiles import Q8_TILES

    ops, lib = {}, {}
    for m in (1, 256):
        for k, n in cs.MAIN_DENSE_KN:
            x = torch.randn((m, k), generator=gen, device="cuda")
            wq = torch.randint(-127, 128, (n, k), generator=gen,
                               dtype=torch.int8, device="cuda")
            deq = torch.rand((n,), generator=gen, device="cuda") * 1e-3
            b = torch.randn((n,), generator=gen, device="cuda")
            ops[m, k, n] = (x, wq, deq, b)
            xq = torch.randint(-127, 128, (m, k), generator=gen,
                               dtype=torch.int8, device="cuda")
            try:
                lib[f"{m}x{k}x{n}"] = cs.cold_ms(
                    lambda: torch._int_mm(xq, wq.T))
            except RuntimeError:
                lib[f"{m}x{k}x{n}"] = None
    print(json.dumps({"kernel": "fused_matmul_q8",
                      "library": "torch._int_mm", "library_ms": lib}),
          flush=True)

    def row(settings, m):
        out = {"kernel": "fused_matmul_q8", **settings, "ms": {}, "plan": {}}
        for (mm, k, n), (x, wq, deq, b) in ops.items():
            if mm != m:
                continue
            key = f"{m}x{k}x{n}"
            out["plan"][key] = fm_k.plan_q8(m, k, n, w_layout="oi").describe()
            out["ms"][key] = cs.cold_ms(lambda: fused_matmul_q8(
                x, wq, deq, b, x_scale=0.05, fn="relu", w_layout="oi"))
        print(json.dumps(out), flush=True)

    saved = (fm_k.Q8_TILE, fm_k.Q8_WIDE_K, fm_k.Q8_MIN_KSPLIT,
             fm_k.Q8_GEMV_COLS)
    for min_ksplit in (64, 128, 256):
        fm_k.Q8_MIN_KSPLIT = min_ksplit
        for tile in Q8_TILES:
            for wide_k in (32, 128, 512):
                fm_k.Q8_TILE, fm_k.Q8_WIDE_K = tile, wide_k
                row({"Q8_MIN_KSPLIT": min_ksplit, "Q8_TILE": list(tile),
                     "Q8_WIDE_K": wide_k}, 256)
        fm_k.Q8_TILE, fm_k.Q8_WIDE_K = saved[:2]
        for cols in (2, 4, 8, 16):
            fm_k.Q8_GEMV_COLS = cols
            row({"Q8_MIN_KSPLIT": min_ksplit, "Q8_GEMV_COLS": cols}, 1)
        fm_k.Q8_GEMV_COLS = saved[3]
    (fm_k.Q8_TILE, fm_k.Q8_WIDE_K, fm_k.Q8_MIN_KSPLIT,
     fm_k.Q8_GEMV_COLS) = saved


def sweep_decode_attention(torch, cs) -> None:
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.decode_attention.ops import decode_attention

    h, hkv, d, s = (cs.DECODE[key] for key in ("h", "hkv", "d", "s"))
    saved = da_k.MAX_TILES_PER_CHUNK
    for batch, lengths in cs.DECODE_LENGTHS.items():
        q, k, v, lens = cs.decode_inputs(torch, batch, h, hkv, d, s, lengths, 3)
        for max_tpc in (1, 2, 4, 8):
            da_k.MAX_TILES_PER_CHUNK = max_tpc
            ms = cs.cold_ms(lambda: decode_attention(q, k, v, lens), iters=10)
            print(json.dumps({"kernel": "decode_attention", "batch": batch,
                              "MAX_TILES_PER_CHUNK": max_tpc,
                              "plan": da_k.chunk_plan(batch, hkv, s),
                              "ms": ms}), flush=True)
        del q, k, v
    da_k.MAX_TILES_PER_CHUNK = saved


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("plan_sweep_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    which = set(sys.argv[1:]) or {"fused_matmul", "fused_matmul_q8",
                                  "decode_attention"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "fused_matmul" in which:
        sweep_fused_matmul(torch, F, cs, gen)
    if "fused_matmul_q8" in which:
        sweep_fused_matmul_q8(torch, cs, gen)
    if "decode_attention" in which:
        sweep_decode_attention(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
