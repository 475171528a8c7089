"""Sweep the launch plans of the port's B1 and B4 CUDA kernels on one GPU.

    python3 benchmarks/plan_sweep_torch.py > sweep.jsonl

Run from the repository root on a machine with an H100 and ``nvcc``.  It
sets the plans' constants in turn and times each kernel from a cold L2
(``chip_smoke.cold_ms``) at the shapes the main paths give it:

* ``fused_matmul`` (f32, both layouts, relu epilogue, M 1 and 256 at
  chip_smoke.MAIN_DENSE_KN) for ``TARGET_BLOCKS`` x ``MIN_KSPLIT``, and
  the ``F.linear`` + relu yardstick once per shape;
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("plan_sweep_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul.ops import fused_matmul

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    h, hkv, d, s = (cs.DECODE[key] for key in ("h", "hkv", "d", "s"))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
