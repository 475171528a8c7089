"""Time the engine's decode attention (plain torch) on one GPU.

    python3 benchmarks/engine_attention_torch.py

Run from the repository root on a machine with a CUDA GPU.  At
qwen2.5-14b's attention widths (H 40, Hkv 8, D 128) over decode_32k's
depth (S 32768), batch cut from 128 to 4, with a bf16 cache and the f32
compute dtype, it times between CUDA events (warm, 10 calls each):

* the p.V product of one layer as one ``bmm`` over all S keys per batch
  row (``unsplit``) and cut into parts of ``PV_SPLIT`` keys
  (``models/common.py::_pv``, ``split``), with their max abs difference;
* the score product q.K of one layer;
* the whole ``decode_attention_jnp`` of one layer.

One JSON line, after the card's ``nvidia-smi`` name and power limit.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, H, HKV, D, S = 4, 40, 8, 128, 32768


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.models.common import PV_SPLIT, _pv, decode_attention_jnp
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = torch.randn((B, S, HKV, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, HKV, D), generator=gen, device="cuda").bfloat16()
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    g = H // HKV
    qg = q.reshape(B, HKV, g, D).float()
    p = torch.softmax(torch.randn((B, HKV, g, S), generator=gen,
                                  device="cuda"), dim=-1)
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")

    def ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def unsplit():
        return torch.stack([torch.bmm(p[i], v[i].float().permute(1, 0, 2))
                            for i in range(B)])

    def split():
        return torch.stack([_pv(p[i], v[i].float()) for i in range(B)])

    def scores():
        return torch.stack([torch.bmm(k[i].float().permute(1, 0, 2),
                                      qg[i].transpose(1, 2))
                            for i in range(B)])

    diff = float((split() - unsplit()).abs().max())
    print(json.dumps({
        "batch": B, "heads": H, "kv_heads": HKV, "head_dim": D, "S": S,
        "pv_split": PV_SPLIT, "pv_unsplit_ms": ms(unsplit),
        "pv_split_ms": ms(split), "pv_max_abs_diff": diff,
        "scores_ms": ms(scores),
        "decode_attention_ms": ms(lambda: decode_attention_jnp(
            q, k, v, lengths)),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
