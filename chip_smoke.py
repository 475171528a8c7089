#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA.  It imports nothing of JAX or of the
JAX package.  Every phase prints one JSON line (also written to
``chiprun_out/chip_smoke.jsonl``):

1. ``card``      the card's name and power limit (``nvidia-smi``), torch
                 and CUDA versions.
2. ``build``     nvcc builds the kernels from ``src/repro_torch/csrc``;
                 seconds, and ptxas' registers/shared memory per kernel.
3. ``check``     each kernel against its plain torch version on the card,
                 at the main path's shapes and a ragged one.
4. ``main``      the six Table-1 CNNs through ``repro_torch.compile(...,
                 target="cuda")`` at batch 1 and 256: ``exact`` against
                 ``interpret`` on the card, ``fast`` against the same
                 compile on the CPU; the kernels' launch counts on that
                 run, held against the graphs' dense and softmax nodes.
5. ``time``      medians of interpret/jit/cuda per model and batch (host
                 clock around a synchronised call) with the device's busy
                 time per inference (``torch.profiler``); per kernel at the
                 main-path shapes its time, the plain version's, a library
                 call's and the bound.  A kernel row's ``ms``,
                 ``plain_ms`` and ``library_ms`` are the median device time
                 of one call with the L2 flushed before it (CUDA events
                 around the call, queued while the flush runs, so the
                 host's launch cost drops out); ``call_ms`` is the time per
                 call over back-to-back calls of the Python wrapper, which
                 the host's launch cost sets.

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}``
line.  Any failure exits non-zero before the ``ok`` line; without CUDA
it exits 2 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks used for the bound (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 tensor-core peak, dense
MATMUL_ATOL = 1e-4               # kernel vs plain: f32 sums in another order
EXACT_ATOL = 1e-4                # cuda exact vs interpret on the card
FAST_ATOL = 1e-5                 # cuda fast on the card vs on the CPU
#: fused_matmul_q8 vs plain for elu/tanh/sigmoid: CUDA's expm1f/tanhf/
#: expf against torch's, an ulp or so below 1; the other epilogues are
#: held bit-equal (exact int32 sum, the same rounded f32 operations).
Q8_ATOL = 1e-6
Q8_BIT_EQUAL = ("none", "relu", "leaky_relu", "relu_affine")
#: decode_attention vs its plain forms: f32 sums over up to 32768 rows in
#: another order, with outputs of unit-normal V below ~5.
DECODE_ATOL = 1e-5
#: The reference's default accuracy budget (repro quantize.py:64), a
#: per-site limit on 4 calibration rows.  Against interpret exact, the
#: median example's max abs error is held to it, scaled by the output's
#: magnitude where that exceeds 1; the tails exceed it in the reference
#: itself (CPU: C-HTWK int8 0.082 at batch 256, in 2 of 256 examples;
#: MobileNetV2 bf16, outputs up to ~4, 0.077 at batch 8).
QUANT_BUDGET = 0.05
BF16_ATOL = 1e-4                 # cuda bf16 vs jit bf16: f32 sums reordered
BATCHES = (1, 256)
#: The Table-1 graphs with dense nodes: the int8 path's graphs.
INT8_MODELS = ("C-HTWK", "C-BH", "VGG19")
#: qwen2.5-14b's attention widths (src/repro/configs/qwen2_5_14b.py) over
#: the KV depth of decode_32k (src/repro/configs/base.py), its batch of
#: 128 cut to 8: K and V in f32 take 2.15 GB on the card.
DECODE = {"h": 40, "hkv": 8, "d": 128, "s": 32768}
DECODE_LENGTHS = {1: [31000],
                  8: [32768, 32767, 30000, 16385, 12345, 4097, 1000, 513]}
#: (B, H, Hkv, D, S, lengths) checked beside the path's shape: the largest
#: group and head dim (recurrentgemma-9b's G 16, D 256), no grouping, and
#: a head dim that is not a multiple of 4 (the kernel's scalar loads).
DECODE_CHECK_MORE = [(2, 16, 1, 256, 4096, [4096, 1537]),
                     (2, 36, 36, 64, 4096, [3001, 4096]),
                     (2, 6, 2, 100, 1500, [1500, 777]),
                     # Two tiles a chunk (kernel.py::chunk_plan) over an S
                     # that is no multiple of the chunk: lengths on a chunk
                     # edge, inside the first tile, 1, and S.
                     (4, 40, 8, 128, 9000, [2048, 300, 1, 9000])]
KERNELS = ("fused_matmul", "fast_act", "fused_matmul_q8", "decode_attention")
TIMED_RUNS = 25
DEVICE = "cuda"

_OUT = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _OUT.append(line)
    print(line, flush=True)


def save_log() -> None:
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(_OUT) + "\n")


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back launches,
    between CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median wall time of ``fn()`` ending in a synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cold_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call from a cold L2: before each
    call a 256 MB write evicts the card's 50 MB L2 (leaving it dirty, so
    the call also pays for write-backs, as it would in a model), and a
    spin gives the host time to queue the call behind it; CUDA events
    bracket the call alone."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for start, end in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def queued_ms(fn, iters: int = 50, spin: int = 40_000_000) -> float:
    """Device time per call of ``fn()`` with the host out of the way:
    the card first spins for ``spin`` cycles (``torch.cuda._sleep``;
    40M is ~20 ms) while the host queues ``iters`` calls, so the CUDA
    events time the calls' work back to back, without the host's launch
    gaps.  The host must queue all calls within the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters: int = 20):
    """Device time per call of ``fn()`` of each CUDA kernel it launched,
    by name, from ``torch.profiler`` over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = t if t is not None else getattr(evt, "self_cuda_time_total", 0.0)
        if t:
            out[evt.key] = out.get(evt.key, 0.0) + t / iters / 1e3
    return out


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn()``: the sum of every CUDA kernel it
    launched; None when the profiler recorded no device time."""
    total = sum(device_ms_by_kernel(fn, iters).values())
    return total or None


def bound_ms(nbytes: float, flops: float, ops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul.ops import (fused_matmul,
                                                      fused_matmul_q8)
    return {"fused_matmul": fused_matmul, "fast_act": fast_act,
            "fused_matmul_q8": fused_matmul_q8,
            "decode_attention": decode_attention}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


# ---------------------------------------------------------------------------
def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    build.load()
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    ptxas = [l.strip() for l in log.splitlines()
             if "registers" in l or "Compiling entry" in l or "spill" in l]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "library": os.path.relpath(str(lib), ROOT), "ptxas": ptxas})


MAIN_DENSE_KN = [(128, 16), (16, 4), (256, 32), (32, 2), (256, 128),
                 (128, 128), (128, 10)]
#: B1 shapes beside the main path's (which hold M 1 and 256 at K 256),
#: each taking a path of its plan: the GEMV path's edge (M 16) and the
#: tiled path's (M 17), a ragged one, and deep K split across blocks.
#: Their tolerance is MATMUL_ATOL scaled by sqrt(K / 256): unit-normal
#: sums of K terms in another order.
DENSE_CHECK_MORE = [(16, 256, 128), (17, 256, 128), (300, 257, 130),
                    (256, 2048, 128), (1, 2048, 96)]
EPILOGUES = [  # (name, fn, fast, attrs, affine)
    ("none", None, False, {}, False),
    ("relu", "relu", False, {}, False),
    ("leaky_relu", "leaky_relu", False, {"alpha": 0.1}, False),
    ("elu", "elu", False, {}, False),
    ("tanh", "tanh", False, {}, False),
    ("tanh_fast", "tanh", True, {}, False),
    ("sigmoid", "sigmoid", False, {}, False),
    ("sigmoid_fast", "sigmoid", True, {}, False),
    ("relu_affine", "relu", False, {}, True),
]


def phase_check(torch, np):
    from repro_torch.kernels.fast_act import ref as fa_ref
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes += DENSE_CHECK_MORE
    worst, failures, cases, plans = 0.0, [], 0, {}
    split_worst, deterministic = 0.0, True
    for m, k, n in shapes:
        atol = MATMUL_ATOL * max(1.0, (k / 256) ** 0.5)
        x32 = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                           device=dev)
        wio = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                           device=dev)
        bias = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        scale = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32,
                             device=dev)
        offset = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                              device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for layout in ("io", "oi"):
                w = (wio if layout == "io" else wio.T.contiguous()).to(dtype)
                p = fm_k.plan(m, k, n, w_layout=layout,
                              itemsize=x.element_size())
                plans[f"{m}x{k}x{n} {layout}"] = p.describe()
                for name, fn, fast, attrs, affine in EPILOGUES:
                    s, o = (scale, offset) if affine else (None, None)
                    got = fused_matmul(x, w, bias, s, o, fn=fn, fast=fast,
                                       w_layout=layout, attrs=attrs)
                    want = fm_ref.fused_matmul_ref(
                        x.float(), w.float(), bias, s, o, fn=fn, fast=fast,
                        w_layout=layout, attrs=attrs)
                    err = float((got - want).abs().max())
                    cases += 1
                    worst = max(worst, err)
                    ok = err <= atol
                    if name == "relu_affine":
                        # The split reduction: against its plain emulation,
                        # and bit-equal from one call to the next.
                        split = fm_ref.fused_matmul_split_ref(
                            x.float(), w.float(), bias, s, o, fn=fn,
                            w_layout=layout, splits=p.splits, ksplit=p.ksplit)
                        split_worst = max(split_worst,
                                          float((got - split).abs().max()))
                        again = fused_matmul(x, w, bias, s, o, fn=fn,
                                             w_layout=layout)
                        same = bool(torch.equal(got, again))
                        deterministic &= same
                        ok &= same
                    if not ok:
                        failures.append([m, k, n, str(dtype), layout, name, err])
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "fused_matmul", "cases": cases,
          "max_abs_err": worst, "atol": MATMUL_ATOL,
          "atol_deep_k": "MATMUL_ATOL * sqrt(K / 256) for K > 256",
          "max_abs_err_vs_split_ref": split_worst,
          "deterministic_two_calls": deterministic,
          "inputs": "unit-normal x and W, f32 accumulation, TF32 off",
          "plans": plans, "failures": failures[:20]})
    fm_err = worst

    x = torch.tensor(rng.standard_normal((4097, 1000)) * 5.0,
                     dtype=torch.float32, device=dev)
    x[0, :241] = torch.linspace(-120.0, 120.0, 241, device=dev)
    fa_worst, fa_fail = 0.0, []
    for fn in ("exp", "tanh", "sigmoid"):
        got = fast_act(x, fn)
        want = fa_ref.FAST[fn](x)
        ulps = int((got.view(torch.int32).long()
                    - want.view(torch.int32).long()).abs().max())
        err = float((got - want).abs().max())
        fa_worst = max(fa_worst, err)
        xb = x.to(torch.bfloat16)
        gotb = fast_act(xb, fn)
        wantb = fa_ref.FAST[fn](xb.float()).to(torch.bfloat16)
        bf16_equal = bool(torch.equal(gotb, wantb))
        f32_bit_equal = bool(torch.equal(got, want))
        if ulps > 1 or not bf16_equal:
            fa_fail.append(fn)
        emit({"phase": "check", "kernel": "fast_act", "fn": fn,
              "shape": [4097, 1000], "f32_max_ulps": ulps,
              "f32_bit_equal": f32_bit_equal, "f32_max_abs_err": err,
              "bf16_equal": bf16_equal})
    torch.cuda.synchronize()
    problems = []
    if failures or fa_fail:
        problems.append(f"kernel checks failed: fused_matmul {len(failures)} "
                        f"cases, fast_act {fa_fail}")
    return fm_err, fa_worst, problems


def phase_check_q8(torch, np):
    """fused_matmul_q8 against its plain version at the int8 path's shapes
    and a ragged one, both layouts, every epilogue; then its quantize of
    ``x`` against ``quantize_q8`` on inputs placed exactly on .5 ties."""
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes.append((300, 257, 130))
    worst, failures, cases, equal_cases = 0.0, [], 0, 0
    for m, k, n in shapes:
        x_np = rng.standard_normal((m, k)).astype(np.float32)
        w_np = rng.standard_normal((k, n)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        xs = qmath.tensor_scale(float(np.abs(x_np).max()) * 0.8)  # some clip
        ws = qmath.channel_scales(w_np, 1)
        vec = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        bias = vec(rng.standard_normal(n))
        scale = vec(rng.uniform(0.5, 1.5, n))
        offset = vec(rng.standard_normal(n))
        xq = qmath.quantize_q8(x, xs)
        for layout in ("io", "oi"):
            w = torch.from_numpy(w_np if layout == "io"
                                 else np.ascontiguousarray(w_np.T)).to(dev)
            wq, deq = qmath.quantize_weight(w, xs, ws, layout)
            for name, fn, fast, attrs, affine in EPILOGUES:
                s, o = (scale, offset) if affine else (None, None)
                kw = dict(fn=fn, fast=fast, w_layout=layout, attrs=attrs)
                got = fused_matmul_q8(x, wq, deq, bias, s, o, x_scale=xs, **kw)
                want = fm_ref.fused_matmul_q8_ref(xq, wq, deq, bias, s, o, **kw)
                err = float((got - want).abs().max())
                equal = bool(torch.equal(got, want))
                cases += 1
                equal_cases += equal
                worst = max(worst, err)
                if not (equal if name in Q8_BIT_EQUAL else err <= Q8_ATOL):
                    failures.append([m, k, n, layout, name, err, equal])
    torch.cuda.synchronize()

    # The kernel's quantize of x, read through an identity W and deq = 1:
    # out = float(q(x)).  Ties of x / s in f32, for a scale that is not a
    # power of two and for one that is, then random values.
    tie_rows, tie_ok, n_ties = [], True, 0
    for s in (np.float32(0.1), np.float32(0.25)):
        half = np.arange(-140, 140) + 0.5
        cand = (half * s).astype(np.float32)
        ties = cand[(cand / s) == half]
        n_ties += len(ties)
        vals = np.concatenate([ties, rng.standard_normal(64).astype(np.float32)
                               * np.float32(40.0) * s])
        xt = torch.from_numpy(vals[None, :]).to(dev)
        t = vals.shape[0]
        eye = torch.eye(t, dtype=torch.int8, device=dev)
        ones = torch.ones(t, dtype=torch.float32, device=dev)
        got = fused_matmul_q8(xt, eye, ones, x_scale=float(s))
        want = qmath.quantize_q8(xt, float(s)).float()
        numpy_half_even = np.clip(np.round(vals / s), -127, 127)
        ok = (bool(torch.equal(got, want))
              and np.array_equal(want.cpu().numpy()[0], numpy_half_even))
        tie_ok &= ok
        tie_rows.append({"scale": float(s), "ties": int(len(ties)),
                         "values": int(t), "equal": ok})
    emit({"phase": "check", "kernel": "fused_matmul_q8", "cases": cases,
          "bit_equal_cases": equal_cases, "max_abs_err": worst,
          "bit_equal_for": list(Q8_BIT_EQUAL), "atol_others": Q8_ATOL,
          "inputs": "unit-normal x and W, x scale clipping 20% of |x|max",
          "quantize_ties": tie_rows, "failures": failures[:20]})
    problems = []
    if failures or not tie_ok or not n_ties:
        problems.append(f"fused_matmul_q8 checks failed: {len(failures)} "
                        f"cases, quantize ties equal: {tie_ok}")
    return worst, problems


def decode_inputs(torch, b, h, hkv, d, s, lengths, seed):
    """q (b, h, d) and K/V (b, s, hkv, d), unit normal, made on the card
    from ``seed``; lengths (b,) int32."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=DEVICE)
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    return q, k, v, lens


def phase_check_decode(torch, np):
    """decode_attention against its tiled plain form and its split
    emulation (the kernels' own algorithm), exact and fast, and against
    the one-pass form, exact: qwen2.5-14b's widths over the 32768-deep
    cache at batch 8, then the largest group (H 16, Hkv 1, D 256), no
    grouping at D 64 (H 36, Hkv 36), D 100 (scalar loads), and lengths
    on the chunk plan's edges.  Two calls on the same inputs must be
    bit-equal."""
    from repro_torch.kernels.decode_attention import kernel as attn_k
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention

    shapes = [(8, DECODE["h"], DECODE["hkv"], DECODE["d"], DECODE["s"],
               DECODE_LENGTHS[8])] + DECODE_CHECK_MORE
    worst, failures = 0.0, []
    for i, (b, h, hkv, d, s, lengths) in enumerate(shapes):
        q, k, v, lens = decode_inputs(torch, b, h, hkv, d, s, lengths, 20 + i)
        tpc, chunks = attn_k.chunk_plan(b, hkv, s)
        errs, deterministic = {}, True
        for fast in (False, True):
            got = decode_attention(q, k, v, lens, fast=fast)
            deterministic &= bool(torch.equal(
                got, decode_attention(q, k, v, lens, fast=fast)))
            want = attn_ref.decode_attention_tiled(q, k, v, lens, fast=fast)
            tag = "fast" if fast else "exact"
            errs[f"{tag}_vs_tiled"] = float((got - want).abs().max())
            split = attn_ref.decode_attention_split(
                q, k, v, lens, tiles_per_chunk=tpc, fast=fast)
            errs[f"{tag}_vs_split"] = float((got - split).abs().max())
            if not fast:
                one = attn_ref.decode_attention_ref(q, k, v, lens)
                errs["exact_vs_one_pass"] = float((got - one).abs().max())
        torch.cuda.synchronize()
        # Masking: rows past a length must not matter.
        k2, v2 = k.clone(), v.clone()
        for bi, n in enumerate(lengths):
            k2[bi, n:] = 1e4
            v2[bi, n:] = float("nan")
        masked_equal = bool(torch.equal(decode_attention(q, k2, v2, lens),
                                        decode_attention(q, k, v, lens)))
        del k2, v2
        worst = max(worst, *errs.values())
        ok = (all(e <= DECODE_ATOL for e in errs.values()) and masked_equal
              and deterministic)
        if not ok:
            failures.append([b, h, hkv, d, s, errs, masked_equal,
                             deterministic])
        emit({"phase": "check", "kernel": "decode_attention",
              "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s},
              "lengths": lengths, "plan": {"tiles_per_chunk": tpc,
                                           "chunks": chunks},
              "max_abs_err": errs, "atol": DECODE_ATOL,
              "rows_past_length_ignored": masked_equal,
              "deterministic_two_calls": deterministic, "ok": ok})
    problems = []
    if failures:
        problems.append(f"decode_attention checks failed: {failures}")
    return worst, problems


def expected_launches(graph):
    """Kernel launches per inference, read off the source graph and not
    off the selector: one ``fused_matmul`` per dense node, and under
    ``precision="fast"`` one ``fast_act`` (its exp) per softmax node --
    the Table-1 graphs' only activations with a fast_act form."""
    return (sum(n.op == "dense" for n in graph.nodes),
            sum(n.op == "softmax" for n in graph.nodes))


def phase_main(torch, np):
    import repro_torch
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul.ops import fused_matmul
    from repro_torch.table1_models import SUITE

    rng = np.random.default_rng(0)
    exes, inputs, failures, expect = {}, {}, [], {}
    for name, build_graph in SUITE.items():
        g = build_graph()
        expect[name] = expected_launches(g)
        for prec in ("exact", "fast"):
            exes[name, "cuda", prec] = repro_torch.compile(
                g, repro_torch.CompileOptions(target="cuda", precision=prec,
                                              device=DEVICE))
        exes[name, "interpret", "exact"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="interpret", device=DEVICE))
        exes[name, "jit", "exact"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="jit", device=DEVICE))
        exes[name, "cpu", "fast"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="cuda", precision="fast",
                                          device="cpu"))
        for b in BATCHES:
            inputs[name, b] = rng.standard_normal(
                (b,) + tuple(g.inputs["input"].shape)).astype(np.float32)

    # The main path: every count set to 0 just before, read just after.
    reset_counts()
    outs = {}
    expect_total = {"fused_matmul": 0, "fast_act": 0}
    per_model = {}
    for name in SUITE:
        for b in BATCHES:
            for prec in ("exact", "fast"):
                exe = exes[name, "cuda", prec]
                fm0, fa0 = fused_matmul.launches, fast_act.launches
                out = exe(input=inputs[name, b])
                torch.cuda.synchronize()
                outs[name, b, prec] = out
                n_fm, n_fa = expect[name]
                n_fa = n_fa if prec == "fast" else 0
                expect_total["fused_matmul"] += n_fm
                expect_total["fast_act"] += n_fa
                per_model[name, b, prec] = {
                    "fused_matmul": fused_matmul.launches - fm0,
                    "fast_act": fast_act.launches - fa0,
                    "expected": {"fused_matmul": n_fm, "fast_act": n_fa}}
    launches = read_counts()

    for name in SUITE:
        for b in BATCHES:
            x = inputs[name, b]
            want = exes[name, "interpret", "exact"](input=x)
            got = outs[name, b, "exact"]
            err_exact = max(float((got[k] - want[k]).abs().max()) for k in want)
            want_f = exes[name, "cpu", "fast"](input=x)
            got_f = outs[name, b, "fast"]
            err_fast = max(float((got_f[k].cpu() - want_f[k]).abs().max())
                           for k in want_f)
            ref_mag = max(float(want[k].abs().max()) for k in want)
            finite = all(bool(torch.isfinite(v).all())
                         for o in (got, got_f) for v in o.values())
            shapes_ok = all(tuple(got[k].shape) == tuple(want[k].shape)
                            for k in want)
            counts = {p: per_model[name, b, p] for p in ("exact", "fast")}
            ok = (err_exact <= EXACT_ATOL and err_fast <= FAST_ATOL and finite
                  and shapes_ok
                  and all(c[k] == c["expected"][k] for c in counts.values()
                          for k in ("fused_matmul", "fast_act")))
            if not ok:
                failures.append([name, b])
            sel = exes[name, "cuda", "exact"].cost_summary().get(
                "kernel_selection", {}).get(b, [])
            emit({"phase": "main", "model": name, "batch": b,
                  "out_shape": {k: list(v.shape) for k, v in got.items()},
                  "max_abs_err_exact_vs_interpret": err_exact,
                  "max_abs_err_fast_vs_cpu": err_fast,
                  "max_abs_ref": ref_mag, "finite": finite,
                  "launches": counts, "ok": ok,
                  "kernel_selection": [[c["node"], c["kernel"], c["reason"]]
                                       for c in sel]})
    emit({"phase": "main", "launches": launches, "expected": expect_total,
          "failures": failures})
    problems = []
    expect_all = dict(expect_total, fused_matmul_q8=0, decode_attention=0)
    if failures or launches != expect_all or not all(expect_total.values()):
        problems.append(f"main path failed: {failures}, launches {launches}, "
                        f"expected {expect_all}")
    return exes, inputs, launches, per_model, problems


def phase_path_a(torch, np, exes, inputs):
    """Path A: ``precision="int8"`` and ``"bf16"`` compiled for ``cuda`` and
    ``jit`` on the card.  cuDNN runs deterministic algorithms here, so
    the convolutions before each dense node give the same bits on both
    targets and the int8 outputs can be held bit-equal."""
    import repro_torch
    from repro_torch.table1_models import SUITE

    modes = {"int8": INT8_MODELS, "bf16": tuple(SUITE)}
    for prec, models in modes.items():
        for name in models:
            g = SUITE[name]()
            for target in ("cuda", "jit"):
                exes[name, target, prec] = repro_torch.compile(
                    g, repro_torch.CompileOptions(
                        target=target, precision=prec, device=DEVICE,
                        calibrate=4 if prec == "int8" else None))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # The path: every count set to 0 just before, read just after.
        reset_counts()
        outs, per = {}, {}
        for prec, models in modes.items():
            for name in models:
                for b in BATCHES:
                    c0 = read_counts()
                    outs[name, b, prec] = exes[name, "cuda", prec](
                        input=inputs[name, b])
                    torch.cuda.synchronize()
                    per[name, b, prec] = {k: v - c0[k]
                                          for k, v in read_counts().items()}
        launches = read_counts()
        rows, failures = [], []
        for prec, models in modes.items():
            for name in models:
                dense = sum(n.op == "dense" for n in SUITE[name]().nodes)
                want_counts = {k: 0 for k in KERNELS}
                want_counts["fused_matmul_q8" if prec == "int8"
                            else "fused_matmul"] = dense
                for b in BATCHES:
                    got = outs[name, b, prec]
                    jit = exes[name, "jit", prec](input=inputs[name, b])
                    ref = exes[name, "interpret", "exact"](input=inputs[name, b])
                    err_jit = max(float((got[k] - jit[k]).abs().max())
                                  for k in jit)
                    equal_jit = all(bool(torch.equal(got[k], jit[k]))
                                    for k in jit)
                    per_example = torch.stack([
                        (got[k] - ref[k]).abs().flatten(1).amax(1)
                        for k in ref]).amax(0)
                    err_ref = float(per_example.max())
                    err_median = float(per_example.median())
                    finite = all(bool(torch.isfinite(v).all())
                                 for v in got.values())
                    shapes_ok = all(tuple(got[k].shape) == tuple(ref[k].shape)
                                    for k in ref)
                    ref_mag = max(float(ref[k].abs().max()) for k in ref)
                    budget = QUANT_BUDGET * max(1.0, ref_mag)
                    ok = (finite and shapes_ok and err_median <= budget
                          and (equal_jit if prec == "int8"
                               else err_jit <= BF16_ATOL)
                          and per[name, b, prec] == want_counts)
                    if not ok:
                        failures.append([name, b, prec])
                    quant = exes[name, "cuda", prec].cost_summary().get("quant")
                    rows.append(dict(
                        phase="main", path="A", model=name, batch=b,
                        precision=prec, bit_equal_cuda_vs_jit=equal_jit,
                        max_abs_err_cuda_vs_jit=err_jit,
                        max_abs_err_vs_interpret_exact=err_ref,
                        median_example_err_vs_interpret_exact=err_median,
                        examples_over_budget=int((per_example > budget).sum()),
                        max_abs_ref=ref_mag, budget=budget,
                        finite=finite, quant=quant,
                        launches=per[name, b, prec], expected=want_counts,
                        ok=ok))
                    emit(rows[-1])
    finally:
        torch.backends.cudnn.deterministic = prev
    emit({"phase": "main", "path": "A", "launches": launches,
          "cudnn_deterministic": True, "failures": failures})
    problems = []
    if failures or not (launches["fused_matmul"] and launches["fused_matmul_q8"]):
        problems.append(f"path A failed: {failures}, launches {launches}")
    return launches, problems


def decode_graph(repro_torch):
    """One decode_attention node at qwen2.5-14b's attention widths, its
    per-example lengths a graph input."""
    mb = repro_torch.ModelBuilder()
    q = mb.input((DECODE["h"], DECODE["d"]), name="q")
    k = mb.input((DECODE["s"], DECODE["hkv"], DECODE["d"]), name="k")
    v = mb.input((DECODE["s"], DECODE["hkv"], DECODE["d"]), name="v")
    lengths = mb.input((), name="lengths", dtype="int32")
    return mb.build([mb.decode_attention(q, k, v, lengths)])


def phase_path_b(torch, np):
    """Path B: the decode graph on ``cuda`` at batch 1 and 8, exact
    against ``interpret`` on the card, fast against the same compile on
    the CPU (batch 1); exactly one decode_attention launch per call."""
    import repro_torch

    g = decode_graph(repro_torch)
    opts = repro_torch.CompileOptions
    exes = {(t, p): repro_torch.compile(g, opts(target=t, precision=p,
                                                device=DEVICE))
            for t, p in (("cuda", "exact"), ("cuda", "fast"),
                         ("interpret", "exact"))}
    exes["cpu", "fast"] = repro_torch.compile(
        g, opts(target="cuda", precision="fast", device="cpu"))
    feeds = {}
    for b, lengths in DECODE_LENGTHS.items():
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"], lengths, 30 + b)
        feeds[b] = {"q": q, "k": k, "v": v, "lengths": lens}

    # The path: every count set to 0 just before, read just after.
    reset_counts()
    outs, per = {}, {}
    for b in DECODE_LENGTHS:
        for prec in ("exact", "fast"):
            c0 = read_counts()
            outs[b, prec] = exes["cuda", prec](**feeds[b])
            torch.cuda.synchronize()
            per[b, prec] = {k: v - c0[k] for k, v in read_counts().items()}
    launches = read_counts()

    want_counts = {k: int(k == "decode_attention") for k in KERNELS}
    failures = []
    for b in DECODE_LENGTHS:
        (key,) = outs[b, "exact"]
        got, got_f = outs[b, "exact"][key], outs[b, "fast"][key]
        want = exes["interpret", "exact"](**feeds[b])[key]
        err_exact = float((got - want).abs().max())
        err_fast = None
        if b == 1:
            cpu = {n: t.cpu() for n, t in feeds[b].items()}
            err_fast = float((got_f.cpu()
                              - exes["cpu", "fast"](**cpu)[key]).abs().max())
        finite = bool(torch.isfinite(got).all() and torch.isfinite(got_f).all())
        ok = (finite and tuple(got.shape) == (b, DECODE["h"], DECODE["d"])
              and err_exact <= DECODE_ATOL
              and (err_fast is None or err_fast <= DECODE_ATOL)
              and all(per[b, p] == want_counts for p in ("exact", "fast")))
        if not ok:
            failures.append([b, err_exact, err_fast])
        emit({"phase": "main", "path": "B", "batch": b, "shape": DECODE,
              "lengths": DECODE_LENGTHS[b], "out_shape": list(got.shape),
              "max_abs_err_exact_vs_interpret": err_exact,
              "max_abs_err_fast_vs_cpu": err_fast, "atol": DECODE_ATOL,
              "max_abs_ref": float(want.abs().max()), "finite": finite,
              "launches": {p: per[b, p] for p in ("exact", "fast")},
              "kernel_selection": exes["cuda", "exact"].cost_summary()
              ["kernel_selection"][b][0]["reason"], "ok": ok})
    emit({"phase": "main", "path": "B", "launches": launches,
          "failures": failures})
    problems = []
    if failures or not launches["decode_attention"]:
        problems.append(f"path B failed: {failures}, launches {launches}")
    return exes, feeds, launches, problems


def phase_time_models(torch, exes, inputs, per_model):
    from repro_torch.table1_models import SUITE
    for name in SUITE:
        for b in BATCHES:
            x = inputs[name, b]
            row = {"phase": "time", "model": name, "batch": b}
            for key in (("interpret", "exact"), ("jit", "exact"),
                        ("cuda", "exact"), ("cuda", "fast")):
                exe = exes[(name,) + key]
                xt = torch.as_tensor(x, device=DEVICE)
                row["_".join(key) + "_ms"] = host_median_ms(lambda: exe(input=xt))
            exe = exes[name, "cuda", "exact"]
            row["cuda_exact_device_ms"] = device_ms(lambda: exe(input=xt))
            row["cuda_exact_queued_ms"] = queued_ms(
                lambda: exe(input=xt), iters=5, spin=400_000_000)
            if row["cuda_exact_device_ms"] is not None:
                row["cuda_exact_device_busy"] = (row["cuda_exact_device_ms"]
                                                 / row["cuda_exact_ms"])
            row["interpret_over_cuda"] = row["interpret_exact_ms"] / row["cuda_exact_ms"]
            row["interpret_over_jit"] = row["interpret_exact_ms"] / row["jit_exact_ms"]
            row["launches_per_inference"] = {
                p: {k: v for k, v in per_model[name, b, p].items()
                    if k != "expected"} for p in ("exact", "fast")}
            emit(row)


def phase_time_kernels(torch, np, exes):
    import torch.nn.functional as F
    from repro_torch.kernels.fast_act import ref as fa_ref
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul
    from repro_torch.table1_models import SUITE

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    rows = {"fused_matmul": [], "fast_act": []}
    saved = (fused_matmul.launches, fast_act.launches)
    for name in SUITE:
        exe = exes[name, "cuda", "exact"]
        g = exe.graph
        specs = g.infer_shapes()
        for node in g.nodes:
            if node.op != "dense":
                continue
            w = exe.params[node.params["kernel"]]
            layout = node.attrs.get("kernel_layout", "io")
            k = specs[node.inputs[0]].shape[-1]
            n = w.shape[1] if layout == "io" else w.shape[0]
            b = exe.params[node.params["bias"]] if "bias" in node.params else None
            fn = node.epilogue if node.epilogue not in (None, "linear") else None
            pa = node.epilogue_attrs.get("post_affine")
            s, o = (exe.params[pa[0]], exe.params[pa[1]]) if pa else (None, None)
            if fn not in (None, "relu"):
                raise SystemExit(f"{name} {node.name}: no library yardstick "
                                 f"for the {fn} epilogue")
            w_lin = w if layout == "oi" else w.T
            act = F.relu if fn == "relu" else (lambda y: y)
            aff = (lambda y: y * s + o) if pa else (lambda y: y)
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m, k)),
                                 dtype=torch.float32, device=dev)
                ms = cold_ms(lambda: fused_matmul(x, w, b, s, o, fn=fn,
                                                  w_layout=layout))
                call = cuda_ms(lambda: fused_matmul(x, w, b, s, o, fn=fn,
                                                    w_layout=layout))
                plain = cold_ms(lambda: fm_ref.fused_matmul_ref(
                    x, w, b, s, o, fn=fn, w_layout=layout))
                lib = cold_ms(lambda: aff(act(F.linear(x, w_lin, b))))
                vecs = sum(v is not None for v in (b, s, o))
                nbytes = 4 * (m * k + k * n + vecs * n + m * n)
                bnd, by = bound_ms(nbytes, 2.0 * m * k * n)
                row = {"phase": "time", "kernel": "fused_matmul",
                       "model": name, "node": node.name, "M": m, "K": k,
                       "N": n, "layout": layout, "epilogue": fn or "none",
                       "plan": fm_k.plan(m, k, n, w_layout=layout).describe(),
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bnd, "bound_by": by}
                rows["fused_matmul"].append(row)
                emit(row)
        if any(nd.op == "softmax" for nd in SUITE[name]().nodes):
            shape = tuple(exe.signature.outputs[0][1].shape)
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m,) + shape),
                                 dtype=torch.float32, device=dev)
                ms = cold_ms(lambda: fast_act(x, "exp"))
                call = cuda_ms(lambda: fast_act(x, "exp"))
                plain = cold_ms(lambda: fa_ref.schraudolph_exp(x))
                lib = cold_ms(lambda: torch.exp(x))
                nel = x.numel()
                # clamp (2), multiply, add, convert per element
                bnd, by = bound_ms(8.0 * nel, 5.0 * nel)
                row = {"phase": "time", "kernel": "fast_act", "fn": "exp",
                       "model": name, "shape": [m, *shape], "ms": ms,
                       "call_ms": call, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by}
                rows["fast_act"].append(row)
                emit(row)
    torch.cuda.synchronize()
    fused_matmul.launches, fast_act.launches = saved
    return rows


def phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds):
    """Host medians of the int8, bf16 and decode compiles (the per-model
    rows of path 1 are ``phase_time_models``')."""
    from repro_torch.table1_models import SUITE
    for prec, models in (("int8", INT8_MODELS), ("bf16", tuple(SUITE))):
        for name in models:
            for b in BATCHES:
                xt = torch.as_tensor(inputs[name, b], device=DEVICE)
                row = {"phase": "time", "path": "A", "model": name,
                       "batch": b, "precision": prec}
                for target in ("cuda", "jit"):
                    exe = exes[name, target, prec]
                    row[f"{target}_ms"] = host_median_ms(lambda: exe(input=xt))
                exe = exes[name, "cuda", prec]
                row["cuda_device_ms"] = device_ms(lambda: exe(input=xt))
                emit(row)
    for b, feeds in dec_feeds.items():
        row = {"phase": "time", "path": "B", "batch": b, "shape": DECODE}
        for t, p in (("cuda", "exact"), ("cuda", "fast"), ("interpret", "exact")):
            exe = dec_exes[t, p]
            row[f"{t}_{p}_ms"] = host_median_ms(lambda: exe(**feeds), runs=10)
        exe = dec_exes["cuda", "exact"]
        row["cuda_exact_device_ms"] = device_ms(lambda: exe(**feeds), iters=5)
        emit(row)


def phase_time_q8(torch, np, exes):
    """fused_matmul_q8 at every int8 dense node of path A, batch 1 and
    256: the kernel, its plain version, ``torch._int_mm`` where its shape
    rules allow it (the integer product alone), and the bound."""
    from repro_torch.core.lowering import quant_key
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    rows = []
    saved = fused_matmul_q8.launches
    for name in INT8_MODELS:
        exe = exes[name, "cuda", "int8"]
        g = exe.graph
        specs = g.infer_shapes()
        for node in g.nodes:
            if node.op != "dense":
                continue
            p = exe.params
            wq, deq = p[quant_key(node, "wq")], p[quant_key(node, "deq")]
            xs, xs_t = node.attrs["quant.x_scale"], p[quant_key(node, "x_scale")]
            layout = node.attrs.get("kernel_layout", "io")
            k = specs[node.inputs[0]].shape[-1]
            n = wq.shape[1] if layout == "io" else wq.shape[0]
            b = p[node.params["bias"]] if "bias" in node.params else None
            fn = node.epilogue if node.epilogue not in (None, "linear") else None
            pa = node.epilogue_attrs.get("post_affine")
            s, o = (p[pa[0]], p[pa[1]]) if pa else (None, None)
            w_kn = wq if layout == "io" else wq.T
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m, k)),
                                 dtype=torch.float32, device=dev)
                kw = dict(fn=fn, w_layout=layout)
                ms = cold_ms(lambda: fused_matmul_q8(x, wq, deq, b, s, o,
                                                     x_scale=xs, **kw))
                call = cuda_ms(lambda: fused_matmul_q8(x, wq, deq, b, s, o,
                                                       x_scale=xs, **kw))
                plain = cold_ms(lambda: fm_ref.fused_matmul_q8_ref(
                    qmath.quantize_q8(x, xs_t), wq, deq, b, s, o, **kw))
                xq = qmath.quantize_q8(x, xs_t)
                try:
                    lib, lib_note = cold_ms(lambda: torch._int_mm(xq, w_kn)), \
                        "torch._int_mm (int8 operands, int32 out)"
                except RuntimeError as e:
                    lib, lib_note = None, f"torch._int_mm refused: {str(e)[:80]}"
                vecs = sum(v is not None for v in (b, s, o))
                nbytes = 4 * m * k + k * n + 4 * n * (1 + vecs) + 4 * m * n
                bnd, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
                row = {"phase": "time", "kernel": "fused_matmul_q8",
                       "model": name, "node": node.name, "M": m, "K": k,
                       "N": n, "layout": layout, "epilogue": fn or "none",
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "library": lib_note,
                       "bound_ms": bnd, "bound_by": by}
                rows.append(row)
                emit(row)
    torch.cuda.synchronize()
    fused_matmul_q8.launches = saved
    return rows


def phase_time_decode(torch, dec_feeds):
    """decode_attention at path B's inputs: the kernel, the tiled plain
    form, the library's masked GQA ``scaled_dot_product_attention``, and
    the bound (K and V up to each length read once, q read and the
    output written once; 4·H·D operations per valid row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as attn_k
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention

    rows = []
    saved = decode_attention.launches
    h, hkv, d, s = DECODE["h"], DECODE["hkv"], DECODE["d"], DECODE["s"]
    for b, f in dec_feeds.items():
        q, k, v, lens = f["q"], f["k"], f["v"], f["lengths"]
        ms = cold_ms(lambda: decode_attention(q, k, v, lens), iters=10)
        call = cuda_ms(lambda: decode_attention(q, k, v, lens), iters=10,
                       warmup=2)
        # The same kernel with scalar loads: K and V copied one float off
        # 16-byte alignment, which rules out its float4 path.
        k1, v1 = (torch.empty(t.numel() + 1, device=DEVICE)[1:].view(t.shape)
                  .copy_(t) for t in (k, v))
        scalar = cold_ms(lambda: decode_attention(q, k1, v1, lens), iters=10)
        del k1, v1
        plain = cold_ms(lambda: attn_ref.decode_attention_tiled(q, k, v, lens),
                        iters=5, warmup=1)
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        try:
            lib = cold_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), iters=5, warmup=1)
            lib_note = "F.scaled_dot_product_attention(enable_gqa, bool mask)"
        except RuntimeError as e:
            lib, lib_note = None, f"sdpa refused: {str(e)[:80]}"
        rows_valid = sum(DECODE_LENGTHS[b])
        nbytes = 2 * rows_valid * hkv * d * 4 + 2 * b * h * d * 4 + 4 * b
        bnd, by = bound_ms(nbytes, 4.0 * h * d * rows_valid)
        tpc, chunks = attn_k.chunk_plan(b, hkv, s)
        # Device time of each of the call's kernels (warm L2), by name.
        split = {}
        for name, t in device_ms_by_kernel(
                lambda: decode_attention(q, k, v, lens), 5).items():
            part = next((p for p in ("scores", "pv", "combine")
                         if f"{p}_kernel" in name), name[:60])
            split[part] = split.get(part, 0.0) + t
        row = {"phase": "time", "kernel": "decode_attention", "batch": b,
               "shape": DECODE, "lengths": DECODE_LENGTHS[b],
               "plan": f"{tpc} tiles a chunk, {chunks} chunks x {b * hkv} "
                       f"(batch, KV head): {b * hkv * chunks} blocks; "
                       f"{attn_k.KERNELS_PER_CALL} kernels a call", "ms": ms,
               "call_ms": call, "kernels_device_ms": split,
               "scalar_loads_ms": scalar,
               "plain_ms": plain, "library_ms": lib,
               "library": lib_note, "bound_ms": bnd, "bound_by": by}
        rows.append(row)
        emit(row)
    torch.cuda.synchronize()
    decode_attention.launches = saved
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is on; the "
                         "f32 comparisons need it off")
    phase_card(torch)
    phase_build()
    errs = {}
    errs["fused_matmul"], errs["fast_act"], problems = phase_check(torch, np)
    errs["fused_matmul_q8"], more = phase_check_q8(torch, np)
    problems += more
    errs["decode_attention"], more = phase_check_decode(torch, np)
    problems += more
    exes, inputs, launches, per_model, more = phase_main(torch, np)
    problems += more
    launches_a, more = phase_path_a(torch, np, exes, inputs)
    problems += more
    dec_exes, dec_feeds, launches_b, more = phase_path_b(torch, np)
    problems += more
    totals = {k: launches[k] + launches_a[k] + launches_b[k] for k in KERNELS}
    phase_time_models(torch, exes, inputs, per_model)
    phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds)
    rows = phase_time_kernels(torch, np, exes)
    rows["fused_matmul_q8"] = phase_time_q8(torch, np, exes)
    rows["decode_attention"] = phase_time_decode(torch, dec_feeds)
    if problems:
        # Every phase ran and printed its findings; now fail.
        raise SystemExit("chip_smoke failed: " + "; ".join(problems))

    def summary(kernel, source, replaces, row, at):
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces, "launches": totals[kernel],
                "max_abs_err": errs[kernel], "ms": row["ms"],
                "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "at": at}

    mkn = lambda r: r["M"] * r["K"] * r["N"]
    fm_row = max(rows["fused_matmul"], key=mkn)
    q8_row = max(rows["fused_matmul_q8"], key=mkn)
    fa_row = max(rows["fast_act"], key=lambda r: int(np.prod(r["shape"])))
    da_row = max(rows["decode_attention"], key=lambda r: r["batch"])
    emit({"kernels": [
        summary("fused_matmul", "src/repro_torch/csrc/fused_matmul.cu",
                "src/repro/kernels/fused_matmul/kernel.py:109", fm_row,
                f"{fm_row['model']} {fm_row['node']} M={fm_row['M']} "
                f"K={fm_row['K']} N={fm_row['N']} {fm_row['layout']}"),
        summary("fast_act", "src/repro_torch/csrc/fast_act.cu",
                "src/repro/kernels/fast_act/kernel.py:61", fa_row,
                f"{fa_row['model']} softmax exp {fa_row['shape']}"),
        summary("fused_matmul_q8", "src/repro_torch/csrc/fused_matmul_q8.cu",
                "src/repro/kernels/fused_matmul/kernel.py:224", q8_row,
                f"{q8_row['model']} {q8_row['node']} M={q8_row['M']} "
                f"K={q8_row['K']} N={q8_row['N']} {q8_row['layout']} int8"),
        summary("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention/kernel.py:80", da_row,
                f"qwen2.5-14b B={da_row['batch']} H={DECODE['h']} "
                f"Hkv={DECODE['hkv']} D={DECODE['d']} S={DECODE['s']} "
                f"lengths {da_row['lengths']}"),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if _OUT:
            save_log()
    sys.exit(rc)
