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
   ``engine``    the LLM stack through ``repro_torch.compile(cfg,
                 target="engine")``, in a child process (``python3
                 chip_smoke.py --engine``) that has the card's memory to
                 itself: (a) the seven transformer-family SMOKE configs on
                 the card against the CPU, the same weights made on the
                 CPU from a seed (f32 forward within 1e-4 x max(1,
                 max|logits|), prefill plus 8 greedy steps giving the same
                 tokens, bf16 forward within the 0.05 budget); (b)
                 qwen2.5-14b whole (48 layers, made on the card): prefill
                 and decode against the forward at f32, then prefill
                 (4 x 512) and decode (batch 1 and 8; bf16 also at
                 decode_32k's depth, batch 4) ms, tokens/s, busy share,
                 bound and top device ops, over f32 masters ("exact") and
                 bf16 weights; (c) mixtral-8x22b at its widths, 2 layers,
                 decode against forward past its 4096-token ring.  No
                 kernel of ``csrc/`` is on this path: the reference's LLM
                 attention is jnp, computed here with torch ops.
3. ``check``     each kernel against its plain torch version on the card,
                 at the main path's shapes and the edges of each kernel's
                 plan (paths, K splits, ragged and unaligned shapes).
4. ``main``      the six Table-1 CNNs through ``repro_torch.compile(...,
                 target="cuda")`` at batch 1 and 256: ``exact`` against
                 ``interpret`` on the card, ``fast`` against the same
                 compile on the CPU (path 1); ``int8``/``bf16`` against
                 ``jit`` (path A); decode attention at qwen2.5-14b's
                 widths (path B).  Each path sets the wrappers' counts
                 to 0, prepares its programs (a warm-up call and a
                 captured call each, both through the wrappers, which
                 count them), then calls each program once under
                 ``torch.profiler``: a replay passes through no wrapper,
                 so its launches are counted from the kernel names, and
                 held against the graphs' dense and softmax nodes.
5. ``program``   every captured program of paths 1, A and B against the
                 eager program it was captured from: bit-equal on two
                 different inputs, the first call's outputs unchanged by
                 the second (fresh clones), and the launches of one
                 replay from the profiler; capture time and the graph
                 pool's bytes per program.
                 ``split_counters``: a captured program still replays
                 bit-equal after its split counters grew and after a
                 larger plan was captured.
6. ``runtime``   batch buckets: ``buckets=BucketPolicy`` (the engine
                 cache, a bucket captured in the background while a
                 warm one serves) and the legacy ``batch_buckets``, each
                 output bit-equal to the bucket's program on the padded
                 input and close to ``interpret``.
7. ``cache``     ``serialize``/``deserialize`` bit-equal, and a second
                 process that takes every program's entry from the
                 executable cache, runs no pass pipeline and gives the
                 first process's outputs bit for bit.
8. ``pool``      one graph pool per executable: VGG19 exact at 8 batch
                 sizes between 129 and 256, the largest first: the
                 growth of ``memory_reserved`` within the batch-256
                 pool plus the static inputs and outputs (+10%), beside
                 what 8 private pools take; replays in reverse and
                 shuffled order bit-equal to the eager walk; the same in
                 ascending order, and in a child process whose allocator
                 rounds requests to half powers of two (reported); the pool
                 bytes of paths 1, A and B.
9. ``autotune``  every tactic grid point of B1, B2 and B4 against its
                 plain version at the main path's shapes; C-HTWK and
                 VGG19 at exact and int8 (batch 1 and 256) and path B's
                 decode node (batch 8) with ``autotune="full"``: each
                 node's candidates in device µs and its winner, each
                 graph decision's, every tuned program within its path's
                 bound of ``interpret`` and bit-equal to its eager walk,
                 tuned against heuristic time; a second process with
                 ``autotune="cached"`` measures nothing and matches bit
                 for bit.
10. ``mixed``    ``precision="mixed"`` for C-HTWK, C-BH and VGG19 (batch 1
                 and 256): per-site candidates, errors and winners, each
                 within budget, the median example within the path-A
                 budget of ``interpret``; seeded all-int8 and all-f32
                 winners bit-equal to the int8 and f32 programs.
11. ``frontends`` C-HTWK and VGG19 written as functions over
                 ``repro_torch.frontends.ops`` and traced, at exact and
                 fast (batch 1 and 256) and C-HTWK at int8 (batch 256);
                 ``ops.decode_attention`` at path B's widths (batch 1);
                 both models compiled from an ``.npz`` path, a
                 ModelBuilder without ``.build()`` and a bare callable
                 with ``example_inputs=`` on the card: each bit-equal to
                 the main path's program, each replay's launches (the
                 profiler's) equal to that program's.
12. ``replay``   capture bundles of VGG19 exact and C-HTWK int8 with
                 ``autotune="full"`` (batch 256 then 1) in
                 ``chiprun_out/bundles``, each replayed by ``python -m
                 repro_torch.replay --json`` in a fresh process (exit 0,
                 bit-exact, selections and tactics equal); a copy with a
                 byte of ``io.npz`` flipped exits 2.  Bundle bytes, the
                 record's seconds per batch, the replay's seconds.
13. ``time``     medians of interpret/jit/cuda per model and batch (host
                 clock around a synchronised call), captured and eager,
                 with the device's busy time per inference, exact and
                 fast (``torch.profiler``, which sees the kernels inside
                 a graph replay by name); per kernel at the
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
#: The order programs are prepared in: the largest batch first, the
#: layout of an executable's graph pool, so that no program is captured
#: again (a larger batch after a smaller one recaptures it, which the
#: wrappers would count).
PREPARE = tuple(sorted(BATCHES, reverse=True))
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
#: Calls of the eager program that preparing one captured program makes,
#: each through the wrappers: the warm-up and the captured call
#: (``core/program.py``).
PREPARE_CALLS = 2
#: The CUDA kernels of each wrapper by symbol (``csrc/``), to count the
#: launches on the card from the profiler's kernel names.
#: decode_attention counts calls: its combine kernel runs once per call.
KERNEL_SYMBOLS = {
    "fused_matmul": ("fm_gemv_kernel<", "fm_tiled_kernel<"),
    "fused_matmul_q8": ("q8_gemv_oi_kernel<", "q8_gemv_io_kernel<",
                        "q8_tiled_kernel<"),
    "fast_act": ("fast_act_kernel<",),
    "decode_attention": ("combine_kernel",),
}
#: The runtime phase: a bucket policy over the main path's batches, the
#: batches sent through it, and the legacy batch_buckets.
RUNTIME_POLICY = (1, 4, 16, 64, 256)
RUNTIME_BATCHES = (1, 3, 17, 100, 256)
RUNTIME_MODELS = ("VGG19", "C-HTWK")
LEGACY_BUCKETS = (4, 256)
#: The cache phase's compiles, made again by a second process.
CACHE_COMPILES = (("C-HTWK", "int8"), ("VGG19", "exact"))
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


def device_profile(fn, iters: int = 20):
    """Each CUDA kernel ``fn()`` launched, by name, from ``torch.profiler``
    over ``iters`` calls: (launches per call, device ms per call).  The
    profiler sees the kernels inside a CUDA graph replay by name."""
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
        n, ms = out.get(evt.key, (0.0, 0.0))
        out[evt.key] = (n + evt.count / iters, ms + t / iters / 1e3)
    return out


def device_ms_by_kernel(fn, iters: int = 20):
    """Device time per call of ``fn()`` of each CUDA kernel it launched,
    by name, from ``torch.profiler`` over ``iters`` calls."""
    return {k: ms for k, (_, ms) in device_profile(fn, iters).items() if ms}


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn()``: the sum of every CUDA kernel it
    launched; None when the profiler recorded no device time twice (a
    profile now and then comes back empty)."""
    total = sum(device_ms_by_kernel(fn, iters).values())
    total = total or sum(device_ms_by_kernel(fn, iters).values())
    return total or None


def profiled_call(fn):
    """``fn()`` once under ``torch.profiler``, synchronised: its result
    and the launches on the card of each wrapper's kernels, counted from
    the kernel names (KERNEL_SYMBOLS), inside graph replays too.  A
    profile that recorded no kernel at all is taken again: now and then
    one comes back empty, or with the call's copies and none of its
    replay's kernels, while the outputs show the replay ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        counts = {k: 0 for k in KERNELS}
        kernels = 0
        for evt in prof.key_averages():
            if "CUDA" not in str(getattr(evt, "device_type", "")):
                continue
            if not evt.key.startswith(("Memcpy", "Memset")):
                kernels += evt.count
            for kernel, symbols in KERNEL_SYMBOLS.items():
                if any(sym in evt.key for sym in symbols):
                    counts[kernel] += evt.count
        if kernels:
            break
    return out, counts


def eager_call(exe, feeds):
    """The outputs of the eager program (the LoweredGraph walk) that
    ``exe``'s program for this batch was captured from, on ``feeds``,
    keyed like ``exe(**feeds)``."""
    import torch
    env = {n: torch.as_tensor(feeds[n], device=DEVICE) for n in exe.graph.inputs}
    batch = next(iter(env.values())).shape[0]
    prog = exe.ensure_compiled(batch)
    with torch.inference_mode():
        out = getattr(prog, "eager", prog)(env)   # the CPU's is eager
    return {pub: out[opt]
            for pub, opt in zip(exe.source.output_names, exe.graph.outputs)}


def outputs_equal(a, b) -> bool:
    import torch
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


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
#: B2 shapes beside the int8 path's (M 1 and 256 at MAIN_DENSE_KN), each
#: on a path of plan_q8 or its edge: M 1/16 (GEMV) and 17/33 (tiled) at
#: K 256 N 128, K 16 and 32 (below the s8 mma's depth of 32, and at it)
#: over a full N, deep K split across blocks on both paths, and a ragged
#: shape with odd K and N (element copies, no 16-byte loads).
Q8_CHECK_MORE = [(1, 256, 128), (16, 256, 128), (17, 256, 128),
                 (33, 256, 128), (256, 16, 128), (256, 32, 128),
                 (256, 2048, 128), (1, 2048, 96), (300, 257, 130)]
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

    fa_worst, fa_fail = 0.0, []
    for fn in ("exp", "tanh", "sigmoid"):
        row = fast_act_check(torch, np, fn, rng)
        fa_worst = max(fa_worst, row["f32_max_abs_err"])
        if not row["ok"]:
            fa_fail.append(fn)
        emit(row)
    torch.cuda.synchronize()
    problems = []
    if failures or fa_fail:
        problems.append(f"kernel checks failed: fused_matmul {len(failures)} "
                        f"cases, fast_act {fa_fail}")
    return fm_err, fa_worst, problems


def fast_act_check(torch, np, fn, rng):
    """fast_act against its plain version on the card: the main path's
    largest input size (4097 x 1000 + 3, through -120..120 and unit
    normals x 5), every length 1..37 (scalar head and tail around the
    16-byte vectors), and a view starting one element into its storage
    (``x.view(-1)[1:]``, which the wrapper takes as contiguous); f32
    bit-equal, bf16 equal."""
    from repro_torch.kernels.fast_act import ref as fa_ref
    from repro_torch.kernels.fast_act.ops import fast_act

    dev = torch.device(DEVICE)
    big = torch.tensor(rng.standard_normal(4097 * 1000 + 3) * 5.0,
                       dtype=torch.float32, device=dev)
    big[:241] = torch.linspace(-120.0, 120.0, 241, device=dev)
    cases = [("4097x1000+3", big),
             ("view[1:] of 4097x1000+3", big.view(-1)[1:])]
    cases += [(f"n={n}", big[:n].clone()) for n in range(1, 38)]
    cases += [(f"view[1:] n={n}", big[:n + 1].clone().view(-1)[1:])
              for n in (1, 7, 8, 9, 37)]
    ulps_max, err_max, f32_equal, bf16_equal = 0, 0.0, True, True
    for _, x in cases:
        got = fast_act(x, fn)
        want = fa_ref.FAST[fn](x)
        ulps_max = max(ulps_max, int((got.view(torch.int32).long()
                                      - want.view(torch.int32).long())
                                     .abs().max()))
        err_max = max(err_max, float((got - want).abs().max()))
        f32_equal &= bool(torch.equal(got, want))
        xb = x.to(torch.bfloat16) if x.data_ptr() % 16 == 0 else \
            torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                        device=dev)[1:].copy_(x)
        wantb = fa_ref.FAST[fn](xb.float()).to(torch.bfloat16)
        bf16_equal &= bool(torch.equal(fast_act(xb, fn), wantb))
    torch.cuda.synchronize()
    return {"phase": "check", "kernel": "fast_act", "fn": fn,
            "cases": [c for c, _ in cases[:2]] + ["n=1..37",
                                                  "view[1:] n=1,7,8,9,37"],
            "f32_max_ulps": ulps_max, "f32_bit_equal": f32_equal,
            "f32_max_abs_err": err_max, "bf16_equal": bf16_equal,
            "ok": f32_equal and bf16_equal}


def phase_check_q8(torch, np):
    """fused_matmul_q8 against its plain version at the int8 path's shapes
    and a ragged one, both layouts, every epilogue; then its quantize of
    ``x`` against ``quantize_q8`` on inputs placed exactly on .5 ties."""
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8

    from repro_torch.kernels.fused_matmul import kernel as fm_k

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes += Q8_CHECK_MORE
    worst, failures, cases, equal_cases = 0.0, [], 0, 0
    plans, deterministic, split_equal = {}, True, True
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
            p = fm_k.plan_q8(m, k, n, w_layout=layout)
            plans[f"{m}x{k}x{n} {layout}"] = p.describe()
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
                ok = equal if name in Q8_BIT_EQUAL else err <= Q8_ATOL
                if name == "relu_affine":
                    # The split reduction: bit-equal to its plain int32
                    # emulation, and from one call to the next.
                    split = fm_ref.fused_matmul_q8_split_ref(
                        xq, wq, deq, bias, s, o, splits=p.splits,
                        ksplit=p.ksplit, **kw)
                    same_split = bool(torch.equal(got, split))
                    same = bool(torch.equal(got, fused_matmul_q8(
                        x, wq, deq, bias, s, o, x_scale=xs, **kw)))
                    split_equal &= same_split
                    deterministic &= same
                    ok &= same and same_split
                if not ok:
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
          "bit_equal_to_split_ref": split_equal,
          "deterministic_two_calls": deterministic,
          "inputs": "unit-normal x and W, x scale clipping 20% of |x|max",
          "quantize_ties": tie_rows, "plans": plans,
          "failures": failures[:20]})
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

    # The path, every count set to 0 just before and read just after:
    # each batch size's program prepared (a warm-up and a captured call
    # through the wrappers), then called once under the profiler, which
    # counts the replay's kernels by name.
    reset_counts()
    for name in SUITE:
        for prec in ("exact", "fast"):
            for b in PREPARE:
                exes[name, "cuda", prec].ensure_compiled(b)
    torch.cuda.synchronize()
    prepared = read_counts()
    outs = {}
    expect_total = {k: 0 for k in KERNELS}
    launches = {k: 0 for k in KERNELS}
    per_model = {}
    for name in SUITE:
        for b in BATCHES:
            for prec in ("exact", "fast"):
                exe = exes[name, "cuda", prec]
                out, counts = profiled_call(
                    lambda: exe(input=inputs[name, b]))
                outs[name, b, prec] = out
                n_fm, n_fa = expect[name]
                n_fa = n_fa if prec == "fast" else 0
                expect_total["fused_matmul"] += n_fm
                expect_total["fast_act"] += n_fa
                for k in KERNELS:
                    launches[k] += counts[k]
                per_model[name, b, prec] = dict(
                    counts, expected={"fused_matmul": n_fm, "fast_act": n_fa,
                                      "fused_matmul_q8": 0,
                                      "decode_attention": 0})
    wrappers = read_counts()

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
                          for k in KERNELS))
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
    # The wrappers counted the preparing calls alone: the replays pass
    # through none.
    want_wrappers = {k: PREPARE_CALLS * v for k, v in expect_total.items()}
    emit({"phase": "main", "launches": launches, "expected": expect_total,
          "wrapper_launches": wrappers, "wrapper_launches_preparing":
          prepared, "wrapper_expected": want_wrappers,
          "failures": failures})
    problems = []
    if (failures or launches != expect_total
            or not (expect_total["fused_matmul"] and expect_total["fast_act"])
            or wrappers != prepared or wrappers != want_wrappers):
        problems.append(f"main path failed: {failures}, launches {launches}, "
                        f"expected {expect_total}, wrappers {wrappers}, "
                        f"expected {want_wrappers}")
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
        # Programs captured under deterministic cuDNN.  The path, every
        # count set to 0 just before and read just after: the cuda
        # programs prepared, then each called once under the profiler.
        for prec, models in modes.items():
            for name in models:
                for b in PREPARE:
                    exes[name, "jit", prec].ensure_compiled(b)
        reset_counts()
        for prec, models in modes.items():
            for name in models:
                for b in PREPARE:
                    exes[name, "cuda", prec].ensure_compiled(b)
        torch.cuda.synchronize()
        prepared = read_counts()
        outs, per = {}, {}
        launches = {k: 0 for k in KERNELS}
        for prec, models in modes.items():
            for name in models:
                for b in BATCHES:
                    exe = exes[name, "cuda", prec]
                    outs[name, b, prec], per[name, b, prec] = profiled_call(
                        lambda: exe(input=inputs[name, b]))
                    for k in KERNELS:
                        launches[k] += per[name, b, prec][k]
        wrappers = read_counts()
        want_total = {k: 0 for k in KERNELS}
        rows, failures = [], []
        for prec, models in modes.items():
            for name in models:
                dense = sum(n.op == "dense" for n in SUITE[name]().nodes)
                want_counts = {k: 0 for k in KERNELS}
                want_counts["fused_matmul_q8" if prec == "int8"
                            else "fused_matmul"] = dense
                for k, v in want_counts.items():
                    want_total[k] += v * len(BATCHES)
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
    want_wrappers = {k: PREPARE_CALLS * v for k, v in want_total.items()}
    emit({"phase": "main", "path": "A", "launches": launches,
          "expected": want_total, "wrapper_launches": wrappers,
          "wrapper_launches_preparing": prepared,
          "wrapper_expected": want_wrappers,
          "cudnn_deterministic": True, "failures": failures})
    problems = []
    if (failures or launches != want_total
            or not (launches["fused_matmul"] and launches["fused_matmul_q8"])
            or wrappers != prepared or wrappers != want_wrappers):
        problems.append(f"path A failed: {failures}, launches {launches}, "
                        f"wrappers {wrappers}")
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
    # K and V are written once into each captured program's static inputs
    # (2.15 GB at batch 8), and every call passes those tensors: a call
    # copies only q and the lengths.
    reset_counts()
    cuda_feeds = {}
    for prec in ("exact", "fast"):
        for b in sorted(DECODE_LENGTHS, reverse=True):     # largest first
            bufs = exes["cuda", prec].input_buffers(b)
            for n in ("k", "v"):
                bufs[n].copy_(feeds[b][n])
            cuda_feeds[prec, b] = dict(feeds[b], k=bufs["k"], v=bufs["v"])
    torch.cuda.synchronize()

    # The path: every count set to 0 before the programs were prepared
    # (above, to hand out their static inputs), read just after; each
    # program called once under the profiler.
    outs, per = {}, {}
    launches = {k: 0 for k in KERNELS}
    for b in DECODE_LENGTHS:
        for prec in ("exact", "fast"):
            exe = exes["cuda", prec]
            outs[b, prec], per[b, prec] = profiled_call(
                lambda: exe(**cuda_feeds[prec, b]))
            for k in KERNELS:
                launches[k] += per[b, prec][k]
    wrappers = read_counts()

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
    calls = len(DECODE_LENGTHS) * 2
    want_total = {k: calls * v for k, v in want_counts.items()}
    want_wrappers = {k: PREPARE_CALLS * v for k, v in want_total.items()}
    emit({"phase": "main", "path": "B", "launches": launches,
          "expected": want_total, "wrapper_launches": wrappers,
          "wrapper_expected": want_wrappers, "failures": failures})
    problems = []
    if (failures or launches != want_total
            or not launches["decode_attention"]
            or wrappers != want_wrappers):
        problems.append(f"path B failed: {failures}, launches {launches}, "
                        f"wrappers {wrappers}")
    return exes, feeds, cuda_feeds, launches, problems


def program_cases(torch, np, exes, inputs, dec_exes, cuda_feeds):
    """Every captured program of paths 1, A and B: (label, executable,
    two feeds, the launches one replay must make, cuDNN deterministic
    as when it was captured)."""
    from repro_torch.table1_models import SUITE
    rng = np.random.default_rng(99)
    cases = []
    for name in SUITE:
        n_fm, n_fa = expected_launches(SUITE[name]())
        for b in BATCHES:
            x1 = inputs[name, b]
            x2 = rng.standard_normal(x1.shape).astype(np.float32)
            feeds = ({"input": x1}, {"input": x2})
            for target, prec in (("cuda", "exact"), ("cuda", "fast"),
                                 ("jit", "exact"), ("cuda", "int8"),
                                 ("jit", "int8"), ("cuda", "bf16"),
                                 ("jit", "bf16")):
                exe = exes.get((name, target, prec))
                if exe is None:
                    continue
                want = {k: 0 for k in KERNELS}
                if target == "cuda":
                    want["fused_matmul_q8" if prec == "int8"
                         else "fused_matmul"] = n_fm
                    want["fast_act"] = n_fa if prec == "fast" else 0
                path = "1" if prec in ("exact", "fast") else "A"
                cases.append((f"{path} {name} {target} {prec} b{b}", exe,
                              feeds, want, path == "A"))
    for (prec, b), feeds in cuda_feeds.items():
        gen = torch.Generator(device=DEVICE).manual_seed(77 + b)
        other = dict(feeds, q=torch.randn(feeds["q"].shape, generator=gen,
                                          device=DEVICE),
                     lengths=torch.clamp(feeds["lengths"] - 257, min=1))
        want = {k: int(k == "decode_attention") for k in KERNELS}
        cases.append((f"B decode cuda {prec} b{b}", dec_exes["cuda", prec],
                      (feeds, other), want, False))
    return cases


def phase_program(torch, np, cases):
    """Each captured program against the eager program it was captured
    from: two calls on different inputs, each bit-equal to the eager
    walk on its input, the first call's outputs unchanged after the
    second, one replay's launches from the profiler; capture time and
    pool bytes."""
    failures, pool_total, capture_total = [], 0, 0.0
    prev = torch.backends.cudnn.deterministic
    try:
        for label, exe, (f1, f2), want, deterministic in cases:
            torch.backends.cudnn.deterministic = deterministic
            out1 = exe(**f1)
            keep = {k: v.clone() for k, v in out1.items()}
            out2 = exe(**f2)
            eq1 = outputs_equal(out1, eager_call(exe, f1))
            eq2 = outputs_equal(out2, eager_call(exe, f2))
            fresh = outputs_equal(out1, keep)
            differ = not outputs_equal(out1, out2)
            _, prof = profiled_call(lambda: exe(**f1))
            batch = next(iter(out1.values())).shape[0]
            info = exe.cost_summary()["programs"][batch]
            pool_bytes = exe.ensure_compiled(batch).pool_bytes
            ok = (info["captured"] and eq1 and eq2 and fresh and differ
                  and prof == want)
            if not ok:
                failures.append(label)
            pool_total += pool_bytes
            capture_total += info.get("capture_ms", 0.0)
            emit({"phase": "program", "program": label,
                  "bit_equal_to_eager": [eq1, eq2],
                  "first_outputs_unchanged": fresh,
                  "inputs_differ_outputs_differ": differ,
                  "replay_launches_profiler": prof, "expected": want,
                  "capture_ms": info.get("capture_ms"),
                  "pool_bytes_added": pool_bytes,
                  "cudnn_deterministic": deterministic, "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
    emit({"phase": "program", "programs": len(cases),
          "pool_bytes_added_total": pool_total,
          "capture_ms_total": capture_total,
          "failures": failures})
    return [f"program phase failed: {failures}"] if failures else []


def phase_split_counters(torch, np):
    """B1 and B2 reduce K splits through per-tile counters.  A program
    captured with a small plan must replay bit-equal after a program
    with a larger plan was captured, after its own counter buffer grew
    (the outgrown buffer stays held), and after the freed memory of the
    card was handed out and scribbled over."""
    import repro_torch

    def one_dense(k, n, seed):
        mb = repro_torch.ModelBuilder().seed(seed)
        x = mb.input((k,))
        return mb.build([mb.dense(x, n, activation="relu")])

    rows = []
    for prec in ("exact", "int8"):
        small = repro_torch.compile(one_dense(2048, 96, 1), target="cuda",
                                    precision=prec, device=DEVICE)
        large = repro_torch.compile(one_dense(2048, 128, 2), target="cuda",
                                    precision=prec, device=DEVICE)
        x = np.random.default_rng(3).standard_normal((1, 2048)).astype(
            np.float32)
        xl = np.random.default_rng(4).standard_normal((256, 2048)).astype(
            np.float32)
        prog = small.ensure_compiled(1)
        first = small(input=x)
        large.ensure_compiled(256)
        large(input=xl)
        grown = getattr(prog, "eager", prog).ctx.counters.get(
            torch.device(DEVICE), 1 << 16)
        scribble = torch.full((1 << 28,), -1, dtype=torch.int32, device=DEVICE)
        again = small(input=x)
        eager = eager_call(small, {"input": x})
        del scribble
        sel = [c["reason"] for c in
               small.cost_summary()["kernel_selection"][1] +
               large.cost_summary()["kernel_selection"][256]]
        ok = (outputs_equal(first, again) and outputs_equal(first, eager)
              and grown.numel() == 1 << 16)
        rows.append(ok)
        emit({"phase": "split_counters", "precision": prec,
              "plans": sel, "replay_bit_equal_after": ok,
              "grown_to": grown.numel(), "ok": ok})
    return [] if all(rows) else ["split counter check failed"]


def phase_runtime(torch, np, exes, inputs):
    """Batch buckets on the card: a BucketPolicy (engine cache, a cold
    bucket captured in the background while a warm one serves) and the
    legacy batch_buckets; every output bit-equal to its bucket's program
    on the input padded with zero rows, and within EXACT_ATOL of
    interpret."""
    import repro_torch
    from repro_torch.runtime import BucketPolicy
    from repro_torch.table1_models import SUITE

    rng = np.random.default_rng(7)
    failures = []
    policy = BucketPolicy(batch_buckets=RUNTIME_POLICY)
    for name in RUNTIME_MODELS:
        g = SUITE[name]()
        shape = tuple(g.inputs["input"].shape)
        interp = exes[name, "interpret", "exact"]
        bucketed = repro_torch.compile(g, target="cuda", device=DEVICE,
                                       buckets=policy)
        bucketed.warm_up(block=True)
        legacy = repro_torch.compile(g, target="cuda", device=DEVICE,
                                     batch_buckets=LEGACY_BUCKETS)
        for kind, exe, inner, buckets in (
                ("buckets", bucketed, bucketed.inner, RUNTIME_POLICY),
                ("batch_buckets", legacy, legacy, LEGACY_BUCKETS)):
            for batch in RUNTIME_BATCHES:
                x = rng.standard_normal((batch,) + shape).astype(np.float32)
                got = exe(input=x)
                bucket = next((b for b in buckets if b >= batch), batch)
                padded = np.zeros((bucket,) + shape, np.float32)
                padded[:batch] = x
                want = inner(input=padded)
                equal = outputs_equal(got, {k: v[:batch]
                                            for k, v in want.items()})
                ref = interp(input=x)
                err = max(float((got[k] - ref[k]).abs().max()) for k in ref)
                ok = equal and err <= EXACT_ATOL
                if not ok:
                    failures.append([name, kind, batch])
                emit({"phase": "runtime", "model": name, "kind": kind,
                      "batch": batch, "bucket": bucket,
                      "bit_equal_to_padded_bucket_program": equal,
                      "max_abs_err_vs_interpret": err, "ok": ok})
        emit({"phase": "runtime", "model": name, "kind": "buckets",
              "counters": bucketed.runtime_stats()})
        bucketed.shutdown()

    # worker="thread": only the largest bucket warm; calls of batch 3 are
    # served on it while their own bucket is captured in the background.
    g = SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="cuda", device=DEVICE,
                              buckets=policy)
    exe.ensure_compiled(RUNTIME_POLICY[-1])
    cold = str(policy.bucket_for(3))
    x = rng.standard_normal((3,) + tuple(g.inputs["input"].shape)).astype(
        np.float32)
    ref = exes["C-HTWK", "interpret", "exact"](input=x)
    # No synchronise while the capture is under way: a device-wide one is
    # refused then, and the outputs are read after it (core/program.py).
    served = []
    t0 = time.perf_counter()
    while cold not in exe.runtime_stats()["warm_buckets"] \
            and len(served) < 2000:
        served.append(exe(input=x))
        time.sleep(0.001)
    warm = exe.wait_warm(timeout=120.0)
    served.append(exe(input=x))
    errs = [max(float((got[k] - ref[k]).abs().max()) for k in ref)
            for got in served]
    stats = exe.runtime_stats()
    ok = (warm and stats["fallback_serves"] >= 1 and stats["bucket_hits"] >= 1
          and stats["compile_stalls"] == 0 and max(errs) <= EXACT_ATOL)
    if not ok:
        failures.append(["thread worker", stats])
    emit({"phase": "runtime", "model": "C-HTWK", "kind": "thread worker",
          "calls_served_while_capturing": len(served) - 1,
          "seconds_to_warm": time.perf_counter() - t0,
          "max_abs_err_vs_interpret": max(errs), "counters": stats,
          "ok": ok})
    exe.shutdown()
    return [f"runtime phase failed: {failures}"] if failures else []


CACHE_SCRIPT = """
import json, sys
sys.path.insert(0, {src!r})
import numpy as np, torch
import repro_torch
from repro_torch.api import targets
from repro_torch.table1_models import SUITE
torch.backends.cudnn.deterministic = True
ran = []
real = targets.run_pipeline
def counted(*a, **kw):
    ran.append(1)
    return real(*a, **kw)
targets.run_pipeline = counted
data = np.load({inputs!r})
report, outs = {{}}, {{}}
for name, prec in {compiles!r}:
    exe = repro_torch.compile(SUITE[name](), target="cuda", precision=prec,
                              device={device!r}, cache_dir={cache!r})
    for b in {batches!r}:
        out = exe(input=data[f"{{name}} {{b}}"])
        for k, v in out.items():
            outs[f"{{name}} {{prec}} {{b}} {{k}}"] = v.cpu().numpy()
    report[f"{{name}} {{prec}}"] = exe.cache_info()
np.savez({outputs!r}, **outs)
print(json.dumps({{"pipelines": len(ran), "cache": report}}))
"""


def phase_cache(torch, np, exes, inputs):
    """serialize/deserialize on the card, and a second process with the
    first one's cache directory (cuDNN deterministic in both)."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    failures = []
    work = os.path.join(ROOT, "build", "chip_smoke_cache")
    shutil.rmtree(work, ignore_errors=True)
    cache_dir = os.path.join(work, "entries")
    os.makedirs(cache_dir)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs, feeds = {}, {}
        for name, prec in CACHE_COMPILES:
            exe = repro_torch.compile(SUITE[name](), target="cuda",
                                      precision=prec, device=DEVICE,
                                      cache_dir=cache_dir)
            again = repro_torch.deserialize(exe.serialize())
            for b in BATCHES:
                x = inputs[name, b]
                feeds[f"{name} {b}"] = x
                out = exe(input=x)
                equal = outputs_equal(out, again(input=x))
                for k, v in out.items():
                    outs[f"{name} {prec} {b} {k}"] = v.cpu().numpy()
                if not equal:
                    failures.append(["deserialize", name, prec, b])
                emit({"phase": "cache", "model": name, "precision": prec,
                      "batch": b, "deserialized_bit_equal": equal})
            if exe.cache_info()["programs"] != {b: "miss" for b in BATCHES}:
                failures.append(["first process", exe.cache_info()])
        in_path = os.path.join(work, "inputs.npz")
        out_path = os.path.join(work, "second.npz")
        np.savez(in_path, **feeds)
        script = CACHE_SCRIPT.format(
            src=os.path.join(ROOT, "src"), inputs=in_path, outputs=out_path,
            compiles=list(CACHE_COMPILES), cache=cache_dir,
            batches=list(BATCHES), device=DEVICE)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"second process failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        second = np.load(out_path)
        equal = (sorted(second.files) == sorted(outs)
                 and all(np.array_equal(second[k], outs[k]) for k in outs))
        hits = all(info["graph"] == "hit"
                   and info["programs"] == {str(b): "hit" for b in BATCHES}
                   for info in report["cache"].values())
        ok = equal and hits and report["pipelines"] == 0
        if not ok:
            failures.append(["second process", report])
        emit({"phase": "cache", "second_process": report,
              "outputs_bit_equal_to_first": equal, "seconds": seconds,
              "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    return [f"cache phase failed: {failures}"] if failures else []


# ---------------------------------------------------------------------------
# Slice 6: the executable's one graph pool, the autotuner, mixed precision
# ---------------------------------------------------------------------------
#: The pool phase: VGG19 exact at 8 batch sizes between 129 and 256,
#: arriving in three orders (the largest first, ascending, shuffled);
#: the bound's slack.
POOL_BATCHES = (256, 129, 200, 150, 241, 176, 137, 222)
POOL_ORDERS = (("largest first", POOL_BATCHES),
               ("ascending", tuple(sorted(POOL_BATCHES))),
               ("shuffled", (150, 222, 129, 256, 176, 137, 241, 200)))
POOL_SLACK = 0.10
#: What the 76 programs of paths 1, A and B took when each held a private
#: pool (PERF.md §6, the captured programs' first measurement).
PRIVATE_POOLS_BYTES = 6.98e9


def _reserved(torch) -> int:
    """memory_reserved with the allocator's free cache returned."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase_pool(torch, np, all_exes):
    """One graph pool per executable: VGG19 exact at POOL_BATCHES, no
    buckets, the batches arriving in each of POOL_ORDERS.  In every
    order the growth of memory_reserved over the 8 calls stays within
    the batch-256 program's pool plus the 8 programs' static inputs and
    outputs, plus POOL_SLACK (a batch larger than every captured one
    lays the pool out again, largest first); beside it the sum 8 private
    pools take (each program captured again alone, as before the pool
    was shared).  Then replays in reverse and in shuffled order, each
    bit-equal to its eager walk and to the program's first answer,
    which calls to the others and the pool's relayouts left unchanged.
    Last, the pool bytes of every executable of paths 1, A and B."""
    import random
    import repro_torch
    from repro_torch.core.program import CapturedProgram
    from repro_torch.table1_models import SUITE

    g = SUITE["VGG19"]()
    rng = np.random.default_rng(5)
    feeds = {b: rng.standard_normal((b,) + tuple(g.inputs["input"].shape))
             .astype(np.float32) for b in POOL_BATCHES}
    failures, private = [], None
    for order, batches in POOL_ORDERS:
        exe = repro_torch.compile(g, target="cuda", device=DEVICE)
        before = _reserved(torch)
        t0 = time.perf_counter()
        first = {b: exe(input=feeds[b]) for b in batches}
        torch.cuda.synchronize()
        calls_s = time.perf_counter() - t0
        growth = _reserved(torch) - before
        progs = {b: exe.ensure_compiled(b) for b in batches}
        statics = sum(t.numel() * t.element_size() for p in progs.values()
                      for t in list(p.static_inputs.values())
                      + list(p.static_outputs.values()))
        pool = exe.cost_summary()["graph_pool_bytes"]
        bound = (progs[256].pool_bytes + statics) * (1 + POOL_SLACK)
        if private is None:
            # What private pools take: each program captured again
            # alone, from its own eager walk.
            private = 0
            specs = {n: (tuple(s.shape), torch.float32)
                     for n, s in exe.graph.inputs.items()}
            for b in batches:
                alone = CapturedProgram(progs[b].eager, specs,
                                        torch.device(DEVICE))
                private += alone.pool_bytes
                alone.release()
                del alone
            _reserved(torch)
        replays_ok = True
        shuffled = list(batches)
        random.Random(7).shuffle(shuffled)
        for b in list(reversed(batches)) + shuffled:
            out = exe(input=feeds[b])
            replays_ok &= outputs_equal(out, eager_call(
                exe, {"input": feeds[b]}))
            replays_ok &= outputs_equal(out, first[b])
        ok = replays_ok and growth <= bound
        if not ok:
            failures.append([order, growth, bound, replays_ok])
        emit({"phase": "pool", "model": "VGG19", "precision": "exact",
              "order_name": order, "order": list(batches),
              "reserved_growth_bytes": growth, "graph_pool_bytes": pool,
              "batch256_pool_bytes": progs[256].pool_bytes,
              "static_in_out_bytes": statics, "bound_bytes": bound,
              "private_pools_bytes": private, "calls_s": calls_s,
              "replays_bit_equal_any_order": replays_ok, "ok": ok})
        del exe, progs, first
        _reserved(torch)
    seen, total, programs = set(), 0, 0
    for exe in all_exes:
        if id(exe) in seen or not hasattr(exe, "_programs"):
            continue
        seen.add(id(exe))
        total += exe.cost_summary().get("graph_pool_bytes", 0)
        programs += sum(isinstance(p, CapturedProgram)
                        for p in exe._programs.values())
    emit({"phase": "pool", "paths": "1, A, B",
          "captured_programs": programs, "graph_pool_bytes_total": total,
          "private_pools_bytes_before": PRIVATE_POOLS_BYTES})
    return [f"pool phase failed: {failures}"] if failures else []


#: The autotune phase: models and precisions tuned with autotune="full"
#: at BATCHES, path B's decode node at batch 8, and the budget of each
#: compile (measurement ends well inside the script's time limit).
TUNE_COMPILES = (("C-HTWK", "exact"), ("C-HTWK", "int8"),
                 ("VGG19", "exact"), ("VGG19", "int8"))
TUNE_BUDGET_MS = 60_000.0
TUNE_DECODE_BATCH = 8

TUNE_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import numpy as np, torch
import chip_smoke as cs
import repro_torch
from repro_torch.table1_models import SUITE
torch.backends.cudnn.deterministic = True
data = np.load({inputs!r})
report, outs = {{}}, {{}}
for name, prec in {compiles!r}:
    exe = repro_torch.compile(SUITE[name](), target="cuda", precision=prec,
                              device={device!r}, autotune="cached",
                              cache_dir={cache!r})
    for b in {batches!r}:
        out = exe(input=data[f"{{name}} {{b}}"])
        for k, v in out.items():
            outs[f"{{name}} {{prec}} {{b}} {{k}}"] = v.cpu().numpy()
        report[f"{{name}} {{prec}} {{b}}"] = (
            exe.cost_summary()["autotune"][b]["measured_nodes"])
    report[f"{{name}} {{prec}} decisions"] = [
        r["source"] for r in exe.cost_summary()["graph_decisions"]["sites"]
        if r["source"] == "measured"]
cs.DEVICE = {device!r}
cs.DECODE = {decode!r}
cs.DECODE_LENGTHS = {lengths!r}
exe = repro_torch.compile(cs.decode_graph(repro_torch), target="cuda",
                          device={device!r}, autotune="cached",
                          cache_dir={cache!r})
b = {dbatch!r}
q, k, v, lens = cs.decode_inputs(torch, b, cs.DECODE["h"], cs.DECODE["hkv"],
                                 cs.DECODE["d"], cs.DECODE["s"],
                                 cs.DECODE_LENGTHS[b], 40)
out = exe(q=q, k=k, v=v, lengths=lens)
for key, val in out.items():
    outs[f"decode {{b}} {{key}}"] = val.cpu().numpy()
report[f"decode {{b}}"] = exe.cost_summary()["autotune"][b]["measured_nodes"]
np.savez({outputs!r}, **outs)
print(json.dumps(report))
"""


def grid_checks(torch, np):
    """Every grid point of the tuned kernels against its plain version at
    the main path's shapes, under the check phase's bounds: B1 (f32 and
    bf16, both layouts, no epilogue and relu + affine) within MATMUL_ATOL
    (x sqrt(K/256) above K=256); B2 (both layouts) bit-equal for
    none/relu/leaky_relu/affine; B4 (path B at batch 1 and 8, exact and
    fast) within DECODE_ATOL of its tiled form."""
    from repro_torch.kernels import qmath
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8
    from repro_torch.autotune.tactics import enumerate_tactics

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(13)
    rows, failures = {}, []
    epis = [e for e in EPILOGUES if e[0] in Q8_BIT_EQUAL]
    for k, n in MAIN_DENSE_KN:
        for m in BATCHES:
            atol = MATMUL_ATOL * max(1.0, (k / 256) ** 0.5)
            x_np = rng.standard_normal((m, k)).astype(np.float32)
            w_np = rng.standard_normal((k, n)).astype(np.float32)
            x = torch.from_numpy(x_np).to(dev)
            vec = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
            bias, scale = vec(rng.standard_normal(n)), vec(rng.uniform(0.5, 1.5, n))
            offset = vec(rng.standard_normal(n))
            xs = qmath.tensor_scale(float(np.abs(x_np).max()) * 0.8)
            xq = qmath.quantize_q8(x, xs)
            for layout in ("io", "oi"):
                w = torch.from_numpy(w_np if layout == "io" else
                                     np.ascontiguousarray(w_np.T)).to(dev)
                shape = dict(m=m, k=k, n=n, w_layout=layout)
                for dtype in (torch.float32, torch.bfloat16):
                    xd, wd = x.to(dtype), w.to(dtype)
                    grid = enumerate_tactics("cuda.fused_matmul",
                                             itemsize=xd.element_size(),
                                             **shape)
                    for block, p in grid:
                        for name, fn, fast, attrs, affine in EPILOGUES[:2] + EPILOGUES[-1:]:
                            s, o = (scale, offset) if affine else (None, None)
                            got = fused_matmul(xd, wd, bias, s, o, fn=fn,
                                               w_layout=layout, plan=p)
                            want = fm_ref.fused_matmul_ref(
                                xd.float(), wd.float(), bias, s, o, fn=fn,
                                w_layout=layout)
                            err = float((got - want).abs().max())
                            key = "fused_matmul"
                            rows.setdefault(key, [0, 0.0])
                            rows[key][0] += 1
                            rows[key][1] = max(rows[key][1], err)
                            if err > atol:
                                failures.append([key, m, k, n, layout,
                                                 str(dtype), block, name, err])
                wq, deq = qmath.quantize_weight(
                    w, xs, qmath.channel_scales(w_np, 1), layout)
                for block, p in enumerate_tactics("cuda.fused_matmul_q8",
                                                  **shape):
                    for name, fn, fast, attrs, affine in epis:
                        s, o = (scale, offset) if affine else (None, None)
                        kw = dict(fn=fn, fast=fast, w_layout=layout,
                                  attrs=attrs)
                        got = fused_matmul_q8(x, wq, deq, bias, s, o,
                                              x_scale=xs, plan=p, **kw)
                        want = fm_ref.fused_matmul_q8_ref(xq, wq, deq, bias,
                                                          s, o, **kw)
                        equal = bool(torch.equal(got, want))
                        key = "fused_matmul_q8"
                        rows.setdefault(key, [0, 0.0])
                        rows[key][0] += 1
                        rows[key][1] = max(rows[key][1],
                                           float((got - want).abs().max()))
                        if not equal:
                            failures.append([key, m, k, n, layout, block,
                                             name])
    for b in (1, TUNE_DECODE_BATCH):
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"],
                                      DECODE_LENGTHS[b], 50 + b)
        for fast in (False, True):
            want = attn_ref.decode_attention_tiled(q, k, v, lens, fast=fast)
            for block, (tpc, chunks) in enumerate_tactics(
                    "cuda.decode_attention", b=b, hkv=DECODE["hkv"],
                    s=DECODE["s"]):
                got = decode_attention(q, k, v, lens, fast=fast,
                                       tiles_per_chunk=tpc)
                err = float((got - want).abs().max())
                rows.setdefault("decode_attention", [0, 0.0])
                rows["decode_attention"][0] += 1
                rows["decode_attention"][1] = max(
                    rows["decode_attention"][1], err)
                if err > DECODE_ATOL:
                    failures.append(["decode_attention", b, fast, block, err])
        del q, k, v
    torch.cuda.synchronize()
    emit({"phase": "autotune", "grid_checks": {
        k: {"cases": c, "max_abs_err": e} for k, (c, e) in rows.items()},
        "bounds": {"fused_matmul": "MATMUL_ATOL * sqrt(K / 256) for K > 256",
                   "fused_matmul_q8": f"bit-equal for {list(Q8_BIT_EQUAL)}",
                   "decode_attention": DECODE_ATOL},
        "failures": failures[:20]})
    return failures


def _tune_rows(exe, batch):
    """Each tuned node's candidates (device µs) and winner, and each graph
    decision site's."""
    sel = exe.cost_summary()["kernel_selection"][batch]
    nodes = [{"node": c["node"], "kernel": c["kernel"], "source": c["source"],
              "winner": c["tactic"] or "heuristic", "block": c["block"],
              "measured_us": c["measured_us"]}
             for c in sel]
    return nodes


def phase_autotune(torch, np, exes, inputs):
    """autotune="full" on the card: the grid checks, then C-HTWK and VGG19
    at exact and int8 (batch 1 and 256) and path B's decode node (batch
    8), each tuned program held against interpret within its path's
    bound and bit-equal to its eager walk; tuned against heuristic time;
    then a second process with autotune="cached" on the same cache
    directory measures nothing and matches bit for bit."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    problems = []
    if grid_checks(torch, np):
        problems.append("autotune grid checks failed")
    work = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(work, ignore_errors=True)
    cache_dir = os.path.join(work, "entries")
    os.makedirs(cache_dir)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures, outs, feeds = [], {}, {}
    try:
        t_all = time.perf_counter()
        for name, prec in TUNE_COMPILES:
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                SUITE[name](), target="cuda", precision=prec, device=DEVICE,
                autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=cache_dir, calibrate=4 if prec == "int8" else None)
            for b in PREPARE:
                exe.ensure_compiled(b)
            tune_s = time.perf_counter() - t0
            heur = exes[name, "cuda", prec]
            decisions = exe.cost_summary()["graph_decisions"]
            for b in BATCHES:
                x = inputs[name, b]
                feeds[f"{name} {b}"] = x
                got = exe(input=x)
                for k, v in got.items():
                    outs[f"{name} {prec} {b} {k}"] = v.cpu().numpy()
                eager_equal = outputs_equal(got, eager_call(exe, {"input": x}))
                ref = exes[name, "interpret", "exact"](input=x)
                per_example = torch.stack([
                    (got[k] - ref[k]).abs().flatten(1).amax(1)
                    for k in ref]).amax(0)
                err = float(per_example.max())
                ref_mag = max(float(ref[k].abs().max()) for k in ref)
                if prec == "exact":
                    bound = EXACT_ATOL
                    within = err <= bound
                else:
                    bound = QUANT_BUDGET * max(1.0, ref_mag)
                    within = float(per_example.median()) <= bound
                finite = all(bool(torch.isfinite(v).all())
                             for v in got.values())
                xt = torch.as_tensor(x, device=DEVICE)
                times = {}
                for tag, e in (("tuned", exe), ("heuristic", heur)):
                    times[f"{tag}_ms"] = host_median_ms(lambda: e(input=xt))
                    times[f"{tag}_device_ms"] = device_ms(lambda: e(input=xt))
                rep = exe.cost_summary()["autotune"][b]
                ok = eager_equal and within and finite
                if not ok:
                    failures.append([name, prec, b, err, eager_equal])
                emit({"phase": "autotune", "model": name, "precision": prec,
                      "batch": b, "nodes": _tune_rows(exe, b),
                      "measured_nodes": rep["measured_nodes"],
                      "cached_nodes": rep["cached_nodes"],
                      "spent_ms": rep["spent_ms"],
                      "max_abs_err_vs_interpret_exact": err,
                      "median_example_err": float(per_example.median()),
                      "bound": bound, "bit_equal_to_eager": eager_equal,
                      "finite": finite, **times, "ok": ok})
            emit({"phase": "autotune", "model": name, "precision": prec,
                  "graph_decisions": [
                      {k: r.get(k) for k in ("kind", "node", "winner",
                                             "source", "measured_us")}
                      for r in decisions["sites"]],
                  "pipeline": decisions["pipeline"],
                  "decisions_spent_ms": decisions["spent_ms"],
                  "tuning_s": tune_s})
        # Path B's decode node at batch 8.
        b = TUNE_DECODE_BATCH
        t0 = time.perf_counter()
        dexe = repro_torch.compile(
            decode_graph(repro_torch), target="cuda", device=DEVICE,
            autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
            cache_dir=cache_dir)
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"],
                                      DECODE_LENGTHS[b], 40)
        bufs = dexe.input_buffers(b)
        bufs["k"].copy_(k)
        bufs["v"].copy_(v)
        tune_s = time.perf_counter() - t0
        dfeeds = {"q": q, "k": bufs["k"], "v": bufs["v"], "lengths": lens}
        got = dexe(**dfeeds)
        for key, val in got.items():
            outs[f"decode {b} {key}"] = val.cpu().numpy()
        eager_equal = outputs_equal(got, eager_call(dexe, dfeeds))
        iexe = repro_torch.compile(decode_graph(repro_torch),
                                   target="interpret", device=DEVICE)
        want = iexe(q=q, k=k, v=v, lengths=lens)
        err = max(float((got[x] - want[x]).abs().max()) for x in want)
        del k, v
        heur = repro_torch.compile(decode_graph(repro_torch), target="cuda",
                                   device=DEVICE)
        hb = heur.input_buffers(b)
        hb["k"].copy_(bufs["k"])
        hb["v"].copy_(bufs["v"])
        hfeeds = dict(dfeeds, k=hb["k"], v=hb["v"])
        times = {"tuned_ms": host_median_ms(lambda: dexe(**dfeeds)),
                 "tuned_device_ms": device_ms(lambda: dexe(**dfeeds)),
                 "heuristic_ms": host_median_ms(lambda: heur(**hfeeds)),
                 "heuristic_device_ms": device_ms(lambda: heur(**hfeeds))}
        del heur, hb, hfeeds
        ok = eager_equal and err <= DECODE_ATOL
        if not ok:
            failures.append(["decode", b, err, eager_equal])
        emit({"phase": "autotune", "model": "decode qwen2.5-14b",
              "batch": b, "nodes": _tune_rows(dexe, b),
              "measured_nodes": dexe.cost_summary()["autotune"][b]
              ["measured_nodes"], "max_abs_err_vs_interpret_exact": err,
              "bound": DECODE_ATOL, "bit_equal_to_eager": eager_equal,
              "tuning_s": tune_s, **times, "ok": ok})
        del dexe, bufs, dfeeds, iexe
        tuning_total_s = time.perf_counter() - t_all

        # The second process: autotune="cached" on the same directory.
        in_path = os.path.join(work, "inputs.npz")
        out_path = os.path.join(work, "second.npz")
        np.savez(in_path, **feeds)
        script = TUNE_SCRIPT.format(
            root=ROOT, src=os.path.join(ROOT, "src"), inputs=in_path,
            outputs=out_path, compiles=list(TUNE_COMPILES), cache=cache_dir,
            batches=list(BATCHES), dbatch=b, device=DEVICE, decode=DECODE,
            lengths=DECODE_LENGTHS)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"cached process failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        second = np.load(out_path)
        equal = (sorted(second.files) == sorted(outs)
                 and all(np.array_equal(second[x], outs[x]) for x in outs))
        measured_nothing = not any(report.values())
        ok = equal and measured_nothing
        if not ok:
            failures.append(["cached process", report, equal])
        emit({"phase": "autotune", "second_process": "autotune=cached",
              "measured": report, "outputs_bit_equal_to_first": equal,
              "seconds": seconds, "tuning_total_s": tuning_total_s,
              "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        problems.append(f"autotune phase failed: {failures}")
    return problems


MIXED_MODELS = INT8_MODELS


def phase_mixed(torch, np, exes, inputs):
    """precision="mixed" on the card (C-HTWK, C-BH, VGG19; batch 1 and
    256): each site's measured candidates, errors and winner, every
    winner within its budget, the median example within QUANT_BUDGET x
    max(1, max |out|) of interpret exact.  Then two seeded caches: every
    dense site int8 (conv sites f32) must give the int8 program bit for
    bit, every site f32 (precision_budget=1e-9, measured) the f32
    program."""
    import shutil
    import repro_torch
    from repro_torch.autotune.cache import (TacticCache,
                                            environment_fingerprint,
                                            tactic_key)
    from repro_torch.core.passes import run_pipeline
    from repro_torch.table1_models import SUITE
    quantize = sys.modules["repro_torch.core.passes.quantize"]

    work = os.path.join(ROOT, "build", "chip_smoke_mixed")
    shutil.rmtree(work, ignore_errors=True)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures = []
    try:
        for name in MIXED_MODELS:
            g = SUITE[name]()
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                cache_dir=os.path.join(work, "measured"),
                autotune_budget_ms=TUNE_BUDGET_MS)
            mixed_s = time.perf_counter() - t0
            stats = next(p for p in exe.report["passes"]
                         if p["pass"] == "quantize")["mixed"]
            budget = stats["budget"]
            within = all(s["max_abs_err"].get(s["winner"], 0.0) <= budget
                         for s in stats["sites"].values())
            for b in BATCHES:
                x = inputs[name, b]
                got = exe(input=x)
                ref = exes[name, "interpret", "exact"](input=x)
                per_example = torch.stack([
                    (got[k] - ref[k]).abs().flatten(1).amax(1)
                    for k in ref]).amax(0)
                ref_mag = max(float(ref[k].abs().max()) for k in ref)
                bound = QUANT_BUDGET * max(1.0, ref_mag)
                median = float(per_example.median())
                eager_equal = outputs_equal(got, eager_call(exe, {"input": x}))
                ok = within and median <= bound and eager_equal
                if not ok:
                    failures.append([name, b, median, within, eager_equal])
                emit({"phase": "mixed", "model": name, "batch": b,
                      "sites": stats["sites"], "decisions":
                      exe.graph.quant["decisions"], "budget": budget,
                      "sites_within_budget": within,
                      "median_example_err_vs_interpret_exact": median,
                      "max_abs_err_vs_interpret_exact":
                      float(per_example.max()), "bound": bound,
                      "bit_equal_to_eager": eager_equal,
                      "measure_ms": stats["spent_ms"], "compile_s": mixed_s,
                      "ok": ok})
            # Seeded: every dense site int8 -> the int8 program.
            pre, _ = run_pipeline(g, PRE_QUANTIZE)
            seeded = os.path.join(work, f"seeded {name}")
            fp = environment_fingerprint(DEVICE)
            tc = TacticCache(os.path.join(seeded, "tactics"))
            for node in pre.nodes:
                if node.op in quantize.QUANT_OPS and "kernel" in node.params:
                    desc = quantize.site_desc(
                        node, pre, quantize.DEFAULT_PRECISION_BUDGET,
                        "absmax", DEVICE)
                    tc.store(tactic_key(desc, fp), {
                        "winner": "int8" if node.op == "dense" else "f32",
                        "fingerprint": fp})
            all_int8 = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                autotune="cached", cache_dir=seeded)
            all_f32 = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                precision_budget=1e-9, autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=os.path.join(work, "tight"))
            f32 = repro_torch.compile(g, target="cuda", precision="f32",
                                      device=DEVICE)
            int8 = exes.get((name, "cuda", "int8"))
            checks = {}
            for b in BATCHES:
                x = inputs[name, b]
                checks[f"all_int8_bit_equal_int8 b{b}"] = outputs_equal(
                    all_int8(input=x), int8(input=x))
                checks[f"all_f32_bit_equal_f32 b{b}"] = outputs_equal(
                    all_f32(input=x), f32(input=x))
            checks["all_int8_decisions"] = all_int8.graph.quant["decisions"]
            checks["all_f32_decisions"] = all_f32.graph.quant["decisions"]
            ok = (all(v for k, v in checks.items() if "bit_equal" in k)
                  and all_f32.graph.quant["decisions"]["f32"]
                  == sum(all_f32.graph.quant["decisions"].values()))
            if not ok:
                failures.append([name, "seeded", checks])
            emit({"phase": "mixed", "model": name, "seeded": checks,
                  "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    return [f"mixed phase failed: {failures}"] if failures else []


# ---------------------------------------------------------------------------
# Slice 7: the frontends, capture bundles and python -m repro_torch.replay
# ---------------------------------------------------------------------------
#: The Table-1 models the frontends and replay phases drive (the two with
#: dense nodes at both ends of the suite's size).
FRONTEND_MODELS = ("C-HTWK", "VGG19")
#: The replay phase's bundles: (model, precision), autotune="full".
REPLAY_BUNDLES = (("VGG19", "exact"), ("C-HTWK", "int8"))
REPLAY_TIMEOUT_S = 300


def twin_htwk(p):
    """C-HTWK (``table1_models.htwk_classifier``) written as a plain
    function over ``repro_torch.frontends.ops``, on the builder graph's
    own weight arrays ``p``."""
    from repro_torch.frontends import ops as F

    def htwk(input):
        h = F.conv2d(input, p["conv2d_1/kernel"], p["conv2d_1/bias"],
                     strides=(2, 2), activation="relu")
        h = F.batchnorm(h, p["bn_3/gamma"], p["bn_3/beta"], p["bn_3/mean"],
                        p["bn_3/var"])
        h = F.conv2d(h, p["conv2d_4/kernel"], p["conv2d_4/bias"],
                     strides=(2, 2), activation="relu")
        h = F.dense(F.flatten(h), p["dense_7/kernel"], p["dense_7/bias"],
                    activation="relu")
        return F.softmax(F.dense(h, p["dense_9/kernel"], p["dense_9/bias"]))

    return htwk


def twin_vgg19(p):
    """VGG19 (``table1_models.vgg19_style``) as a plain function over
    ``repro_torch.frontends.ops``, on the builder graph's weights ``p``:
    five blocks of 3x3 convolutions and a max pool, three dense layers,
    a softmax."""
    from repro_torch.frontends import ops as F
    layers = lambda kind: sorted({k.split("/")[0] for k in p
                                  if k.startswith(kind + "_")},
                                 key=lambda n: int(n.split("_")[1]))
    convs, dense = layers("conv2d"), layers("dense")

    def vgg19(input):
        h, conv = input, iter(convs)
        for n_convs in (2, 2, 4, 4, 4):
            for _ in range(n_convs):
                c = next(conv)
                h = F.conv2d(h, p[f"{c}/kernel"], p[f"{c}/bias"],
                             activation="relu")
            h = F.maxpool(h)
        h = F.flatten(h)
        for d in dense[:-1]:
            h = F.dense(h, p[f"{d}/kernel"], p[f"{d}/bias"],
                        activation="relu")
        last = dense[-1]
        return F.softmax(F.dense(h, p[f"{last}/kernel"], p[f"{last}/bias"]))

    return vgg19


TWINS = {"C-HTWK": twin_htwk, "VGG19": twin_vgg19}


def phase_frontends(torch, np, exes, inputs, dec_exes, cuda_feeds):
    """The frontends on the card, at full widths.  C-HTWK and VGG19
    written as functions over ``repro_torch.frontends.ops`` and traced
    (their node and output names differ from the builder graphs', their
    weights are the same arrays), compiled at exact and fast (batch 1 and
    256) and C-HTWK at int8 (batch 256); ``ops.decode_attention`` at path
    B's widths (batch 1); and C-HTWK and VGG19 compiled from an ``.npz``
    path, from a ModelBuilder without ``.build()`` and from a bare
    callable with ``example_inputs=`` on the card (exact, batch 1 and
    256).  Each output bit-equal to the main path's program on the same
    feeds, and each replay's launches (the profiler's, by kernel name)
    equal to that program's.  Every count is set to 0 before these
    programs are prepared and read after their calls."""
    import repro_torch
    from repro_torch.core import TensorSpec
    from repro_torch.frontends import ops as F
    from repro_torch.frontends.container import save_model
    from repro_torch.table1_models import SUITE

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "frontends")
    os.makedirs(out_dir, exist_ok=True)
    cases = []   # (label, exe, main-path exe, batches, deterministic cuDNN)
    for name in FRONTEND_MODELS:
        g = SUITE[name]()
        shape = tuple(g.inputs["input"].shape)
        traced = repro_torch.trace(TWINS[name](g.params), shape)
        for prec in ("exact", "fast"):
            cases.append((f"traced {name} {prec}", repro_torch.compile(
                traced, target="cuda", precision=prec, device=DEVICE),
                exes[name, "cuda", prec], BATCHES, False))
        if name == "C-HTWK":
            cases.append((f"traced {name} int8", repro_torch.compile(
                traced, target="cuda", precision="int8", calibrate=4,
                device=DEVICE), exes[name, "cuda", "int8"], BATCHES[-1:],
                True))
        path = os.path.join(out_dir, f"{name}.npz")
        save_model(g, path)
        mb = repro_torch.ModelBuilder()
        mb.graph = g.copy()
        example = torch.as_tensor(inputs[name, 1], device=DEVICE)
        for how, model, kw in (
                ("container", path, {}),
                ("builder", mb, {"outputs": list(g.outputs)}),
                ("callable", TWINS[name](g.params),
                 {"example_inputs": (example,)})):
            cases.append((f"{how} {name} exact", repro_torch.compile(
                model, target="cuda", device=DEVICE, **kw),
                exes[name, "cuda", "exact"], BATCHES, False))
    dec_graph = repro_torch.trace(
        lambda q, k, v, lengths: F.decode_attention(q, k, v, lengths),
        (DECODE["h"], DECODE["d"]), (DECODE["s"], DECODE["hkv"], DECODE["d"]),
        (DECODE["s"], DECODE["hkv"], DECODE["d"]), TensorSpec((), "int32"))
    dec = repro_torch.compile(dec_graph, target="cuda", device=DEVICE)

    prev = torch.backends.cudnn.deterministic
    failures, rows = [], []
    launches = {k: 0 for k in KERNELS}
    try:
        # The path: counts set to 0, every program prepared (largest batch
        # first; int8 under deterministic cuDNN, as path A's programs
        # were captured), then each called once under the profiler.
        reset_counts()
        for _, exe, _, batches, det in cases:
            torch.backends.cudnn.deterministic = det
            for b in sorted(batches, reverse=True):
                exe.ensure_compiled(b)
        torch.backends.cudnn.deterministic = prev
        dec.ensure_compiled(1)
        torch.cuda.synchronize()
        prepared = read_counts()
        main_counts = {}
        for label, exe, main, batches, det in cases:
            torch.backends.cudnn.deterministic = det
            for b in batches:
                x = torch.as_tensor(inputs[label.split()[1], b],
                                    device=DEVICE)
                got, counts = profiled_call(lambda: exe(input=x))
                key = (id(main), b)
                if key not in main_counts:
                    main_counts[key] = profiled_call(lambda: main(input=x))
                want, want_counts = main_counts[key]
                equal = (len(got) == len(want) == 1 and torch.equal(
                    next(iter(got.values())), next(iter(want.values()))))
                for k in KERNELS:
                    launches[k] += counts[k]
                ok = equal and counts == want_counts and any(counts.values())
                if not ok:
                    failures.append([label, b])
                rows.append({"case": label, "batch": b, "bit_equal": equal,
                             "launches": counts, "main_launches": want_counts,
                             "ok": ok})
        torch.backends.cudnn.deterministic = prev
        feeds = cuda_feeds["exact", 1]
        got, counts = profiled_call(lambda: dec(**feeds))
        want = dec_exes["cuda", "exact"](**feeds)
        equal = torch.equal(next(iter(got.values())),
                            next(iter(want.values())))
        for k in KERNELS:
            launches[k] += counts[k]
        want_counts = {k: int(k == "decode_attention") for k in KERNELS}
        ok = equal and counts == want_counts
        if not ok:
            failures.append(["traced decode_attention", 1])
        rows.append({"case": "traced decode_attention", "batch": 1,
                     "shape": DECODE, "lengths": DECODE_LENGTHS[1],
                     "bit_equal": equal, "launches": counts,
                     "main_launches": want_counts, "ok": ok})
        wrappers = read_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    # The wrappers counted the preparing calls alone (a warm-up and a
    # captured call each): twice one replay's launches.
    want_wrappers = {k: 0 for k in KERNELS}
    for row in rows:
        for k in KERNELS:
            want_wrappers[k] += PREPARE_CALLS * row["launches"][k]
    if (wrappers != prepared or wrappers != want_wrappers
            or not all(launches.values())):
        failures.append(["launches", launches, wrappers, want_wrappers])
    seconds = time.perf_counter() - t_phase
    emit({"phase": "frontends", "cases": rows, "launches": launches,
          "wrapper_launches": wrappers, "wrapper_expected": want_wrappers,
          "seconds": seconds, "failures": failures, "ok": not failures})
    return [f"frontends phase failed: {failures}"] if failures else []


def replay_cli(bundle, *extra):
    """``python -m repro_torch.replay <bundle> --json`` in a fresh
    process: (exit code, its JSON result or None, seconds, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.replay", bundle, "--json",
         *extra], capture_output=True, text=True, env=env,
        timeout=REPLAY_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    try:
        result = json.loads(proc.stdout)
    except ValueError:
        result = None
    return proc.returncode, result, seconds, proc.stderr[-2000:]


def phase_replay(torch, np):
    """Capture bundles on the card: VGG19 exact and C-HTWK int8 compiled
    with ``autotune="full"``, a fresh cache directory and ``capture=``
    into ``chiprun_out/bundles``, at batch 256 then 1; each replayed by
    ``python -m repro_torch.replay --json`` in a fresh process, which
    must exit 0 with no divergence (outputs bit-exact, selections with
    their tactics equal); a copy with one byte of an ``io.npz`` flipped
    must exit 2.  A decode_attention bundle is left out: its seeded
    inputs cast a standard normal to int32 for ``lengths``, as the
    reference's do, so it would replay lengths of 0 and below."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "chiprun_out", "bundles")
    work = os.path.join(ROOT, "build", "chip_smoke_replay")
    for d in (root, work):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    failures, bundles = [], []
    try:
        for name, prec in REPLAY_BUNDLES:
            bundle = os.path.join(root, f"{name}-{prec}")
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                SUITE[name](), target="cuda", precision=prec, device=DEVICE,
                autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=os.path.join(work, f"{name}-{prec}"),
                capture=bundle, calibrate=4 if prec == "int8" else None)
            for b in PREPARE:
                exe.ensure_compiled(b)
            compile_s = time.perf_counter() - t0
            files = [os.path.join(r, n) for r, _, ns in os.walk(bundle)
                     for n in ns]
            rc, result, replay_s, err = replay_cli(bundle)
            ok = (rc == 0 and result is not None
                  and result["divergences"] == []
                  and result["device"] == DEVICE
                  and result["fingerprint_match"]
                  and sorted(result["batches"]) == sorted(BATCHES))
            if not ok:
                failures.append([name, prec, rc, result, err])
            measured = [n for b in BATCHES for n in
                        exe.cost_summary()["autotune"][b]["measured_nodes"]]
            bundles.append(bundle)
            emit_row = {
                "bundle": os.path.relpath(bundle, ROOT), "model": name,
                "precision": prec, "files": len(files),
                "bytes": sum(os.path.getsize(f) for f in files),
                "compile_s": compile_s,
                "record_s_by_batch": exe._capture.seconds,
                "measured_nodes": measured, "replay_exit": rc,
                "replay_s": replay_s,
                "divergences": result and result["divergences"],
                "ok": ok}
            emit({"phase": "replay", **emit_row})
        # One byte of the first bundle's io.npz flipped, in a copy: the
        # manifest's hash refuses it (exit 2) before anything runs.
        tampered = os.path.join(work, "tampered")
        shutil.copytree(bundles[0], tampered)
        io_path = os.path.join(tampered, "batches", str(BATCHES[-1]),
                               "io.npz")
        with open(io_path, "r+b") as f:
            f.seek(os.path.getsize(io_path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        rc, result, replay_s, err = replay_cli(tampered)
        tamper_ok = rc == 2 and "tampered" in err
        if not tamper_ok:
            failures.append(["tampered", rc, err])
        seconds = time.perf_counter() - t_phase
        emit({"phase": "replay", "tampered": os.path.relpath(io_path, work),
              "replay_exit": rc, "replay_s": replay_s,
              "stderr": err.strip()[-300:], "seconds": seconds,
              "failures": failures, "ok": not failures})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [f"replay phase failed: {failures}"] if failures else []


#: The default pipeline up to the quantize pass (its input graph).
PRE_QUANTIZE = ("canonicalize", "fold_constants", "fuse_pad",
                "fuse_activation", "fold_batchnorm", "fuse_activation.post_bn")


def phase_time_models(torch, exes, inputs, per_model):
    from repro_torch.table1_models import SUITE
    for name in SUITE:
        for b in BATCHES:
            x = inputs[name, b]
            row = {"phase": "time", "model": name, "batch": b}
            xt = torch.as_tensor(x, device=DEVICE)
            for key in (("interpret", "exact"), ("jit", "exact"),
                        ("cuda", "exact"), ("cuda", "fast")):
                exe = exes[(name,) + key]
                tag = "_".join(key)
                # Captured programs under the existing keys; the eager
                # walk of the same prepared program beside them.
                row[tag + "_ms"] = host_median_ms(lambda: exe(input=xt))
                if key[0] != "interpret":
                    row[tag + "_eager_ms"] = host_median_ms(
                        lambda: eager_call(exe, {"input": xt}))
            exe = exes[name, "cuda", "exact"]
            row["cuda_exact_device_ms"] = device_ms(lambda: exe(input=xt))
            exe_f = exes[name, "cuda", "fast"]
            row["cuda_fast_device_ms"] = device_ms(lambda: exe_f(input=xt))
            row["cuda_exact_queued_ms"] = queued_ms(
                lambda: exe(input=xt), iters=5, spin=400_000_000)
            for tag in ("cuda_exact", "cuda_fast"):
                if row[tag + "_device_ms"] is not None:
                    row[tag + "_device_busy"] = (row[tag + "_device_ms"]
                                                 / row[tag + "_ms"])
                    row[tag + "_eager_device_busy"] = (
                        row[tag + "_device_ms"] / row[tag + "_eager_ms"])
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
    # What the timing itself costs: one empty kernel between the same
    # events, after the same flush, as every kernel row below.
    emit({"phase": "time", "kernel": "launch_floor",
          "ms": cold_ms(lambda: torch.cuda._sleep(0)),
          "what": "torch.cuda._sleep(0) timed as cold_ms times a kernel"})
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
        src = SUITE[name]()   # every softmax's exp, at its input's shape
        src_specs = src.infer_shapes()
        for node in src.nodes:
            if node.op != "softmax":
                continue
            shape = tuple(src_specs[node.inputs[0]].shape)
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m,) + shape),
                                 dtype=torch.float32, device=dev)
                ms = cold_ms(lambda: fast_act(x, "exp"))
                call = cuda_ms(lambda: fast_act(x, "exp"))
                plain = cold_ms(lambda: fa_ref.schraudolph_exp(x))
                lib = cold_ms(lambda: torch.exp(x))
                y = torch.empty_like(x)   # the same bytes moved, no math
                copy = cold_ms(lambda: y.copy_(x))
                nel = x.numel()
                # clamp (2), multiply, add, convert per element
                bnd, by = bound_ms(8.0 * nel, 5.0 * nel)
                row = {"phase": "time", "kernel": "fast_act", "fn": "exp",
                       "model": name, "node": node.name, "shape": [m, *shape],
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "copy_ms": copy, "bound_ms": bnd,
                       "bound_by": by,
                       "achieved_tb_per_s": 8.0 * nel / (ms * 1e-3) / 1e12}
                rows["fast_act"].append(row)
                emit(row)
    torch.cuda.synchronize()
    fused_matmul.launches, fast_act.launches = saved
    return rows


def phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds, cuda_feeds):
    """Host medians of the int8, bf16 and decode compiles, captured and
    eager (the per-model rows of path 1 are ``phase_time_models``')."""
    from repro_torch.table1_models import SUITE
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # as path A was captured
    for prec, models in (("int8", INT8_MODELS), ("bf16", tuple(SUITE))):
        for name in models:
            for b in BATCHES:
                xt = torch.as_tensor(inputs[name, b], device=DEVICE)
                row = {"phase": "time", "path": "A", "model": name,
                       "batch": b, "precision": prec}
                for target in ("cuda", "jit"):
                    exe = exes[name, target, prec]
                    row[f"{target}_ms"] = host_median_ms(lambda: exe(input=xt))
                    row[f"{target}_eager_ms"] = host_median_ms(
                        lambda: eager_call(exe, {"input": xt}))
                exe = exes[name, "cuda", prec]
                row["cuda_device_ms"] = device_ms(lambda: exe(input=xt))
                if row["cuda_device_ms"] is not None:
                    row["cuda_device_busy"] = row["cuda_device_ms"] / row["cuda_ms"]
                emit(row)
    torch.backends.cudnn.deterministic = prev
    for b, feeds in dec_feeds.items():
        row = {"phase": "time", "path": "B", "batch": b, "shape": DECODE}
        for p in ("exact", "fast"):
            exe, f = dec_exes["cuda", p], cuda_feeds[p, b]
            row[f"cuda_{p}_ms"] = host_median_ms(lambda: exe(**f), runs=10)
            row[f"cuda_{p}_eager_ms"] = host_median_ms(
                lambda: eager_call(exe, f), runs=10)
        exe = dec_exes["interpret", "exact"]
        row["interpret_exact_ms"] = host_median_ms(lambda: exe(**feeds),
                                                   runs=10)
        exe, f = dec_exes["cuda", "exact"], cuda_feeds["exact", b]
        row["cuda_exact_device_ms"] = device_ms(lambda: exe(**f), iters=5)
        if row["cuda_exact_device_ms"] is not None:
            row["cuda_exact_device_busy"] = (row["cuda_exact_device_ms"]
                                             / row["cuda_exact_ms"])
        emit(row)


def phase_time_q8(torch, np, exes):
    """fused_matmul_q8 at every int8 dense node of path A, batch 1 and
    256: the kernel, its plain version, ``torch._int_mm`` where its shape
    rules allow it (the integer product alone), and the bound."""
    from repro_torch.core.lowering import quant_key
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import kernel as fm_k
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
                       "plan": fm_k.plan_q8(m, k, n,
                                            w_layout=layout).describe(),
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


# ---------------------------------------------------------------------------
# The engine phase (a child process: ``python3 chip_smoke.py --engine``)
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12        # bf16 tensor-core peak, dense
#: The transformer-family configs the engine target runs (the other three
#: families are ROADMAP A.12b).
ENGINE_ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
                "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b")
#: Card against CPU at f32, relative to max(1, max|logits|) (the
#: reference's own f32 decode-vs-forward test holds 1e-4).
ENGINE_F32_TOL = 1e-4
#: Prefill and decode against the forward at the published widths, f32:
#: sums over 5120-13824 terms in another order and 48 layers deep.
ENGINE_DECODE_TOL = 1e-3
ENGINE_SMOKE = (2, 24, 8)        # batch, prompt, greedy decode steps
#: qwen2.5-14b: the consistency check, the prefill and decode rows, and
#: decode_32k's depth (its batch of 128 cut to 4: a 25.77 GB K/V cache).
QWEN_CHECK = (2, 64, 8)
QWEN_PREFILL = (4, 512)
QWEN_DECODE = (1, 8)
QWEN_MAX_LEN = 2048
QWEN_DECODE_PROMPT = 128
QWEN_DEEP = (4, 32768)
#: mixtral-8x22b at its widths, 2 of 56 layers: a prompt 6 short of the
#: 4096 window, then 16 steps, so the ring cache wraps.
MIXTRAL_LAYERS = 2
MIXTRAL_CHECK = (1, 4090, 16)
ENGINE_TIMEOUT_S = 600


def _rel_err(got, want):
    """(max |got - want|, max(1, max |want|)) as floats."""
    want = want.float()
    return (float((got.float().to(want.device) - want).abs().max()),
            max(1.0, float(want.abs().max())))


def _greedy(torch, model, params, batch, steps, max_len, device):
    """Prefill then ``steps`` greedy decode steps: (tokens (B, steps),
    logits (B, steps + 1, V) of prefill and each step)."""
    b = batch["tokens"].shape[0]
    cache = model.init_cache(b, max_len, device)
    lg, cache = model.prefill(params, batch, cache)
    logits, toks = [lg[:, -1]], []
    for _ in range(steps):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        lg, cache = model.decode_step(params, cache, tok)
        logits.append(lg[:, -1])
    return torch.cat(toks, 1), torch.stack(logits, 1), cache


def _peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def phase_engine_smoke(torch, np):
    """(a) Each transformer-family SMOKE config through ``target="engine"``
    on the card and on the CPU, with the same weights (made on the CPU
    from a seed, moved to the card): f32 forward logits, prefill plus
    greedy decode, and forward at the configured bf16."""
    import dataclasses
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    problems = []
    b, s, steps = ENGINE_SMOKE
    for arch in ENGINE_ARCHS:
        t0 = time.perf_counter()
        base = get_config(arch, smoke=True)
        params = get_model(base).init(0, "cpu")
        rng = np.random.default_rng(0)
        batch = {"tokens":
                 rng.integers(0, base.vocab, (b, s)).astype(np.int32)}
        if base.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, base.num_image_tokens, base.vit_dim)).astype(np.float32)
        row = {"phase": "engine", "case": "smoke", "arch": arch}
        for dtype in ("float32", base.dtype):
            cfg = dataclasses.replace(base, dtype=dtype)
            exes = {dev: repro_torch.compile(
                cfg, repro_torch.CompileOptions(target="engine", device=dev),
                params=params) for dev in ("cpu", DEVICE)}
            torch.cuda.reset_peak_memory_stats()
            want = exes["cpu"](**batch)["logits"]
            got = exes[DEVICE](**batch)["logits"]
            assert got.device.type == torch.device(DEVICE).type
            err, scale = _rel_err(got, want)
            tol = ENGINE_F32_TOL if dtype == "float32" else QUANT_BUDGET
            row[f"{dtype}_forward_err"] = err
            row[f"{dtype}_forward_limit"] = tol * scale
            if err > tol * scale:
                problems.append(f"engine {arch} {dtype} forward: card vs "
                                f"CPU {err} > {tol * scale}")
            if dtype == "float32":
                out = {}
                for dev, exe in exes.items():
                    feed = {k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()}
                    out[dev] = _greedy(torch, exe.model, exe.params, feed,
                                       steps, s + steps, dev)
                same = torch.equal(out[DEVICE][0].cpu(), out["cpu"][0])
                derr, _ = _rel_err(out[DEVICE][1], out["cpu"][1])
                row.update(greedy_tokens=out[DEVICE][0].tolist(),
                           greedy_equal=same, decode_err=derr)
                if not same or derr > tol * scale:
                    problems.append(f"engine {arch} greedy decode: tokens "
                                    f"equal {same}, logits err {derr}")
            row[f"{dtype}_peak_gb"] = _peak_gb(torch)
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    return problems


def _llm_rows(torch, exe, label, deep=False):
    """Prefill and decode timings of an engine executable at the
    published widths: host ms around synchronised calls, the device's
    busy share (torch.profiler's device time over the host's), the
    bound, and the top device ops of one decode step."""
    cfg, model, params = exe.cfg, exe.model, exe.params
    cost = exe.cost_summary()
    wbytes = cost["param_bytes"]
    kv_row = 2 * cfg.num_layers * cfg.n_kv_heads * cfg.head_dim * 2  # K+V bf16
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             device=DEVICE, dtype=torch.int32)

    with torch.inference_mode():
        b, s = QWEN_PREFILL
        torch.cuda.reset_peak_memory_stats()
        prompt = {"tokens": tokens(b, s)}
        cache = model.init_cache(b, QWEN_MAX_LEN, DEVICE)
        pf = lambda: model.prefill(params, prompt, cache)
        ms = host_median_ms(pf, runs=3, warmup=1)
        prof = device_profile(pf, iters=1)
        dev_ms = sum(v[1] for v in prof.values())
        flops = 2 * (cost["params"] - cfg.vocab * cfg.d_model) * b * s
        attn = 2 * b * s * s * cfg.n_heads * cfg.head_dim  # causal q.k + p.v
        t_bytes = (wbytes + b * s * kv_row) / HBM_BYTES_PER_S * 1e3
        t_ops = (flops / BF16_FLOPS_PER_S + attn / F32_FLOPS_PER_S) * 1e3
        row = {"phase": "engine", "case": "qwen2.5-14b", "precision": label,
               "op": "prefill", "batch": b, "tokens": s, "ms": ms,
               "tokens_per_s": b * s / ms * 1e3, "device_ms": dev_ms,
               "busy_share": dev_ms / ms,
               "launches": sum(v[0] for v in prof.values()),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "peak_gb": _peak_gb(torch)}
        emit(row)
        del cache, pf
        points = [(bb, QWEN_DECODE_PROMPT, QWEN_MAX_LEN) for bb in QWEN_DECODE]
        if deep:
            points.append((QWEN_DEEP[0], None, QWEN_DEEP[1]))
        for bb, prompt_len, max_len in points:
            torch.cuda.reset_peak_memory_stats()
            cache = model.init_cache(bb, max_len, DEVICE)
            if prompt_len is None:        # decode_32k's depth: a filled cache
                for name in ("c1", "c2"):
                    for i in range(cfg.num_layers):
                        cache[name][i].normal_(generator=gen)
                cache["pos"].fill_(max_len - 12)
            else:
                model.prefill(params, {"tokens": tokens(bb, prompt_len)},
                              cache)
            tok = tokens(bb, 1)
            step = lambda: model.decode_step(params, cache, tok)
            ms = host_median_ms(step, runs=5 if prompt_len is None else 10,
                                warmup=2)
            prof = device_profile(step, iters=2)
            busy = sum(v[1] for v in prof.values())
            depth = int(cache["pos"][0])
            kv = bb * depth * kv_row
            bound = (wbytes + kv) / HBM_BYTES_PER_S * 1e3
            top = sorted(prof.items(), key=lambda kv_: -kv_[1][1])[:10]
            row = {"phase": "engine", "case": "qwen2.5-14b",
                   "precision": label, "op": "decode", "batch": bb,
                   "depth": depth, "ms": ms, "tokens_per_s": bb / ms * 1e3,
                   "device_ms": busy, "busy_share": busy / ms,
                   "launches": sum(v[0] for v in prof.values()),
                   "bound_ms": bound, "bound_by": "bytes",
                   "weight_gb": wbytes / 1e9, "kv_read_gb": kv / 1e9,
                   "peak_gb": _peak_gb(torch),
                   "top_ops": [{"name": k[:120], "launches": n, "ms": t}
                               for k, (n, t) in top]}
            emit(row)
            del cache, step


def phase_engine_qwen(torch):
    """(b) qwen2.5-14b, the whole published config, made on the card:
    decode against forward at f32, then the timing rows at bf16
    activations with f32 masters ("exact") and bf16 weights ("bf16")."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    problems = []
    cfg = get_config("qwen2.5-14b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe32 = repro_torch.compile(
        dataclasses.replace(cfg, dtype="float32"),
        repro_torch.CompileOptions(target="engine", device=DEVICE),
        init_seed=0)
    cost = exe32.cost_summary()
    init_s = time.perf_counter() - t0
    if cost["params"] != 14_770_033_664:
        problems.append(f"qwen2.5-14b has {cost['params']} parameters")
    b, s, steps = QWEN_CHECK
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        toks, logits, _ = _greedy(torch, exe32.model, exe32.params,
                                  {"tokens": prompt}, steps, s + steps,
                                  DEVICE)
        full = exe32(tokens=torch.cat([prompt, toks], 1))["logits"]
    want = full[:, s - 1:s + steps]
    err, scale = _rel_err(logits, want)
    same = torch.equal(toks, want[:, :steps].argmax(-1).to(torch.int32))
    emit({"phase": "engine", "case": "qwen2.5-14b", "op": "decode_vs_forward",
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params": cost["params"], "param_bytes_f32": cost["param_bytes"],
          "batch": b, "prompt": s, "steps": steps, "max_abs_err": err,
          "limit": ENGINE_DECODE_TOL * scale, "greedy_equal": same,
          "tokens": toks.tolist(), "init_s": init_s,
          "peak_gb": _peak_gb(torch),
          "seconds": time.perf_counter() - t0})
    if err > ENGINE_DECODE_TOL * scale or not same:
        problems.append(f"qwen2.5-14b decode vs forward: err {err} "
                        f"(limit {ENGINE_DECODE_TOL * scale}), greedy "
                        f"tokens equal {same}")
    del full, want, logits
    # The config as published (bf16 activations) over the f32 masters:
    # the same tensors, cast at each product as the reference does.
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), params=exe32.params)
    del exe32
    _llm_rows(torch, exe, "exact")
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision="bf16", device=DEVICE), init_seed=0)
    emit({"phase": "engine", "case": "qwen2.5-14b", "op": "bf16_compile",
          "seconds": time.perf_counter() - t0,
          "param_bytes": exe.cost_summary()["param_bytes"],
          "quant": exe.quant_report, "peak_gb": _peak_gb(torch)})
    _llm_rows(torch, exe, "bf16", deep=True)
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def phase_engine_mixtral(torch):
    """(c) mixtral-8x22b at its widths, 2 of 56 layers, f32 with moe_cf 8
    (the reference's decode-vs-forward test): a 4090-token prompt and 16
    greedy steps, past the 4096-token window, so the ring cache wraps."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    problems = []
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS, dtype="float32",
                              moe_cf=8.0)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), init_seed=0)
    b, s, steps = MIXTRAL_CHECK
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        toks, logits, cache = _greedy(torch, exe.model, exe.params,
                                      {"tokens": prompt}, steps, s + steps,
                                      DEVICE)
        full = exe(tokens=torch.cat([prompt, toks], 1))["logits"]
    want = full[:, s - 1:s + steps]
    err, scale = _rel_err(logits, want)
    same = torch.equal(toks, want[:, :steps].argmax(-1).to(torch.int32))
    ring, last = cache["c1"].shape[2], int(cache["pos"][0])
    emit({"phase": "engine", "case": "mixtral-8x22b",
          "op": "decode_vs_forward", "layers": cfg.num_layers,
          "reduced": "num_layers 56 -> 2",
          "params": exe.cost_summary()["params"], "batch": b, "prompt": s,
          "steps": steps, "ring": ring, "last_pos": last,
          "max_abs_err": err, "limit": ENGINE_DECODE_TOL * scale,
          "greedy_equal": same, "peak_gb": _peak_gb(torch),
          "seconds": time.perf_counter() - t0})
    if err > ENGINE_DECODE_TOL * scale or not same or last <= ring:
        problems.append(f"mixtral decode vs forward: err {err} (limit "
                        f"{ENGINE_DECODE_TOL * scale}), greedy tokens equal "
                        f"{same}, ring {ring} last position {last}")
    del exe, full, want, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def engine_main() -> int:
    """The engine phase, alone in this process so that it has the card's
    memory to itself: qwen2.5-14b's f32 masters take 59.08 GB."""
    import torch
    import numpy as np
    if not torch.cuda.is_available():
        print("chip_smoke --engine: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "engine", "case": "start", "free_gb": free / 1e9,
          "total_gb": total / 1e9})
    problems = phase_engine_smoke(torch, np)
    problems += phase_engine_qwen(torch)
    problems += phase_engine_mixtral(torch)
    if problems:
        raise SystemExit("engine phase failed: " + "; ".join(problems))
    return 0


def phase_engine():
    """Run the engine phase in a child process, killed after
    ENGINE_TIMEOUT_S, and pass its lines on."""
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--engine"], cwd=ROOT, stdout=subprocess.PIPE,
                            text=True)
    watchdog = threading.Timer(ENGINE_TIMEOUT_S, proc.kill)
    watchdog.start()
    problems = []
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            try:
                emit(json.loads(line))
            except ValueError:
                print(line, flush=True)
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    if seconds >= ENGINE_TIMEOUT_S:
        problems.append(f"engine phase killed after {seconds:.0f} s")
    if rc != 0:
        problems.append(f"engine phase exited {rc}")
    emit({"phase": "engine", "case": "done", "seconds": seconds, "rc": rc})
    return problems


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
    engine_problems = phase_engine()
    errs = {}
    errs["fused_matmul"], errs["fast_act"], problems = phase_check(torch, np)
    problems += engine_problems
    errs["fused_matmul_q8"], more = phase_check_q8(torch, np)
    problems += more
    errs["decode_attention"], more = phase_check_decode(torch, np)
    problems += more
    exes, inputs, launches, per_model, more = phase_main(torch, np)
    problems += more
    launches_a, more = phase_path_a(torch, np, exes, inputs)
    problems += more
    dec_exes, dec_feeds, cuda_feeds, launches_b, more = phase_path_b(torch, np)
    problems += more
    totals = {k: launches[k] + launches_a[k] + launches_b[k] for k in KERNELS}
    problems += phase_program(torch, np, program_cases(
        torch, np, exes, inputs, dec_exes, cuda_feeds))
    problems += phase_split_counters(torch, np)
    problems += phase_runtime(torch, np, exes, inputs)
    problems += phase_cache(torch, np, exes, inputs)
    problems += phase_pool(torch, np, list(exes.values())
                           + list(dec_exes.values()))
    problems += phase_autotune(torch, np, exes, inputs)
    problems += phase_mixed(torch, np, exes, inputs)
    problems += phase_frontends(torch, np, exes, inputs, dec_exes, cuda_feeds)
    problems += phase_replay(torch, np)
    phase_time_models(torch, exes, inputs, per_model)
    phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds, cuda_feeds)
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
    if sys.argv[1:] == ["--engine"]:
        sys.exit(engine_main())
    try:
        rc = main()
    finally:
        if _OUT:
            save_log()
    sys.exit(rc)
