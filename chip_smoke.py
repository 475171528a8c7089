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
MATMUL_ATOL = 1e-4               # kernel vs plain: f32 sums in another order
EXACT_ATOL = 1e-4                # cuda exact vs interpret on the card
FAST_ATOL = 1e-5                 # cuda fast on the card vs on the CPU
BATCHES = (1, 256)
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


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn()``: the sum of every CUDA kernel it
    launched, from ``torch.profiler``, over ``iters`` calls; None when
    the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        t = getattr(evt, "self_device_time_total", None)
        total_us += t if t is not None else getattr(evt, "self_cuda_time_total", 0.0)
    return total_us / iters / 1e3 if total_us else None


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
             if "registers" in l or "Compiling entry" in l]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "library": os.path.relpath(str(lib), ROOT), "ptxas": ptxas})


MAIN_DENSE_KN = [(128, 16), (16, 4), (256, 32), (32, 2), (256, 128),
                 (128, 128), (128, 10)]
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
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes.append((300, 257, 130))
    worst, failures, cases = 0.0, [], 0
    for m, k, n in shapes:
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
                    if not err <= MATMUL_ATOL:
                        failures.append([m, k, n, str(dtype), layout, name, err])
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "fused_matmul", "cases": cases,
          "max_abs_err": worst, "atol": MATMUL_ATOL,
          "inputs": "unit-normal x and W, f32 accumulation, TF32 off",
          "failures": failures[:20]})
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
    fused_matmul.launches = 0
    fast_act.launches = 0
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
    launches = {"fused_matmul": fused_matmul.launches,
                "fast_act": fast_act.launches}

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
    if failures or launches != expect_total or not all(launches.values()):
        problems.append(f"main path failed: {failures}, launches {launches}, "
                        f"expected {expect_total}")
    return exes, inputs, launches, per_model, problems


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
    fm_err, fa_err, problems = phase_check(torch, np)
    exes, inputs, launches, per_model, more = phase_main(torch, np)
    problems += more
    phase_time_models(torch, exes, inputs, per_model)
    rows = phase_time_kernels(torch, np, exes)
    if problems:
        # Every phase ran and printed its findings; now fail.
        raise SystemExit("chip_smoke failed: " + "; ".join(problems))

    def summary(kernel, source, replaces, err, row, at):
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kernel],
                "max_abs_err": err, "ms": row["ms"], "call_ms": row["call_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "at": at}

    fm_row = max(rows["fused_matmul"], key=lambda r: r["M"] * r["K"] * r["N"])
    fa_row = max(rows["fast_act"],
                 key=lambda r: int(np.prod(r["shape"])))
    emit({"kernels": [
        summary("fused_matmul", "src/repro_torch/csrc/fused_matmul.cu",
                "src/repro/kernels/fused_matmul/kernel.py:109", fm_err, fm_row,
                f"{fm_row['model']} {fm_row['node']} M={fm_row['M']} "
                f"K={fm_row['K']} N={fm_row['N']} {fm_row['layout']}"),
        summary("fast_act", "src/repro_torch/csrc/fast_act.cu",
                "src/repro/kernels/fast_act/kernel.py:61", fa_err, fa_row,
                f"{fa_row['model']} softmax exp {fa_row['shape']}"),
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
