"""One profiler trace of a short steady slice of a run, and what the
per-layer readers take from it: the device's busy time (the union of
every kernel, copy and set on the card), device time by kernel name,
the operations that took most time, and the idle gaps, each named by
the benchmark span (``bench.<name>``, a ``record_function`` around each
call into the program) the host was in at the gap's middle."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

from .stats import merge

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
#: Names of the kernels cuDNN runs for a convolution: direct and
#: implicit-GEMM forms, FFT stages, Winograd, and the layout transposes
#: around an NCHW algorithm.
CONV_KERNELS = ("fprop", "implicit_gemm", "convolve", "winograd", "fft",
                "pointwise_mult_and_sum_complex", "nchwToNhwc",
                "nhwcToNchw")


def span(name: str, on: bool):
    """A host span of the benchmark, seen in the trace (only in a traced
    run: the untraced one pays nothing for it)."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def warm_profiler(device) -> None:
    """One short profile in set-up: the profiler's first start is slow."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


class Slice:
    """``with Slice(path) as s: ...`` profiles the block (host and card);
    :meth:`read` writes the trace compressed to ``path`` (``.json.gz``)
    and returns :func:`summarize`'s reading."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        self.prof = None
        self.window_s = 0.0

    def __enter__(self) -> "Slice":
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)

    def read(self) -> Dict:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        raw = self.path.with_suffix("")            # <name>.json
        self.prof.export_chrome_trace(str(raw))
        with open(raw) as f:
            events = json.load(f).get("traceEvents", [])
        with open(raw, "rb") as f, gzip.open(self.path, "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(raw)
        return summarize(events, self.window_s)


def summarize(events: List[Dict], window_s: float) -> Dict:
    """The reading of one trace's events (chrome-trace form, µs)."""
    dev, spans, kernel_s, kernel_n, op_s = [], [], {}, {}, {}
    lo, hi = None, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        lo = a if lo is None else min(lo, a)
        hi = a + d if hi is None else max(hi, a + d)
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((a, a + d))
            op_s[name] = op_s.get(name, 0.0) + d / 1e6
            if cat == "kernel":
                kernel_s[name] = kernel_s.get(name, 0.0) + d / 1e6
                kernel_n[name] = kernel_n.get(name, 0) + 1
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((a, a + d, name[len(SPAN_PREFIX):]))
    busy = merge(dev)
    gaps = []
    if busy:
        edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], hi))
        gaps = sorted((e for e in edges if e[1] > e[0]),
                      key=lambda e: e[0] - e[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "device_ops": sorted(([n, s] for n, s in op_s.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[_host_span(spans, (a + b) / 2), (b - a) / 1e6]
                      for a, b in gaps],
    }


def _host_span(spans, t: float) -> str:
    """The innermost benchmark span around time ``t``, else ``host``."""
    best: Optional[tuple] = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host"


def kernel_time(reading: Dict, names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``."""
    return sum(s for n, s in reading["kernel_s"].items()
               if any(k in n for k in names))


def idle_share(reading: Optional[Dict]) -> Optional[float]:
    """Percent of the slice in which nothing ran on the card."""
    if not reading or reading["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])
