"""The system under test as a compiled graph called in a closed loop: the configuration's
graph built with ``repro_torch.core.ModelBuilder`` over weights the
reference module makes from the seed, ``repro_torch.compile`` with the
configuration's options, then one caller sending its next batch from the
mix's ring as soon as the previous output is back on the host.

The window: each call is ``exe(input=x)`` with ``x`` in (pinned) host
memory, then the output read back to the host; the benchmark times each
from the call to the output on the host.

``correct``: every output of the window is compared with the reference's
output for the same input; the widest gap between their logs must stay
within the cell's limit.  The control (the reference with TF32 on) is
judged the same way, on the same inputs, in the outputs' place.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import counts, generator
from ..trace import Slice, span, warm_profiler


def build_graph(ModelBuilder, cfg: Dict, weights: List[tuple]):
    """The configuration's graph through the program's ModelBuilder, its
    kernels and biases the given host arrays (in layer order)."""
    kernels = iter(k for _, k, _ in weights)

    class Seeded(ModelBuilder):
        def _init(self, shape, fan_in):
            k = next(kernels)
            if tuple(k.shape) != tuple(shape):
                raise ValueError(f"kernel {k.shape} for {shape}")
            return k

    mb = Seeded()
    h = mb.input(tuple(cfg["input"]))
    for width, convs in cfg["blocks"]:
        for _ in range(convs):
            h = mb.conv2d(h, width, (3, 3), activation="relu")
        h = mb.maxpool(h)
    h = mb.flatten(h)
    for i, n in enumerate(cfg["dense"]):
        last = i == len(cfg["dense"]) - 1
        h = mb.dense(h, n, activation=None if last else "relu")
    h = mb.softmax(h)
    graph = mb.build([h])
    layers = [n for n in graph.nodes if n.op in ("conv2d", "dense")]
    for node, (_, _, b) in zip(layers, weights):
        graph.params[node.params["bias"]] = b
    return graph


def run(r) -> Dict:
    import repro_torch
    from repro_torch.core import ModelBuilder

    cfg, mix = r.config, r.mix
    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    batch = int(mix["batch"])
    if int(mix.get("callers", 1)) != 1:
        raise ValueError("a closed loop of one caller only")
    weights = r.reference.make_weights(cfg, r.seed, dev)
    host = [(kind, k.cpu().numpy(), b.cpu().numpy())
            for kind, k, b in weights]
    del weights
    tb = time.perf_counter()
    exe = repro_torch.compile(
        build_graph(ModelBuilder, cfg, host),
        repro_torch.CompileOptions(device=r.device, **cfg["compile"]))
    del host
    ring = generator.generate(mix, r.seed, r.seconds, cfg, r.here)
    next(iter(exe(input=ring[0]).values())).cpu()
    compile_s = time.perf_counter() - tb
    chosen = [c["kernel"] for c in exe.cost_summary()
              .get("kernel_selection", {}).get(batch, [])
              if c["op"] == "dense"]
    if r.trace and cuda:
        warm_profiler(r.device)
    setup_s = time.time() - r.t0

    lat: List[float] = []
    outs: List[torch.Tensor] = []
    idx: List[int] = []
    slice_s = float(mix.get("trace_slice_s", 2.0))
    sl, sl_first = None, 0
    k, R = 0, len(ring)
    t0 = time.perf_counter()
    t_end = t0 + r.seconds
    while True:
        tb = time.perf_counter()
        if tb >= t_end:
            break
        if r.trace and cuda and sl is None and tb >= t_end - slice_s:
            sl = Slice(r.out_dir / f"{r.cell}.{r.seed}.json.gz")
            sl.__enter__()
            sl_first = len(lat)
        with span("call", r.trace):
            out = exe(input=ring[k % R])
        with span("readback", r.trace):
            y = next(iter(out.values())).cpu()
        ta = time.perf_counter()
        if ta <= t_end:
            lat.append(ta - tb)
            outs.append(y)
            idx.append(k % R)
        k += 1
    reading = None
    if sl is not None:
        sl.__exit__(None, None, None)
        reading = sl.read()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del exe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    weights = r.reference.make_weights(cfg, r.seed, dev)
    x = torch.cat(ring).to(dev)
    ref = r.reference.forward(cfg, weights, x).cpu()
    ref = ref.view(R, batch, -1)
    got = torch.stack(outs) if outs else torch.empty(0, batch, ref.shape[-1])
    err = r.reference.max_log_error(
        got, ref[torch.as_tensor(idx, dtype=torch.long)]) \
        if outs else float("nan")
    check = {"max_log_error": {"value": err,
                               "limit": r.limits["max_log_error"],
                               "holds": "<="},
             "compared_images": {"value": len(outs) * batch,
                                 "limit": r.limits["compared_images"],
                                 "holds": ">="}}
    result = {
        "kind": "infer", "window_s": r.seconds, "latency_s": lat,
        "images": len(lat) * batch, "calls": len(lat), "batch": batch,
        "compile_s": compile_s, "setup_s": setup_s,
        "memory_peak_bytes": peak, "check": check, "trace": reading,
        "slice_latency_s": lat[sl_first:] if sl is not None else [],
        "dense_kernels": chosen, "config": cfg,
        "peak_flops": counts.PEAK_FLOPS[cfg["peak"]],
        "attempted": len(lat), "failed": 0,
    }
    if r.control:
        ctrl = r.reference.forward(cfg, weights, x, tf32=True).cpu()
        ctrl = ctrl.view(R, batch, -1)[torch.as_tensor(idx, dtype=torch.long)]
        result["control_check"] = dict(check, max_log_error=dict(
            check["max_log_error"],
            value=r.reference.max_log_error(ctrl, ref[torch.as_tensor(
                idx, dtype=torch.long)]) if outs else float("nan")))
    return result
