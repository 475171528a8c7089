"""Calibration-driven low-precision quantization.

The port of ``repro.core.passes.quantize``.  The pass consumes a
quantization *request* riding on ``graph.quant`` (targets attach it from
``CompileOptions(precision=..., calibrate=...)``) and annotates the graph
instead of rewriting arithmetic:

* a **calibration walk** runs ``calibrate`` seeded sample batches
  (``default_rng(0)``, 4 rows each) through the oracle semantics of the
  *current* (fused, folded) graph, recording per-tensor ``|x|`` abs-max
  and 99.9th-percentile ranges;
* every eligible site (``dense``, ``conv2d``) gets ``quant.mode`` plus,
  for int8, the calibrated per-tensor input scale (``quant.x_scale``)
  and per-output-channel weight scales (``quant.w_scale``, from the
  static f32 weights); zero points are 0 (``quant.zp``);
* ``mode="mixed"`` measures each site's f32 candidate and every narrow
  one the prior allows under the autotuner's
  :class:`~repro_torch.autotune.measure.Deadline`, keeps the fastest
  whose max abs error against the f32 site output on the first
  calibration batch is within the budget, and stores the winners in the
  fingerprinted tactic cache.

Annotations are plain node attrs, so they flow into
``Graph.structure_hash()``.  The low-precision arithmetic lives in the
lowering rules and ``repro_torch.kernels.qmath``, which every target
reads alike.

The calibration walk runs on the CPU (``SimpleNN(device="cpu")``), like
every compile-time pass, so the annotations — and the hash — do not
depend on the device a program is compiled for.

The prior is the reference's off-TPU prior, on every device: int8
``conv2d`` sites stay f32.  The port has no int8 convolution kernel and
torch exposes no int8 cuDNN convolution, so under this prior the port
annotates a graph exactly as the reference does off-TPU; int8 ``dense``
sites run the ``fused_matmul_q8`` kernel on the ``cuda`` target.

Under ``mixed`` the calibration walk stays on the CPU, but the site
runners (:func:`_site_runner`: the lowering's expressions, the dense
kernels through their wrappers) run on the compile's device, which the
request carries (``device``): a ``cuda`` compile measures the card's
device time, and its cache keys carry the card's fingerprint.  The
request's ``measure`` is false under ``autotune="cached"`` and for the
``interpret`` target, which then take winners from the cache only (a
site without one stays f32).

Scheduling: after ``fuse_activation.post_bn`` (calibration must see the
folded weights the program will quantize) and before ``optimize_layout``
(the walk reads logical ``(K, N)`` kernels; per-channel scales are
layout-invariant).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import Graph, Node
from ..ops_common import apply_activation
from .manager import register_pass
from ...kernels import qmath

#: Ops the pass may rewrite to low precision.
QUANT_OPS = ("dense", "conv2d")
#: Sample batches when the request does not say (``calibrate=None``).
DEFAULT_CALIBRATE = 4
#: Rows per calibration batch.
CALIBRATION_BATCH = 4
#: Accuracy budget (max_abs_err vs the f32 site outputs on the first
#: calibration batch) of ``mode="mixed"`` when the request carries none.
DEFAULT_PRECISION_BUDGET = 0.05
#: Wall-clock budget of mixed-mode measurement when the request has none.
DEFAULT_MEASURE_BUDGET_MS = 1000.0

_MODES = ("f32", "bf16", "int8", "mixed")


def _kernel_out_axis(node: Node) -> int:
    """Output-channel axis of the site's kernel param: dense (K, N) →
    1, conv2d HWIO → 3.  The pass runs pre-layout, so dense kernels are
    always logical "io"."""
    return 1 if node.op == "dense" else 3


def _apply_manual_epilogue(y: torch.Tensor, node: Node, params) -> torch.Tensor:
    """SimpleNN applies fused epilogues as separate steps but skips the
    folded post-activation affine; the calibration walk needs both, so
    the recorded ranges match what the compiled program feeds each
    quantized site."""
    if node.epilogue and node.epilogue != "linear":
        y = apply_activation(node.epilogue, y, node.epilogue_attrs)
    pa = node.epilogue_attrs.get("post_affine")
    if pa:
        y = y * params[pa[0]] + params[pa[1]]
    return y


def _calibrate(graph: Graph, batches: int, sites: List[Node] = ()
               ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, np.ndarray]]:
    """Seeded oracle walk over the current graph, on the CPU.  Returns
    per-tensor ``{"absmax", "p999"}`` stats over every batch, and the
    first batch's input of each of ``sites`` (what mixed-mode accuracy
    checks run on)."""
    from ..simple import SimpleNN

    sim = SimpleNN(graph, device="cpu")
    site_names = {n.name for n in sites}
    rng = np.random.default_rng(0)
    ranges: Dict[str, Dict[str, float]] = {}
    first_inputs: Dict[str, np.ndarray] = {}
    with torch.inference_mode():
        for bi in range(batches):
            env: Dict[str, torch.Tensor] = {
                name: torch.from_numpy(
                    rng.standard_normal((CALIBRATION_BATCH,) + spec.shape)
                    .astype(np.float32))
                for name, spec in graph.inputs.items()
            }
            for node in graph.toposort():
                y = sim._eval(node, env, CALIBRATION_BATCH)
                env[node.output] = _apply_manual_epilogue(y, node, sim.params)
                if bi == 0 and node.name in site_names:
                    first_inputs[node.name] = env[node.inputs[0]].numpy()
            for name, val in env.items():
                a = np.abs(val.numpy().astype(np.float32))
                r = ranges.setdefault(name, {"absmax": 0.0, "p999": 0.0})
                r["absmax"] = max(r["absmax"], float(a.max()) if a.size else 0.0)
                if a.size:
                    r["p999"] = max(r["p999"], float(np.percentile(a, 99.9)))
    return ranges, first_inputs


def _annotate_int8(node: Node, graph: Graph, ranges: Dict,
                   method: str) -> None:
    stat = ranges[node.inputs[0]]
    absmax = stat["p999"] if method == "percentile" else stat["absmax"]
    w = graph.params[node.params["kernel"]]
    scales = qmath.channel_scales(w, _kernel_out_axis(node))
    node.attrs["quant.mode"] = "int8"
    node.attrs["quant.method"] = method
    node.attrs["quant.x_scale"] = qmath.tensor_scale(absmax)
    # A tuple, matching the IR's attr convention (the container's JSON
    # round trip re-tuplifies lists, so tuples survive save/load as-is).
    node.attrs["quant.w_scale"] = tuple(round(float(s), 10) for s in scales)
    node.attrs["quant.zp"] = 0


def _static_site_mode(node: Node, mode: str) -> Optional[str]:
    """Which precision a site gets under a ``bf16``/``int8`` request.
    ``None`` = stay f32.  int8 conv sites stay f32 on every device (see
    the module note)."""
    if mode == "bf16":
        return "bf16"
    if mode == "int8":
        return None if node.op == "conv2d" else "int8"
    return None


# ---------------------------------------------------------------------------
# mixed mode: per-site measured precision
# ---------------------------------------------------------------------------
def _site_runner(node: Node, graph: Graph, cand: str, x: np.ndarray,
                 ranges: Dict, method: str, device="cpu"):
    """A callable and its arguments computing this site at precision
    ``cand`` on ``device``: the expressions the lowering runs (dense
    through the ``fused_matmul``/``fused_matmul_q8`` wrappers, conv
    through ATen), on the first calibration batch ``x``.  As in the
    reference, the epilogue is the activation alone."""
    from functools import partial

    from ..ops_common import conv2d_nhwc
    from ...kernels.fused_matmul.kernel import SplitCounters
    from ...kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8

    dev = torch.device(device)
    w_np = np.asarray(graph.params[node.params["kernel"]], dtype=np.float32)
    w = torch.from_numpy(w_np).to(dev)
    b = (torch.from_numpy(np.asarray(graph.params[node.params["bias"]],
                                     dtype=np.float32)).to(dev)
         if "bias" in node.params else None)
    fn = (node.epilogue
          if node.epilogue not in (None, "linear", "softmax") else None)
    xt = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    stat = ranges.get(node.inputs[0], {"absmax": 0.0, "p999": 0.0})
    absmax = stat["p999"] if method == "percentile" else stat["absmax"]
    if node.op == "dense":
        if cand == "int8":
            xs = qmath.tensor_scale(absmax)
            wq, deq = qmath.quantize_weight(
                w, xs, qmath.channel_scales(w_np, 1), "io")
            return (partial(fused_matmul_q8, x_scale=xs, fn=fn,
                            counters=SplitCounters()),
                    (xt, wq, deq, b))
        if cand == "bf16":
            run = partial(fused_matmul, fn=fn, counters=SplitCounters())
            return (lambda x, w, b: run(x.to(torch.bfloat16), w, b),
                    (xt, w.to(torch.bfloat16), b))
        return (partial(fused_matmul, fn=fn, counters=SplitCounters()),
                (xt, w, b))
    # conv2d: an OIHW kernel, as device_params lays it out.
    k = w.permute(3, 2, 0, 1).contiguous()
    conv = dict(strides=node.attrs["strides"], padding=node.attrs["padding"])
    if cand == "bf16":
        def run_bf16(x, k, b):
            y = qmath.conv2d_bf16(x, k, **conv)
            return y if b is None else y + b
        return run_bf16, (xt, k, b)
    if cand == "int8":
        xs = qmath.tensor_scale(absmax)
        ws = qmath.channel_scales(w_np, 3)

        def run_q8(x, k, b):
            y = qmath.conv2d_q8(x, k, xs, ws, **conv)
            return y if b is None else y + b
        return run_q8, (xt, k, b)
    return (lambda x, k, b: conv2d_nhwc(x, k, conv["strides"],
                                        conv["padding"], bias=b),
            (xt, k, b))


def site_desc(node: Node, graph: Graph, budget: float, method: str,
              device) -> dict:
    """The tactic-cache descriptor of one mixed-precision site: the
    reference's, with the device type where it has ``tpu``."""
    in_spec = graph.infer_shapes()[node.inputs[0]]
    return {"kind": "precision", "op": node.op,
            "in_shape": list(in_spec.shape), "in_dtype": in_spec.dtype,
            "kshape": list(graph.params[node.params["kernel"]].shape),
            "epilogue": node.epilogue or "",
            "has_bias": "bias" in node.params,
            "budget": budget, "method": method,
            "batch": CALIBRATION_BATCH, "device": torch.device(device).type}


def _tune_mixed(nodes: List[Node], graph: Graph, ranges: Dict,
                first_inputs: Dict, req: Dict,
                method: str) -> Tuple[Dict[str, str], Dict]:
    """Measured per-site precision: the candidates are f32 and every
    narrow dtype the prior allows; the winner is the fastest whose
    max_abs_err against the f32 site output on the first calibration
    batch is within the budget.  Winners persist in the tactic cache,
    keyed by the site's shapes, epilogue, budget and device."""
    from ...autotune.cache import (environment_fingerprint, open_tactic_cache,
                                   tactic_key)
    from ...autotune.measure import Deadline, bench_min_us

    budget = req.get("budget") or DEFAULT_PRECISION_BUDGET
    measure = req.get("measure", True)
    device = torch.device(req.get("device", "cpu"))
    deadline = Deadline(req.get("budget_ms", DEFAULT_MEASURE_BUDGET_MS)
                        if measure else 0.0)
    cache = open_tactic_cache(req.get("cache_dir"))
    fp = environment_fingerprint(device)

    decisions: Dict[str, str] = {}
    entries: Dict[str, dict] = {}
    sites: Dict[str, dict] = {}
    for node in nodes:
        cands = ["f32"] + [c for c in ("bf16", "int8")
                           if _static_site_mode(node, c) == c]
        desc = site_desc(node, graph, budget, method, device)
        key = tactic_key(desc, fp)
        entry = cache.load(key, fp) if cache is not None else None
        if entry is not None and entry["winner"] not in cands:
            entry = None
        source = "cached" if entry is not None else "prior"
        if entry is None and measure and not deadline.expired():
            x = first_inputs[node.name]
            measured, errs, failed = {}, {}, []
            want = None
            for cand in cands:
                if deadline.expired() and cand != "f32":
                    break
                try:
                    run, args = _site_runner(node, graph, cand, x, ranges,
                                             method, device)
                    with torch.inference_mode():
                        out = run(*args).float().cpu().numpy()
                except Exception:
                    failed.append(cand)
                    continue
                if cand == "f32":
                    want = out
                    errs[cand] = 0.0
                else:
                    errs[cand] = (float(np.abs(out - want).max())
                                  if want is not None else float("inf"))
                us = bench_min_us(run, args, reps=5, warmup=1,
                                  deadline=deadline)
                if us is not None:
                    measured[cand] = us
            ok = [c for c in measured
                  if errs.get(c, float("inf")) <= budget or c == "f32"]
            if ok:
                winner = min(ok, key=lambda c: measured[c])
                entry = {"winner": winner,
                         "measured_us": {k: round(v, 3)
                                         for k, v in measured.items()},
                         "max_abs_err": {k: round(v, 8)
                                         for k, v in errs.items()},
                         "failed": failed, "desc": desc, "fingerprint": fp}
                source = "measured"
                if cache is not None:
                    cache.store(key, entry)
        if entry is not None:
            decisions[node.name] = entry["winner"]
            entries[key] = entry
            sites[node.name] = {
                "winner": entry["winner"], "source": source,
                "measured_us": entry.get("measured_us", {}),
                "max_abs_err": entry.get("max_abs_err", {})}
        else:
            decisions[node.name] = "f32"   # no data: stay exact
            sites[node.name] = {"winner": "f32", "source": source}
    report = {"spent_ms": round(deadline.spent_ms(), 3), "budget": budget,
              "device": str(device), "entries": len(entries),
              "sites": sites}
    return decisions, report


# ---------------------------------------------------------------------------
@register_pass("quantize", after=("fuse_activation.post_bn",),
               before=("optimize_layout",))
def quantize(graph: Graph) -> Tuple[Graph, Dict]:
    """Annotate eligible sites with calibrated ``quant.*`` attrs per
    the request on ``graph.quant``; a no-op (zero annotations, ``quant``
    cleared) without a request or under ``mode="f32"``."""
    req = graph.quant
    if not req or req.get("mode") in (None, "f32"):
        if req:
            graph.quant = {"mode": "f32"}
        return graph, {"sites": 0}
    mode = req["mode"]
    if mode not in _MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; "
                         f"expected one of {_MODES}")
    method = req.get("method", "absmax")
    sites: List[Node] = [n for n in graph.nodes
                         if n.op in QUANT_OPS and "kernel" in n.params]

    counts = {"f32": 0, "bf16": 0, "int8": 0}
    stats: Dict[str, object] = {"sites": len(sites), "mode": mode}
    ranges: Dict = {}
    first_inputs: Dict[str, np.ndarray] = {}
    if mode in ("int8", "mixed") and sites:
        batches = int(req.get("calibrate") or DEFAULT_CALIBRATE)
        ranges, first_inputs = _calibrate(
            graph, batches, sites if mode == "mixed" else ())
        stats["calibrate_batches"] = batches
        stats["calibrated_tensors"] = len(ranges)

    if mode == "mixed" and sites:
        decisions, stats["mixed"] = _tune_mixed(
            sites, graph, ranges, first_inputs, req, method)
    else:
        decisions = {n.name: _static_site_mode(n, mode) or "f32"
                     for n in sites}

    for node in sites:
        site_mode = decisions[node.name]
        counts[site_mode] += 1
        if site_mode == "bf16":
            node.attrs["quant.mode"] = "bf16"
        elif site_mode == "int8":
            _annotate_int8(node, graph, ranges, method)
    stats.update(counts)
    # The surviving graph-level record is semantic only: the mode and
    # the per-mode site counts.  Request-side knobs (cache_dir, budgets,
    # device, measure) are consumed here and dropped.
    graph.quant = {"mode": mode, "decisions": dict(counts)}
    return graph, stats
