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
  static f32 weights); zero points are 0 (``quant.zp``).

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

``mode="mixed"`` (per-site measured selection through the autotuner's
deadline and tactic cache) is not ported: it raises, naming ROADMAP A.8.

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
#: The reference's accuracy budget for ``mode="mixed"`` (max_abs_err vs
#: the f32 outputs); kept as the limit low-precision outputs are held to.
DEFAULT_PRECISION_BUDGET = 0.05

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


def _calibrate(graph: Graph, batches: int) -> Dict[str, Dict[str, float]]:
    """Seeded oracle walk over the current graph, on the CPU.  Returns
    per-tensor ``{"absmax", "p999"}`` stats over every batch."""
    from ..simple import SimpleNN

    sim = SimpleNN(graph, device="cpu")
    rng = np.random.default_rng(0)
    ranges: Dict[str, Dict[str, float]] = {}
    with torch.inference_mode():
        for _ in range(batches):
            env: Dict[str, torch.Tensor] = {
                name: torch.from_numpy(
                    rng.standard_normal((CALIBRATION_BATCH,) + spec.shape)
                    .astype(np.float32))
                for name, spec in graph.inputs.items()
            }
            for node in graph.toposort():
                y = sim._eval(node, env, CALIBRATION_BATCH)
                env[node.output] = _apply_manual_epilogue(y, node, sim.params)
            for name, val in env.items():
                a = np.abs(val.numpy().astype(np.float32))
                r = ranges.setdefault(name, {"absmax": 0.0, "p999": 0.0})
                r["absmax"] = max(r["absmax"], float(a.max()) if a.size else 0.0)
                if a.size:
                    r["p999"] = max(r["p999"], float(np.percentile(a, 99.9)))
    return ranges


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
    if mode == "mixed":
        raise NotImplementedError(
            "quantization mode 'mixed' is not ported yet (ROADMAP A.8: "
            "autotune; its per-site choice is measured)")
    method = req.get("method", "absmax")
    sites: List[Node] = [n for n in graph.nodes
                         if n.op in QUANT_OPS and "kernel" in n.params]

    counts = {"f32": 0, "bf16": 0, "int8": 0}
    stats: Dict[str, object] = {"sites": len(sites), "mode": mode}
    ranges: Dict = {}
    if mode == "int8" and sites:
        batches = int(req.get("calibrate") or DEFAULT_CALIBRATE)
        ranges = _calibrate(graph, batches)
        stats["calibrate_batches"] = batches
        stats["calibrated_tensors"] = len(ranges)

    for node in sites:
        site_mode = _static_site_mode(node, mode) or "f32"
        counts[site_mode] += 1
        if site_mode == "bf16":
            node.attrs["quant.mode"] = "bf16"
        elif site_mode == "int8":
            _annotate_int8(node, graph, ranges, method)
    stats.update(counts)
    # The surviving graph-level record is semantic only: the mode and
    # the per-mode site counts.
    graph.quant = {"mode": mode, "decisions": dict(counts)}
    return graph, stats
