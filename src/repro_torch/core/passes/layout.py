"""Compile-time weight re-layout (paper §3.3, Eq. 3 — adapted to TPU).

The port keeps the JAX package's TPU granules here on purpose: with
the same LANE/SUBLANE the optimized graph is ``structure_hash``- and
param-identical to the reference's, which is what the parity tests
hold the port to.  The CUDA kernel reads both layouts and masks ragged
edges, so the padding costs it nothing but a few zero columns.

The paper's observation: "the elements of the matrix are parameters of
the neural network known at compile time, so the memory layout of the
matrix can be chosen arbitrarily without any impact on performance".  On
x86 it chooses a diagonal-rotated layout to save one XMM register and a
shuffle.  On TPU the register-file argument does not exist; the two
layout degrees of freedom that matter are

1. **Contraction-major storage** — for GEMV-shaped products (matrix ×
   single vector, the dominant op in both the paper's CNNs and LLM
   decode) the weight should be stored so the contraction dimension is
   minor-most, letting the kernel stream HBM contiguously instead of
   striding.  We store dense kernels as (cout, cin) ["oi"] when the
   expected activation rows are small, (cin, cout) ["io"] otherwise.

2. **MXU-aligned padding** — the systolic array processes 128×128
   tiles (8×128 for f32 sublanes); weights whose channel dims are not
   multiples of the tile get padded *once at compile time* instead of
   per-call.  The back end slices the output back to the logical size.

Both transformations are free at runtime precisely because of the
paper's insight: weights are constants, their layout is ours to choose.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..graph import Graph
from ...kernels.tiles import LANE, SUBLANE, ceil_to
from .manager import register_pass

#: Channel alignment for the MXU lane dimension.
LANE_ALIGN = LANE
#: Sublane alignment for f32.
SUBLANE_ALIGN = SUBLANE
#: Pad only if the relative overhead stays below this bound — padding a
#: 3-channel tensor to 128 would be a 42x blowup, which no sane compiler
#: does.  (CompiledNN similarly specializes per-dimension-case instead
#: of forcing one scheme.)
MAX_PAD_RATIO = 1.5

#: Tuning-site hook: the graph-level autotuner
#: (``repro.autotune.decisions``) sets this attr on a dense node to pin
#: the kernel storage layout to ``"oi"`` or ``"io"``, overriding the
#: row-count heuristic below.  Absent keeps the heuristic, so
#: ``autotune="off"`` is bit-identical.  An explicit user
#: ``kernel_layout`` attr still wins over both.
TUNE_LAYOUT_ATTR = "tune.layout"


_pad_to = ceil_to


@register_pass("optimize_layout", after=("fold_batchnorm",))
def optimize_layout(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    specs = g.infer_shapes()
    transposed = 0
    padded = 0
    for node in g.nodes:
        if node.op != "dense":
            continue
        k = g.params[node.params["kernel"]]
        cin, cout = k.shape
        in_spec = specs[node.inputs[0]]
        # Rows the matmul will see per example (product of non-channel dims).
        rows = max(1, in_spec.size // max(1, in_spec.shape[-1]))

        # 1. contraction-major storage for GEMV-shaped products.
        tuned = node.attrs.get(TUNE_LAYOUT_ATTR)
        want_oi = (tuned == "oi") if tuned in ("oi", "io") else (
            rows < SUBLANE_ALIGN)
        if want_oi and node.attrs.get("kernel_layout") is None:
            g.params[node.params["kernel"]] = np.ascontiguousarray(k.T)
            node.attrs["kernel_layout"] = "oi"
            transposed += 1
            k = g.params[node.params["kernel"]]
        else:
            node.attrs.setdefault("kernel_layout", "io")

        # 2. MXU-aligned output padding (compile-time, sliced by back end).
        pad_cout = _pad_to(cout, LANE_ALIGN)
        if pad_cout != cout and pad_cout / cout <= MAX_PAD_RATIO:
            if node.attrs["kernel_layout"] == "oi":
                knew = np.zeros((pad_cout, cin), np.float32)
                knew[:cout] = k
            else:
                knew = np.zeros((cin, pad_cout), np.float32)
                knew[:, :cout] = k
            g.params[node.params["kernel"]] = knew
            if "bias" in node.params:
                b = g.params[node.params["bias"]]
                bnew = np.zeros((pad_cout,), np.float32)
                bnew[:cout] = b
                g.params[node.params["bias"]] = bnew
            # A folded-BN affine epilogue rides on the same channel dim.
            pa = node.epilogue_attrs.get("post_affine")
            if pa:
                for pname in pa:
                    v = g.params[pname]
                    vnew = np.zeros((pad_cout,), np.float32)
                    vnew[: v.shape[0]] = v
                    g.params[pname] = vnew
            node.attrs["orig_cout"] = cout
            padded += 1
    g.rebuild_index()
    return g, {"transposed": transposed, "padded": padded}
