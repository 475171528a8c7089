"""Tactic enumeration: what the autotuner can choose between, per node.

The port of ``repro.autotune.tactics``.  A *tactic* is one concrete
implementation of a node: a kernel name (the selector's names,
``"cuda.fused_matmul"``, ...) and its plan's overrides, a point of the
kernel's grid (``kernels/tiles.py``), or none for the heuristic's plan
(:func:`enumerate_tactics`).  For
every node the selector has a choice for, :func:`candidates_for_node`
builds the descriptor the cache is keyed by and a list of runnable
candidates:

* ``dense``: B1 ``fused_matmul`` (f32, bf16 operands) or B2
  ``fused_matmul_q8`` (int8 sites, with their calibrated
  ``quant.x_scale`` and ``quant.w_scale``) at every point of its grid,
  the heuristic's plan first.  The reference also measures the generic
  ``lax.dot``; the port's generic dense rule is B1's and B2's plain
  version (``kernels/fused_matmul/ref.py``), which is never a candidate
  on the card, so it has none.
* ``decode_attention``: B4 at every chunk plan of its grid.  The
  reference's ``jnp`` candidate is B4's plain version, so it has none
  either.
* ``activation`` under ``fast``: B3 ``fast_act`` has no plan, so a node
  has one candidate and is not tuned (the tuner's report says so); the
  reference's ``jnp`` candidate is B3's plain version.

Candidates are measured on synthetic operands shaped exactly like the
node's, from ``numpy.random.default_rng(0)``, on the compile's device:
a tactic key measures the same problem in every process.  Every
candidate computes the same function; on the CPU each wrapper runs its
plain version, the same for every tactic.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.selection import plan_block, tactic_plan
from ..kernels import qmath
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.fused_matmul.kernel import SplitCounters
from ..kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8
from ..kernels.fast_act.ops import KERNEL_FNS
from ..kernels.tiles import (MAX_GRID_YZ, STATIC_SMEM_BYTES, TACTIC_GRIDS,
                             TACTIC_PARAMS)


@dataclasses.dataclass(frozen=True)
class Tactic:
    """One implementation choice: the kernel name, its plan overrides in
    the order of ``TACTIC_PARAMS[kernel]`` (None: the heuristic's plan),
    and the facts of the plan they lay out (``KernelChoice.block``)."""

    kernel: str
    params: Optional[Tuple[int, ...]] = None
    block: Optional[Tuple[int, ...]] = None

    @property
    def label(self) -> str:
        """Human-readable name, e.g. ``cuda.fused_matmul[64x128]``."""
        if self.params is None:
            return f"{self.kernel}[heuristic]"
        return f"{self.kernel}[{'x'.join(str(b) for b in self.params)}]"


def legal(p) -> bool:
    """A dense plan a launch takes: static shared memory within a block's
    48 KB and gridDim.y/z within their limit."""
    return p.smem_bytes <= STATIC_SMEM_BYTES and max(p.grid[1:]) <= MAX_GRID_YZ


def enumerate_tactics(kernel: str, **shape):
    """The tactics of ``kernel`` at one shape (the keywords of
    ``core.selection.tactic_plan``): ``[(params, plan), ...]``, the
    heuristic's plan first (params None), then every grid point of
    ``tiles.TACTIC_GRIDS[kernel]`` that lays out a legal plan no earlier
    one does.  It replaces the reference's ``tiles.enumerate_blocks``."""
    grid = TACTIC_GRIDS[kernel]
    tactics: List[Optional[Tuple[int, ...]]] = [None]
    for values in itertools.product(*grid.values()):
        kw = dict(zip(grid, values))
        if "tile" in kw:
            kw["tile_m"], kw["tile_n"] = kw.pop("tile")
        tactics.append(tuple(kw[p] for p in TACTIC_PARAMS[kernel]))
    out, seen = [], set()
    for params in tactics:
        p = tactic_plan(kernel, params, **shape)
        if p in seen or (kernel != "cuda.decode_attention" and not legal(p)):
            continue
        seen.add(p)
        out.append((params, p))
    return out


#: A runnable candidate: the tactic, a callable and its arguments.
Candidate = Tuple[Tactic, Callable, Sequence]


@dataclasses.dataclass(frozen=True)
class NodeTactics:
    """Everything the tuner needs for one node: the cache-key descriptor
    and a lazy candidate builder (operands are made only once the budget
    says the node is measured)."""

    desc: Dict
    make_candidates: Callable[[], List[Candidate]]


def _tensor(rng, shape, device, dtype=torch.float32) -> torch.Tensor:
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------
def _dense_tactics(node, graph, in_spec, batch_size: int, precision: str,
                   device: torch.device) -> NodeTactics:
    rows = max(1, in_spec.size // max(1, in_spec.shape[-1]))
    m = batch_size * rows
    kshape = graph.params[node.params["kernel"]].shape
    layout = node.attrs.get("kernel_layout", "io")
    # The physical problem the kernel runs (after the layout pass's
    # padding), not the logical one.
    k, n = (kshape[1], kshape[0]) if layout == "oi" else (kshape[0], kshape[-1])
    fn = node.epilogue if node.epilogue not in (None, "linear", "softmax") else None
    has_bias = "bias" in node.params
    has_affine = node.epilogue_attrs.get("post_affine") is not None
    fast = precision == "fast"
    # quant.* defines the site's numerics, so it joins the key (an int8
    # site never shares a winner with the f32 site of the same shape) and
    # picks the kernel.
    qm = node.attrs.get("quant.mode") or ""
    kernel = "cuda.fused_matmul_q8" if qm == "int8" else "cuda.fused_matmul"
    itemsize = 2 if qm == "bf16" else 4
    desc = {"op": "dense", "m": m, "k": k, "n": n, "dtype": in_spec.dtype,
            "batch": batch_size, "target": "cuda", "epilogue": fn or "",
            "has_bias": has_bias, "has_affine": has_affine,
            "w_layout": layout, "fast": fast, "quant": qm,
            "device": device.type}
    shape = dict(m=m, k=k, n=n, w_layout=layout)
    if qm != "int8":
        shape["itemsize"] = itemsize

    def make() -> List[Candidate]:
        rng = np.random.default_rng(0)
        x = _tensor(rng, (m, k), device)
        w = _tensor(rng, (n, k) if layout == "oi" else (k, n), device)
        b = _tensor(rng, (n,), device) if has_bias else None
        s = _tensor(rng, (n,), device) if has_affine else None
        o = _tensor(rng, (n,), device) if has_affine else None
        kw = dict(fn=fn, fast=fast, w_layout=layout,
                  attrs=node.epilogue_attrs, counters=SplitCounters())
        if qm == "int8":
            # The site's calibrated scales: the same clamps and the same
            # program the lowering runs.
            ws = np.asarray(node.attrs["quant.w_scale"], dtype=np.float32)
            ws = np.pad(ws, (0, n - ws.shape[0]), constant_values=1.0)
            xs = node.attrs["quant.x_scale"]
            wq, deq = qmath.quantize_weight(w, xs, ws, layout)
            run = functools.partial(fused_matmul_q8, x_scale=xs, **kw)
            args = (x, wq, deq, b, s, o)
        else:
            if qm == "bf16":
                x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            run = functools.partial(fused_matmul, **kw)
            args = (x, w, b, s, o)
        return [(Tactic(kernel, params, plan_block(kernel, plan)),
                 functools.partial(run, plan=plan), args)
                for params, plan in enumerate_tactics(kernel, **shape)]

    return NodeTactics(desc, make)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------
def _decode_attention_tactics(node, specs, batch_size: int, precision: str,
                              device: torch.device) -> NodeTactics:
    q_spec = specs[node.inputs[0]]
    kv_spec = specs[node.inputs[1]]
    h, d = q_spec.shape
    s, hkv, _ = kv_spec.shape
    fast = precision == "fast"
    scale = node.attrs.get("scale")
    desc = {"op": "decode_attention", "h": h, "d": d, "s": s, "hkv": hkv,
            "dtype": q_spec.dtype, "batch": batch_size, "target": "cuda",
            "fast": fast, "device": device.type}

    def make() -> List[Candidate]:
        rng = np.random.default_rng(0)
        q = _tensor(rng, (batch_size, h, d), device)
        kc = _tensor(rng, (batch_size, s, hkv, d), device)
        vc = _tensor(rng, (batch_size, s, hkv, d), device)
        lengths = torch.full((batch_size,), s, dtype=torch.int32,
                             device=device)
        kernel = "cuda.decode_attention"
        return [(Tactic(kernel, params, plan_block(kernel, plan)),
                 functools.partial(decode_attention, scale=scale, fast=fast,
                                   tiles_per_chunk=plan[0]),
                 (q, kc, vc, lengths))
                for params, plan in enumerate_tactics(
                    kernel, b=batch_size, hkv=hkv, s=s)]

    return NodeTactics(desc, make)


# ---------------------------------------------------------------------------
def untuned_reason(node, precision: str) -> Optional[str]:
    """Why a node the ``cuda`` target runs a kernel for has nothing to
    tune, or None: under ``fast`` a node whose activation runs in
    ``fast_act`` (an activation or softmax node, or an epilogue outside
    the dense kernel's, whose tanh/sigmoid B1 and B2 compute in place)
    has one candidate, as ``fast_act`` has no plan to tune and its plain
    version, the ``jit`` rule, is no candidate on the card."""
    if precision != "fast":
        return None
    fns = {node.epilogue if node.op != "dense" or node.epilogue == "softmax"
           else None}
    if node.op == "activation":
        fns.add(node.attrs.get("fn"))
    if node.op == "softmax":
        fns.add("softmax")
    if fns & set(KERNEL_FNS):
        return ("cuda.fast_act: one candidate (no plan to tune; its plain "
                "version is no candidate on the card)")
    return None


def candidates_for_node(node, graph, specs, *, batch_size: int,
                        precision: str, device) -> Optional[NodeTactics]:
    """The tunable candidate set of one node, or None when it has one
    implementation (nothing to measure)."""
    device = torch.device(device)
    if node.op == "dense":
        return _dense_tactics(node, graph, specs[node.inputs[0]], batch_size,
                              precision, device)
    if node.op == "decode_attention":
        return _decode_attention_tactics(node, specs, batch_size, precision,
                                         device)
    return None
