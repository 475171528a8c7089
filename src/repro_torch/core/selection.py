"""Shape-aware kernel selection for the ``cuda`` target.

The port of ``repro.core.selection``: per node and before anything runs,
record from the inferred shapes and the batch size how the ``cuda``
target's kernels take the graph.

* Every ``dense`` node runs a CUDA kernel: ``fused_matmul_q8`` for an
  int8 site (``quant.mode``), ``fused_matmul`` for every other (bf16
  sites with bf16 operands).  The kernels mask their loads, so they take
  every shape, and the ``cuda`` target has no other dense path.  The
  choice records the reference's facts: M/K/N, the block tile, its
  shared memory (and the int8 kernel's int32 accumulator, which lives in
  registers), and the tile padding waste (padded over logical MACs: the
  share of the block's threads that idle, not extra bytes moved).  They
  come from the plan the kernel runs (``kernels/fused_matmul/kernel.py``:
  ``plan`` for ``fused_matmul``, ``plan_q8`` for ``fused_matmul_q8``;
  GEMV or tiled path, K split, blocks).  The reference's off-TPU prior
  that hands int8 sites to ``lax.dot`` has no counterpart: the int8
  kernel is this target's only int8 dense path.
* Every ``decode_attention`` node runs the CUDA ``decode_attention``
  kernels, S split into chunks of 512-row tiles
  (``kernels/decode_attention/kernel.py::chunk_plan``).  The reference's
  lane gate (``D % 128``) has none either: the kernels take any D up to
  256 and G = H/Hkv up to 16, and the wrapper raises beyond.
* Under ``precision="fast"`` every fast exp/tanh/sigmoid runs in the
  ``fast_act`` kernel (:meth:`~repro_torch.core.lowering.LoweringContext.act`).
  The flat elementwise kernel takes any shape, so it needs no per-node
  decision, and the reference's lane-alignment gate has no counterpart.

The selection is what the lowering runs: ``LoweringContext.selection``
carries it, and the ``cuda`` dense and decode rules launch the plan a
choice names.  A heuristic choice names the committed plan (what the
wrappers compute from the shape); a measured one (``source=
"measured"``, from ``repro_torch.autotune``) may name a tactic of the
kernel's grid (``kernels/tiles.py``) in its ``tactic``, which
:func:`tactic_plan` lays out with the kernel's plan function.

The reference's ``_ON_TPU`` gates become :func:`check_kernel_device`:
the ``cuda`` target compiles for the CPU, where each kernel wrapper runs
its plain version, or for a Hopper card, and raises on any other CUDA
card rather than handing its nodes to ATen.

Decisions are :class:`KernelChoice` records with a human-readable
reason, surfaced through ``cost_summary()["kernel_selection"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .graph import Graph
from ..kernels.decode_attention.ref import DEFAULT_BS
from ..kernels.decode_attention.kernel import chunk_plan
from ..kernels.fused_matmul.kernel import plan as dense_plan
from ..kernels.fused_matmul.kernel import plan_q8
from ..kernels.tiles import TACTIC_PARAMS

#: The compute capability the kernels are built for (``sm_90a``).
HOPPER = (9, 0)


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One selector decision, as shown in ``cost_summary()``.

    ``source`` is ``"heuristic"`` (this module) or ``"measured"`` (the
    autotuner, ``repro_torch.autotune.tuner``).  ``block`` holds the
    facts of the plan the node runs (:func:`plan_block`): (rows, K
    split, columns) of a dense tile, (tile depth, tiles a chunk) of
    decode attention.  ``tactic`` is a measured choice's plan overrides,
    in the order of ``kernels.tiles.TACTIC_PARAMS[kernel]``, or None for
    the heuristic's plan.  ``measured_us`` holds every candidate's
    device µs of a measured choice."""

    node: str
    op: str
    kernel: str   # "cuda.fused_matmul", "cuda.fused_matmul_q8", ...
    reason: str
    source: str = "heuristic"
    block: Optional[Tuple[int, ...]] = None
    measured_us: Optional[Dict[str, float]] = None
    tactic: Optional[Tuple[int, ...]] = None

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "KernelChoice":
        """Invert :meth:`to_dict` through JSON (``block`` and ``tactic``
        come back lists)."""
        d = dict(d)
        for f in ("block", "tactic"):
            if d.get(f) is not None:
                d[f] = tuple(d[f])
        return cls(**d)


def tactic_plan(kernel: str, tactic: Optional[Tuple[int, ...]], *,
                m: int = 0, k: int = 0, n: int = 0, w_layout: str = "io",
                itemsize: int = 4, b: int = 0, hkv: int = 0, s: int = 0):
    """The plan ``kernel``'s plan function lays out with ``tactic``'s
    overrides (none for None: the heuristic's plan): a ``Plan`` for the
    dense kernels at (M, K, N), ``(tiles per chunk, chunks)`` for decode
    attention at (B, Hkv, S)."""
    kw = {}
    if tactic is not None:
        if len(tactic) != len(TACTIC_PARAMS.get(kernel, ())):
            raise ValueError(f"{kernel}{list(tactic)} is no tactic of the "
                             f"kernel grids")
        kw = dict(zip(TACTIC_PARAMS[kernel], (int(t) for t in tactic)))
    if kernel == "cuda.fused_matmul":
        return dense_plan(m, k, n, w_layout=w_layout, itemsize=itemsize,
                          **kw)
    if kernel == "cuda.fused_matmul_q8":
        if kw:
            kw["tile"] = (kw.pop("tile_m"), kw.pop("tile_n"))
        return plan_q8(m, k, n, w_layout=w_layout, **kw)
    if kernel == "cuda.decode_attention":
        return chunk_plan(b, hkv, s, **kw)
    raise KeyError(f"no plan function for kernel {kernel!r}")


def plan_block(kernel: str, plan) -> Tuple[int, ...]:
    """The facts of ``plan`` a :class:`KernelChoice` records as its
    ``block``."""
    if kernel == "cuda.decode_attention":
        return (DEFAULT_BS, plan[0])
    return (plan.block[0], plan.ksplit, plan.block[1])


def choice_plan(choice: Optional[KernelChoice], **shape):
    """The plan a measured choice's tactic names, laid out at ``shape``
    (the keywords of :func:`tactic_plan`); None when the choice names
    the heuristic's plan, which the wrappers compute from the shape."""
    if choice is None or choice.tactic is None:
        return None
    return tactic_plan(choice.kernel, choice.tactic, **shape)


def check_kernel_device(device) -> None:
    """Raise unless the CUDA kernels can run on ``device``: the CPU (the
    wrappers run their plain versions) or a Hopper card (the kernels are
    built for ``sm_90a`` only)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    cap = tuple(torch.cuda.get_device_capability(dev))
    if cap != HOPPER:
        raise RuntimeError(
            f"target='cuda' needs a Hopper card (compute capability "
            f"{HOPPER[0]}.{HOPPER[1]}): its kernels are built for sm_90a, "
            f"and {dev} has {cap[0]}.{cap[1]}; use target='jit' there")


def _select_dense(node, in_spec, batch_size: int, n: int) -> KernelChoice:
    rows = max(1, in_spec.size // max(1, in_spec.shape[-1]))
    m = batch_size * rows
    k = in_spec.shape[-1]
    qm = node.attrs.get("quant.mode")
    layout = node.attrs.get("kernel_layout", "io")
    if qm == "int8":
        p = plan_q8(m, k, n, w_layout=layout)
        mem = f"{p.smem_bytes / 1024:.1f} KiB SMEM, int32 sums in registers"
        kernel = "cuda.fused_matmul_q8"
    else:
        p = dense_plan(m, k, n, w_layout=layout,
                       itemsize=2 if qm == "bf16" else 4)
        mem = f"{p.smem_bytes / 1024:.1f} KiB SMEM"
        if qm == "bf16":
            mem += ", bf16 operands"
        kernel = "cuda.fused_matmul"
    return KernelChoice(
        node.name, "dense", kernel,
        f"M={m} K={k} N={n} {layout}: {p.describe()}, {mem}, "
        f"{p.pad_waste(m, k, n):.1f}x pad waste",
        block=plan_block(kernel, p))


def _select_decode_attention(node, q_spec, kv_spec,
                             batch_size: int) -> KernelChoice:
    h, d = q_spec.shape
    s, hkv, _ = kv_spec.shape
    tpc, nchunks = chunk_plan(batch_size, hkv, s)
    return KernelChoice(
        node.name, "decode_attention", "cuda.decode_attention",
        f"B={batch_size} H={h} Hkv={hkv} D={d} S={s}: S in {DEFAULT_BS}-row "
        f"tiles, {tpc} a chunk; {nchunks} chunks x {batch_size * hkv} "
        f"(batch, KV head) blocks, each with its {h // hkv} query heads, "
        f"score and p.V kernels, then a combine in chunk order",
        block=plan_block("cuda.decode_attention", (tpc, nchunks)))


def select_kernels(
    graph: Graph,
    *,
    batch_size: int,
    target: Optional[str],
) -> Dict[str, KernelChoice]:
    """The static selection for one (graph, batch_size, target)
    compilation.  Only ops with a kernel decision appear in the result;
    everything else lowers through its generic rule."""
    if target != "cuda":
        return {}
    specs = graph.infer_shapes()
    choices: Dict[str, KernelChoice] = {}
    for node in graph.nodes:
        if node.op == "dense":
            kshape = graph.params[node.params["kernel"]].shape
            cout = (kshape[0] if node.attrs.get("kernel_layout") == "oi"
                    else kshape[-1])
            n = int(node.attrs.get("orig_cout", cout))
            choices[node.name] = _select_dense(
                node, specs[node.inputs[0]], batch_size, n)
        elif node.op == "decode_attention":
            choices[node.name] = _select_decode_attention(
                node, specs[node.inputs[0]], specs[node.inputs[1]],
                batch_size)
    return choices
