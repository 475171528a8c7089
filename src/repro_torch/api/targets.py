"""Target registry + the graph-IR targets.

A *target* is a named factory ``(graph, options) -> Executable``.  The
built-ins mirror the reference's cast:

    "interpret"  SimpleNN semantics — node-by-node eager oracle.
    "jit"        the optimized path: pass pipeline + generic ATen rules,
                 one prepared program per batch size.
    "cuda"       ``jit`` with the hand-written CUDA kernels (every int8
                 dense node through ``fused_matmul_q8``, every other dense
                 node through ``fused_matmul``; every ``decode_attention``
                 node through ``decode_attention``; every fast
                 exp/tanh/sigmoid through ``fast_act``) — the reference's
                 ``"pallas"`` twin.  It compiles for the CPU, where the kernels'
                 wrappers run their plain versions, or a Hopper card.

Every target converts the weights to tensors on ``options.device`` once,
when it is built, never per call.  New backends register with::

    @register_target("my-backend")
    def build(graph, options):
        return MyExecutable(graph, options)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.graph import Graph
from ..core.lowering import (LoweredGraph, LoweringContext, device_params,
                             quant_params, resolve_device)
from ..core.passes import run_pipeline
from ..core.selection import KernelChoice, check_kernel_device, select_kernels
from ..core.simple import SimpleNN
from .executable import Executable
from .options import QUANT_PRECISIONS, CompileOptions

def _quant_request(options: CompileOptions) -> Optional[dict]:
    """The quantization request a target rides on ``graph.quant`` for the
    quantize pass; None when ``options.precision`` does not quantize
    (``"f32"`` quantizes nothing).  The reference's budget, ``measure``
    flag and tactic cache serve ``"mixed"`` only, which is ROADMAP A.8."""
    if options.precision not in QUANT_PRECISIONS \
            or options.precision == "f32":
        return None
    req = {"mode": options.precision, "calibrate": options.calibrate}
    return {k: v for k, v in req.items() if v is not None}


TargetFactory = Callable[[Graph, CompileOptions], Executable]

_TARGETS: Dict[str, TargetFactory] = {}


def register_target(name: str) -> Callable[[TargetFactory], TargetFactory]:
    """Decorator: register a factory under ``name`` (overwrites)."""

    def deco(factory: TargetFactory) -> TargetFactory:
        _TARGETS[name] = factory
        return factory

    return deco


def get_target(name: str) -> TargetFactory:
    """Look up a registered target factory; KeyError lists what exists."""
    try:
        return _TARGETS[name]
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; available: {available_targets()}"
        ) from None


def available_targets() -> Tuple[str, ...]:
    """Sorted names of every registered compile target."""
    return tuple(sorted(_TARGETS))


# ---------------------------------------------------------------------------
class GraphExecutable(Executable):
    """Shared surface for graph-IR executables."""

    def __init__(self, graph: Graph, options: CompileOptions) -> None:
        self.source = graph
        self.options = options
        self.device = resolve_device(options.device)
        self.signature = graph.signature()
        self.compile_time: Optional[float] = None

    def _gather_inputs(self, pos, inputs) -> List[torch.Tensor]:
        """Bind positional-or-keyword call args against the signature;
        returns tensors on the device, ordered by the graph's inputs."""
        inputs = self.signature.bind(pos, inputs)
        missing = [n for n in self.source.inputs if n not in inputs]
        if missing:
            raise ValueError(f"missing inputs {missing}; expected "
                             f"{list(self.source.inputs)}")
        unknown = [k for k in inputs if k not in self.source.inputs]
        if unknown:
            raise TypeError(f"unexpected inputs {unknown}; expected "
                            f"{list(self.source.inputs)}")
        args = []
        for n, spec in self.source.inputs.items():
            a = torch.as_tensor(inputs[n], dtype=getattr(torch, spec.dtype),
                                device=self.device)
            if tuple(a.shape[1:]) != tuple(spec.shape):
                raise ValueError(
                    f"input {n!r}: expected (batch,)+{spec.shape}, "
                    f"got {tuple(a.shape)}")
            args.append(a)
        return args

    def _public_outputs(self, out) -> dict:
        """Re-key an output dict from graph tensor names to the
        signature's public output names."""
        return {pub: out[t]
                for pub, t in zip(self.source.output_names,
                                  self.source.outputs)}


@register_target("interpret")
class InterpretExecutable(GraphExecutable):
    """The oracle as an Executable: exact, unoptimized, eager."""

    def __init__(self, graph: Graph, options: CompileOptions) -> None:
        super().__init__(graph, options)
        t0 = time.perf_counter()
        # Low precision changes the semantics, so even the oracle honours
        # it: the quantize pass alone (no fusion or layout) on a copy.
        nn_graph = graph
        req = _quant_request(options)
        if req is not None:
            nn_graph = graph.copy()
            nn_graph.quant = req
            nn_graph, _ = run_pipeline(nn_graph, ("quantize",))
        self._nn = SimpleNN(nn_graph, device=self.device)
        self.compile_time = time.perf_counter() - t0

    def __call__(self, *pos, **inputs):
        args = self._gather_inputs(pos, inputs)
        return self._public_outputs(
            self._nn(**dict(zip(self.source.inputs, args))))

    def cost_summary(self):
        """Source-graph counts only — the interpreter runs no passes but
        the quantize pass, whose record it adds under low precision."""
        out = {
            "target": self.options.target,
            "device": str(self.device),
            "nodes": len(self.source.nodes),
            "params": len(self.source.params),
            "param_bytes": int(sum(v.nbytes
                                   for v in self.source.params.values())),
        }
        if self._nn.graph.quant:
            out["quant"] = dict(self._nn.graph.quant)
        return out


class JitExecutable(GraphExecutable):
    """Pass pipeline + one prepared program per batch size.

    ``lowering_target`` names the lowering-rule registry slice: ``"jit"``
    uses only the generic rules; ``"cuda"`` activates the CUDA kernels
    and records the static kernel selection for ``cost_summary``.
    """

    def __init__(self, graph: Graph, options: CompileOptions,
                 *, lowering_target: str = "jit") -> None:
        super().__init__(graph, options)
        self.lowering_target = lowering_target
        if lowering_target == "cuda":
            check_kernel_device(self.device)
        t0 = time.perf_counter()
        # The quantize request rides on a copy (self.source stays the
        # input graph); the pass leaves only the semantic record, the
        # mode and the quant.* node attrs, which structure_hash() reads.
        req = _quant_request(options)
        if req is not None:
            graph = graph.copy()
            graph.quant = req
        self.graph, self.report = run_pipeline(
            graph, options.passes, dump_ir=options.dump_ir)
        self.params = device_params(self.graph, self.device)
        self.params.update(quant_params(self.graph, self.params))
        self._programs: Dict[int, LoweredGraph] = {}
        self._selections: Dict[int, Dict[str, KernelChoice]] = {}
        self.compile_time = time.perf_counter() - t0

    def ensure_compiled(self, batch_size: int = 1) -> LoweredGraph:
        """The program specialized to ``batch_size`` (prepared once)."""
        prog = self._programs.get(batch_size)
        if prog is not None:
            return prog
        t0 = time.perf_counter()
        selection = select_kernels(
            self.graph, batch_size=batch_size, target=self.lowering_target)
        if selection:
            self._selections[batch_size] = selection
        ctx = LoweringContext(
            params=self.params, batch_size=batch_size,
            precision=self.options.precision, target=self.lowering_target)
        prog = self._programs[batch_size] = LoweredGraph(self.graph, ctx)
        self.compile_time += time.perf_counter() - t0
        return prog

    def __call__(self, *pos, **inputs):
        args = self._gather_inputs(pos, inputs)
        prog = self.ensure_compiled(args[0].shape[0])
        with torch.inference_mode():
            out = prog(dict(zip(self.graph.inputs, args)))
        # Passes may rename output tensors (e.g. a fused terminal
        # activation); the public contract keys outputs by the
        # signature's names, identically across targets.
        return {pub: out[opt] for pub, opt in
                zip(self.source.output_names, self.graph.outputs)}

    def cost_summary(self):
        """Compile-time facts: pass reports, memory plan and the
        per-batch kernel selections."""
        out = {
            "target": self.options.target,
            "device": str(self.device),
            "nodes": len(self.graph.nodes),
            "params": len(self.graph.params),
            "param_bytes": int(sum(v.nbytes
                                   for v in self.graph.params.values())),
            "pipeline": self.report.get("pipeline"),
            "passes": self.report["passes"],
            "memory_plan": self.report["memory_plan"],
        }
        if self._selections:
            out["kernel_selection"] = {
                batch: [c.to_dict() for c in sel.values()]
                for batch, sel in sorted(self._selections.items())
            }
        if self.graph.quant:
            # The quantize pass's record: the mode and per-mode site counts.
            out["quant"] = dict(self.graph.quant)
        return out


@register_target("jit")
def _build_jit(graph: Graph, options: CompileOptions) -> Executable:
    return JitExecutable(graph, options, lowering_target="jit")


@register_target("cuda")
def _build_cuda(graph: Graph, options: CompileOptions) -> Executable:
    return JitExecutable(graph, options, lowering_target="cuda")
