"""Target registry + the graph-IR targets.

A *target* is a named factory ``(graph, options) -> Executable``.  The
built-ins mirror the reference's cast:

    "interpret"  SimpleNN semantics — node-by-node eager oracle.
    "jit"        the optimized path: pass pipeline + generic ATen rules,
                 one program per batch size: on a CUDA device a captured
                 CUDA graph (``core/program.py``, the reference's AOT XLA
                 program's counterpart), on the CPU the eager walk.
    "cuda"       ``jit`` with the hand-written CUDA kernels (every int8
                 dense node through ``fused_matmul_q8``, every other dense
                 node through ``fused_matmul``; every ``decode_attention``
                 node through ``decode_attention``; every fast
                 exp/tanh/sigmoid through ``fast_act``) — the reference's
                 ``"pallas"`` twin.  It compiles for the CPU, where the kernels'
                 wrappers run their plain versions, or a Hopper card.

Every target converts the weights to tensors on ``options.device`` once,
when it is built, never per call.  ``jit`` and ``cuda`` look the pass
pipeline's output up in the persistent executable cache (``cache.py``)
before running it, and record a capture bundle (``capture.py``) when
``options.capture`` names one: then the pipeline always runs.  New
backends register with::

    @register_target("my-backend")
    def build(graph, options):
        return MyExecutable(graph, options)
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.graph import Graph
from ..core.lowering import (LoweredGraph, LoweringContext, _rule_token,
                             device_params, lowering_fingerprint,
                             quant_params, resolve_device)
from ..core.passes import PassManager, plan_memory, run_pipeline
from ..core.passes.manager import _resolve_dump_ir
from ..core.program import CapturedProgram, GraphPool
from ..core.selection import KernelChoice, check_kernel_device, select_kernels
from ..core.simple import SimpleNN
from ..frontends.container import load_model, save_model
from ..runtime.spans import span
from .cache import cache_key, open_cache
from .executable import Executable, pack
from .options import QUANT_PRECISIONS, CompileOptions

#: What one batch size runs: a captured graph on a CUDA device, the
#: eager walk on the CPU.
Program = Union[CapturedProgram, LoweredGraph]


def _quant_request(options: CompileOptions, *, measure: bool,
                   device: torch.device) -> Optional[dict]:
    """The quantization request a target rides on ``graph.quant`` for the
    quantize pass; None when ``options.precision`` does not quantize
    (``"f32"`` quantizes nothing).  ``measure`` gates ``"mixed"``'s
    measurement (the ``interpret`` target never measures, nor does
    ``autotune="cached"``: they take winners from the tactic cache), and
    ``device`` is where its site runners run: the compile's."""
    if options.precision not in QUANT_PRECISIONS \
            or options.precision == "f32":
        return None
    req = {"mode": options.precision,
           "calibrate": options.calibrate,
           "budget": options.precision_budget,
           "budget_ms": options.autotune_budget_ms,
           "cache_dir": options.cache_dir}
    req = {k: v for k, v in req.items() if v is not None}
    req["measure"] = measure and options.autotune != "cached"
    req["device"] = str(device)
    return req


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

    #: True when the programs are captured graphs (see JitExecutable).
    captures = False

    def _gather_inputs(self, pos, inputs) -> List[torch.Tensor]:
        """Bind positional-or-keyword call args against the signature;
        returns tensors on the device, ordered by the graph's inputs
        (when the programs are captured, an input given on the host
        stays there)."""
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
                                device=None if self.captures else self.device)
            if tuple(a.shape[1:]) != tuple(spec.shape):
                raise ValueError(
                    f"input {n!r}: expected (batch,)+{spec.shape}, "
                    f"got {tuple(a.shape)}")
            args.append(a)
        if len({a.shape[0] for a in args}) > 1:
            raise ValueError(
                "inputs disagree on the batch: " + ", ".join(
                    f"{n} {a.shape[0]}"
                    for n, a in zip(self.source.inputs, args)))
        return args

    def _public_outputs(self, out) -> dict:
        """Re-key an output dict from graph tensor names to the
        signature's public output names."""
        return {pub: out[t]
                for pub, t in zip(self.source.output_names,
                                  self.source.outputs)}

    def serialize(self) -> bytes:
        """Pack the source graph + options + signature into the portable
        artifact container (recompiled, not unpickled, on load)."""
        buf = io.BytesIO()
        save_model(self.source, buf)
        return pack("graph", self.options, buf.getvalue(),
                    extra={"signature": self.signature.to_dict()})

    def cache_info(self) -> dict:
        """Disk-cache counters; zeros for targets without one."""
        return {"dir": None, "hits": 0, "misses": 0}


@register_target("interpret")
class InterpretExecutable(GraphExecutable):
    """The oracle as an Executable: exact, unoptimized, eager."""

    def __init__(self, graph: Graph, options: CompileOptions) -> None:
        super().__init__(graph, options)
        t0 = time.perf_counter()
        # Low precision changes the semantics, so even the oracle honours
        # it: the quantize pass alone (no fusion or layout) on a copy.
        nn_graph = graph
        req = _quant_request(options, measure=False, device=self.device)
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


@functools.lru_cache(maxsize=None)
def _package_digest() -> str:
    """Digest of every module of the package (read once a process)."""
    package = Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for path in sorted(package.rglob("*.py")):
        h.update(str(path.relative_to(package)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _code_token(passes, lowering_target: str) -> str:
    """Digest of the code a cached entry depends on: every module of the
    package, the lowering rules effective under the target (rules
    registered from outside the package too) and the resolved pass
    pipeline's functions (custom passes too).  The reference keys on the
    optimized graph, which reflects all of these; the port looks its
    entry up before the pipeline runs, so it keys on their code."""
    h = hashlib.sha256(_package_digest().encode())
    h.update(lowering_fingerprint(lowering_target).encode())
    for spec in PassManager(passes, verify=False)._specs:
        h.update(f"{spec.name}/{_rule_token(spec.fn)}".encode())
    return h.hexdigest()


def _weights_digest(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        v = np.ascontiguousarray(params[k])
        h.update(k.encode())
        h.update(f"{v.shape}{v.dtype}".encode())
        h.update(v.tobytes())
    return h.hexdigest()


class JitExecutable(GraphExecutable):
    """Pass pipeline + one program per batch size, with the persistent
    on-disk executable cache.

    On a CUDA device each batch size's program is a
    :class:`~repro_torch.core.program.CapturedProgram`: the prepared
    :class:`LoweredGraph` captured once as a CUDA graph and replayed; a
    capture that fails raises.  On the CPU it is the eager
    :class:`LoweredGraph`, which is what the caller asked for.

    Every program of the executable captures into one
    :class:`~repro_torch.core.program.GraphPool` (memory, lock and the
    event that orders its replays, shared by its batch sizes), laid out
    largest batch first: a batch larger than every captured one captures
    the others again after it.

    ``lowering_target`` names the lowering-rule registry slice: ``"jit"``
    uses only the generic rules; ``"cuda"`` activates the CUDA kernels,
    each launching the plan its node's choice in the kernel selection
    names.  With ``autotune`` on, graph decisions (``tune.*`` attrs and
    the pass pipeline) are tuned on a copy of the source graph before the
    pipeline runs, and each batch size's selection is refined by the
    tactic tuner (``repro_torch.autotune``).

    With a capture directory (``CompileOptions.capture`` or
    ``$REPRO_TORCH_CAPTURE_DIR``; ``capture_path``) the compile is
    recorded into a bundle as it goes: the input graph and options at
    construction, the per-pass IR and the pipeline's report after the
    pipeline (which then always runs), and each batch size's selection
    and seeded outputs once its program is ready.
    """

    def __init__(self, graph: Graph, options: CompileOptions,
                 *, lowering_target: str = "jit") -> None:
        super().__init__(graph, options)
        self.lowering_target = lowering_target
        if lowering_target == "cuda":
            check_kernel_device(self.device)
        t0 = time.perf_counter()
        # Capture bundle (CompileOptions.capture or
        # $REPRO_TORCH_CAPTURE_DIR; api/capture.py, not a captured CUDA
        # graph): records the input graph now, then tees the IR dumps
        # and records the pipeline and each batch size.  capture_path is
        # the bundle's directory or None.
        from .capture import CaptureSession, resolve_capture_dir
        self.capture_path = resolve_capture_dir(options.capture, graph,
                                                lowering_target)
        self._capture = (CaptureSession(self.capture_path, graph, options,
                                        lowering_target=lowering_target,
                                        device=self.device)
                         if self.capture_path else None)
        # ensure_compiled may be entered from a BucketedExecutable's
        # background worker while the request path runs; one lock keeps
        # the programs, the disk counters and compile_time coherent.
        self._compile_lock = threading.RLock()
        self._programs: Dict[int, Program] = {}
        self._selections: Dict[int, Dict[str, KernelChoice]] = {}
        self._autotune_reports: Dict[int, dict] = {}
        self._pool: Optional[GraphPool] = None
        self._disk = open_cache(options.cache_dir)
        self._disk_hits: Dict[object, bool] = {}
        self._graph_key: Optional[str] = None
        # Graph decisions (repro_torch.autotune.decisions): the winners
        # land as tune.* attrs on a copy (self.source stays the input
        # graph) and may swap the pass pipeline.  With autotune="off"
        # nothing runs and the pipeline is the heuristic compiler's.
        self._decisions_report: Optional[dict] = None
        self._decided, self._passes = graph, options.passes
        if options.autotune != "off":
            from ..autotune import open_tactic_cache, tune_graph_decisions
            self._decided, self._passes, self._decisions_report = (
                tune_graph_decisions(
                    graph, target=lowering_target,
                    precision=options.precision, passes=options.passes,
                    mode=options.autotune,
                    budget_ms=options.autotune_budget_ms,
                    cache=open_tactic_cache(options.cache_dir),
                    device=self.device))
        # A mixed compile's pipeline output depends on the winners in the
        # tactic cache, which a key made before the pipeline runs cannot
        # see: it keeps no graph entry (its tactic cache spares it the
        # measurement, and the calibration walk runs again).
        self._graph_disk = (self._disk if options.precision != "mixed"
                            else None)
        # A capture records the pipeline's IR dumps and report, so it
        # runs the pipeline and reads no graph entry (it still stores one).
        loaded = (self._load_graph()
                  if self._graph_disk is not None and self._capture is None
                  else None)
        if loaded is not None:
            self.graph, self.report = loaded
        else:
            # The quantize request rides on a copy (self.source stays the
            # input graph); the pass leaves only the semantic record, the
            # mode and the quant.* node attrs, which structure_hash() reads.
            graph = self._decided
            req = _quant_request(options, measure=True, device=self.device)
            if req is not None:
                graph = graph.copy()
                graph.quant = req
            dump_ir = options.dump_ir
            if self._capture is not None:
                # Tee the per-pass IR into the bundle beside any sink the
                # caller asked for ($REPRO_DUMP_IR included).
                dump_ir = _resolve_dump_ir(dump_ir) + (self._capture.ir_dir,)
            self.graph, self.report = run_pipeline(
                graph, self._passes, dump_ir=dump_ir)
            if self._capture is not None:
                self._capture.record_pipeline(self.report,
                                              self._decisions_report)
            if self._graph_disk is not None:
                self._store_graph()
        self.params = device_params(self.graph, self.device)
        self.params.update(quant_params(self.graph, self.params))
        self.compile_time = time.perf_counter() - t0

    # -- the executable cache ------------------------------------------
    def _source_key(self) -> str:
        """Key of the graph entry: what the pass pipeline's output is a
        function of, known before it runs: the graph after the graph
        decisions (their tune.* attrs), the weights, the options, and the
        code of the pipeline the decisions chose."""
        if self._graph_key is None:
            self._graph_key = cache_key(
                self.device, "graph", self._decided.structure_hash(),
                _weights_digest(self.source.params),
                self.options.cache_token(),
                f"sig={self.signature.cache_token()}",
                f"code={_code_token(self._passes, self.lowering_target)}")
        return self._graph_key

    def _load_graph(self):
        entry = self._disk.load(self._source_key())
        graph = None
        if entry is not None:
            meta, body = entry
            try:
                graph = load_model(io.BytesIO(body))
                graph.dist = meta.get("dist")
                report = dict(meta["report"], plan=plan_memory(graph))
            except Exception:
                graph = None     # unreadable: compile as if it missed
        self._disk_hits["graph"] = graph is not None
        return None if graph is None else (graph, report)

    def _store_graph(self) -> None:
        buf = io.BytesIO()
        try:
            save_model(self.graph, buf)
        except (TypeError, ValueError):
            return               # not containerisable: stay uncached
        report = {k: v for k, v in self.report.items() if k != "plan"}
        meta = {"kind": "graph", "report": report}
        if self.graph.dist:
            # The container keeps no placement: a sharded graph's specs
            # and edit log ride in the entry's JSON line.
            meta["dist"] = self.graph.dist
        self._disk.store(self._source_key(), meta, buf.getvalue())

    @staticmethod
    def _selection_token(selection: Dict[str, KernelChoice]) -> str:
        """Digest of the resolved kernel selection (kernel, block and
        tactic per node), as the reference's: two compiles that resolve
        to the same kernels share a program entry, and a new winner
        misses."""
        payload = json.dumps(
            sorted((name, c.kernel, c.source,
                    list(c.block) if c.block else None,
                    list(c.tactic) if c.tactic else None)
                   for name, c in selection.items()))
        return hashlib.sha256(payload.encode()).hexdigest()

    def _program_key(self, batch_size: int,
                     selection: Dict[str, KernelChoice]) -> str:
        return cache_key(self.device, "program", self._source_key(),
                         f"batch={batch_size}",
                         f"sel={self._selection_token(selection)}")

    def disk_key(self, batch_size: int) -> str:
        """The executable-cache key of this batch size's program entry,
        as the selection resolves today (in ``"full"`` mode from cached
        tactics only: a probe never measures)."""
        selection, _ = self._tune(batch_size, probe=True)
        return self._program_key(batch_size, selection)

    def has_disk_entry(self, batch_size: int) -> bool:
        """True if the executable cache holds this batch size's program
        entry (its graph entry is looked up at construction)."""
        return self._disk is not None and self._disk.has(
            self.disk_key(batch_size))

    def _tune(self, batch_size: int, *, probe: bool = False):
        """The selector's choices for one batch size, refined by the
        tactic tuner when autotune is on; ``probe`` downgrades ``"full"``
        to ``"cached"``.  Returns ``(selection, report)``."""
        selection = select_kernels(
            self.graph, batch_size=batch_size, target=self.lowering_target)
        if self.lowering_target != "cuda" or self.options.autotune == "off":
            return selection, None
        from ..autotune import open_tactic_cache, tune_selection
        mode = ("cached" if probe and self.options.autotune == "full"
                else self.options.autotune)
        # The graph decisions spent part of the budget at construction;
        # the kernel tactics get the rest.
        budget = self.options.autotune_budget_ms
        if budget is not None and self._decisions_report is not None:
            budget = max(0.0, budget - self._decisions_report["spent_ms"])
        return tune_selection(
            self.graph, selection, batch_size=batch_size,
            precision=self.options.precision, mode=mode, budget_ms=budget,
            cache=open_tactic_cache(self.options.cache_dir),
            device=self.device)

    def _resolve_selection(self, batch_size: int) -> Dict[str, KernelChoice]:
        """The kernel selection for one batch size, from the selector and
        the tuner; its program entry (keyed by the selection) is then
        looked up, or stored."""
        selection, report = self._tune(batch_size)
        if report is not None:
            self._autotune_reports[batch_size] = report
        if self._disk is not None:
            key = self._program_key(batch_size, selection)
            entry = self._disk.load(key)
            hit = False
            if entry is not None:
                try:
                    stored = {c["node"]: KernelChoice.from_dict(c)
                              for c in entry[0]["selection"]}
                    hit = (self._selection_token(stored)
                           == self._selection_token(selection))
                    selection = stored if hit else selection
                except (KeyError, TypeError):
                    hit = False
            self._disk_hits[batch_size] = hit
            if not hit:
                self._disk.store(key, {
                    "kind": "program", "batch": batch_size,
                    "selection": [c.to_dict() for c in selection.values()]})
        return selection

    # -- compilation ---------------------------------------------------
    def ensure_compiled(self, batch_size: int = 1) -> Program:
        """The program specialized to ``batch_size`` (prepared, and on a
        CUDA device captured, once); called with a dict of input tensors
        by graph input name."""
        prog = self._programs.get(batch_size)
        if prog is not None:
            return prog
        with self._compile_lock:
            prog = self._programs.get(batch_size)
            if prog is not None:
                return prog
            t0 = time.perf_counter()
            selection = self._resolve_selection(batch_size)
            if selection:
                self._selections[batch_size] = selection
            ctx = LoweringContext(
                params=self.params, batch_size=batch_size,
                precision=self.options.precision,
                target=self.lowering_target, selection=selection,
                **self._lowering_extras())
            prog = LoweredGraph(self.graph, ctx)
            if self.captures:
                if self._pool is None:
                    self._pool = GraphPool(self.device)
                prog = self._pool.admit(prog, {
                    n: (spec.shape, getattr(torch, spec.dtype))
                    for n, spec in self.graph.inputs.items()},
                    list(self._programs.values()))
            self._programs[batch_size] = prog
            if self._capture is not None:
                self._record(batch_size, prog, selection)
            # Seconds spent compiling: the pipeline (or its cache hit)
            # once, plus every batch size's selection and capture.
            self.compile_time += time.perf_counter() - t0
            return prog

    def _lowering_extras(self) -> dict:
        """Extra :class:`LoweringContext` fields (the mesh and shardings
        of a sharded compile); the unsharded base adds nothing."""
        return {}

    def _record(self, batch_size: int, prog: Program,
                selection: Dict[str, KernelChoice]) -> None:
        """Record one batch size into the capture bundle: its selection,
        its autotune report, and the seeded inputs through the program
        just prepared (on a CUDA device, a replay of its captured graph),
        the outputs copied to the host.  On the card this waits on the
        calling stream only, never on the device: a device-wide
        synchronise would fail a capture under way on another thread
        (``core/program.py``).  A program captured again later (a pool
        relayout) is not recorded again."""
        from .capture import seeded_inputs
        t0 = time.perf_counter()
        ins = seeded_inputs(self.graph, batch_size)
        args = [torch.as_tensor(ins[n],
                                device=None if self.captures else self.device)
                for n in self.graph.inputs]
        out = self._run(prog, args, batch_size)
        outs = {k: v.cpu().numpy() for k, v in out.items()}
        self._capture.record_batch(
            batch_size, selection, self._autotune_reports.get(batch_size),
            ins, outs)
        self._capture.seconds[batch_size] = time.perf_counter() - t0

    def input_buffers(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The static input tensors of the program captured for
        ``batch_size``, by input name.  A call given one of them as that
        input copies nothing: write a large input (a KV cache) there
        once and pass it on every call."""
        prog = self.ensure_compiled(batch_size)
        if not isinstance(prog, CapturedProgram):
            raise ValueError("static input tensors belong to programs "
                             "captured on a CUDA device; this executable "
                             f"runs on {self.device}")
        return dict(prog.static_inputs)

    # -- execution -----------------------------------------------------
    def _pick_bucket(self, batch: int) -> int:
        for b in self.options.batch_buckets:
            if b >= batch:
                return b
        return batch

    @property
    def captures(self) -> bool:
        """True when the programs are captured graphs (a CUDA device).
        A call then leaves an input given on the host there: the program
        copies it straight into its static input, so the call allocates
        no device tensor for it (one would share the caching allocator's
        segments with the static inputs, which outlive it, and keep
        them from being returned)."""
        return self.device.type == "cuda"

    def _run(self, prog: Program, args: List[torch.Tensor],
             bucket: int) -> Dict[str, torch.Tensor]:
        """Run the ``bucket``-batch program on ``args`` (batch <= bucket):
        padded with zero rows and the outputs cut back, keyed by the
        graph's output names."""
        batch = args[0].shape[0]
        env = dict(zip(self.graph.inputs, args))
        with torch.inference_mode():
            if isinstance(prog, CapturedProgram):
                return prog(env, rows=batch)
            if bucket != batch:
                env = {n: torch.cat([a, a.new_zeros((bucket - batch,)
                                                    + a.shape[1:])])
                       for n, a in env.items()}
            out = prog(env)
        if bucket != batch:
            out = {k: v[:batch] for k, v in out.items()}
        return out

    def __call__(self, *pos, **inputs):
        with span("call"):
            args = self._gather_inputs(pos, inputs)
            bucket = self._pick_bucket(args[0].shape[0])
            out = self._run(self.ensure_compiled(bucket), args, bucket)
            # Passes may rename output tensors (e.g. a fused terminal
            # activation); the public contract keys outputs by the
            # signature's names, identically across targets.
            return {pub: out[opt] for pub, opt in
                    zip(self.source.output_names, self.graph.outputs)}

    # -- introspection -------------------------------------------------
    def cache_info(self) -> dict:
        """Executable-cache counters (zeros when the disk cache is off),
        and what each lookup found: ``graph`` (the pipeline's output)
        and ``programs`` by batch size, ``"hit"`` or ``"miss"``."""
        if self._disk is None:
            return super().cache_info()
        word = lambda hit: "hit" if hit else "miss"
        return dict(self._disk.stats(),
                    graph=word(self._disk_hits.get("graph")),
                    programs={b: word(h) for b, h in self._disk_hits.items()
                              if b != "graph"})

    def cost_summary(self):
        """Compile-time facts: pass reports, memory plan, the per-batch
        kernel selections and programs (captured or eager; capture time),
        the executable's graph pool bytes (once: every program captures
        into it), and when tuned the autotune and graph-decision reports
        (without the raw cache entries)."""
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
        if self._autotune_reports:
            out["autotune"] = {
                batch: {k: v for k, v in rep.items() if k != "entries"}
                for batch, rep in sorted(self._autotune_reports.items())}
        if self._decisions_report is not None:
            out["graph_decisions"] = {
                k: v for k, v in self._decisions_report.items()
                if k != "entries"}
        programs = {}
        for batch, prog in sorted(self._programs.items()):
            if isinstance(prog, CapturedProgram):
                programs[batch] = {
                    "captured": True, "capture_ms": prog.capture_s * 1e3}
            else:
                programs[batch] = {"captured": False}
        if programs:
            out["programs"] = programs
        if self._pool is not None:
            # What the captures added to memory_reserved: the one pool.
            out["graph_pool_bytes"] = self._pool.bytes
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
