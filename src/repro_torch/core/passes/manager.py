"""PassManager — the registry-driven pass pipeline driver.

The middle end used to be a hard-coded tuple of pass names; new passes
meant editing ``core/passes/__init__.py``.  Now passes self-register::

    @register_pass("fuse_widgets", after=("canonicalize",),
                   before=("optimize_layout",))
    def fuse_widgets(graph: Graph) -> Tuple[Graph, Dict]:
        ...

and :class:`PassManager` resolves the ordering constraints into a
pipeline (deterministically: Kahn's algorithm, registration order breaks
ties), runs it, and

* re-runs shape inference after **every** pass as a verifier — a pass
  that corrupts the graph (cycle, dangling tensor, changed output
  shapes) is rejected on the spot with the pass named, instead of
  surfacing as a cryptic trace error at lowering time;
* records per-pass wall time and node-count deltas in the compile
  report;
* optionally dumps the IR between passes (``CompileOptions.dump_ir`` or
  ``$REPRO_DUMP_IR`` — a directory receiving one ``NN-<pass>.txt``
  summary per stage, or ``-``/``stderr`` to stream to stderr).

A pass may be registered under several *instance* names (the default
pipeline runs ``fuse_activation`` twice, the second time as
``fuse_activation.post_bn``); the text before the first ``.`` is the
*base* name, which is what :meth:`PassManager.without` matches — so an
ablation removing ``fuse_activation`` removes every instance.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..graph import Graph
from .memory_plan import plan_memory

PassFn = Callable[[Graph], Tuple[Graph, Dict]]


class PassOrderingError(ValueError):
    """after=/before= constraints are unsatisfiable (a cycle)."""


class PassVerificationError(RuntimeError):
    """A pass produced a graph that fails shape inference or changed the
    model's output signature."""


@dataclasses.dataclass(frozen=True)
class PassSpec:
    name: str                     # instance name, e.g. "fuse_activation.post_bn"
    fn: PassFn
    after: Tuple[str, ...] = ()   # instance names this pass must follow
    before: Tuple[str, ...] = ()  # instance names this pass must precede

    @property
    def base(self) -> str:
        """Base name: instance name up to the first '.'."""
        return self.name.split(".", 1)[0]


#: Instance name -> spec, in registration order (dicts preserve it).
_REGISTRY: Dict[str, PassSpec] = {}


def register_pass(
    name: str,
    *,
    after: Sequence[str] = (),
    before: Sequence[str] = (),
) -> Callable[[PassFn], PassFn]:
    """Decorator: register a Graph -> (Graph, stats) pass under ``name``
    with ordering constraints.  Re-registering a name overwrites it (so
    a test can shadow a pass) but keeps its original position for
    tie-breaking."""

    def deco(fn: PassFn) -> PassFn:
        _REGISTRY[name] = PassSpec(
            name=name, fn=fn, after=tuple(after), before=tuple(before)
        )
        return fn

    return deco


def unregister_pass(name: str) -> None:
    """Remove a registered pass instance (tests clean up with this)."""
    _REGISTRY.pop(name, None)


def registered_passes() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_order(names: Optional[Iterable[str]] = None) -> Tuple[str, ...]:
    """Topologically order the given pass instances (default: the whole
    registry) under their after/before constraints.

    Deterministic: among ready passes, registration order wins.
    Constraints that name absent passes are ignored, so removing a pass
    never invalidates the rest of the pipeline.
    """
    if names is None:
        names = tuple(_REGISTRY)
    specs = [_REGISTRY[n] for n in names]
    present = {s.name for s in specs}
    edges: Dict[str, set] = {s.name: set() for s in specs}   # u -> {v}: u before v
    for s in specs:
        for dep in s.after:
            if dep in present:
                edges[dep].add(s.name)
        for succ in s.before:
            if succ in present:
                edges[s.name].add(succ)
    indeg = {s.name: 0 for s in specs}
    for u, vs in edges.items():
        for v in vs:
            indeg[v] += 1
    order: List[str] = []
    remaining = [s.name for s in specs]  # registration order
    while remaining:
        ready = [n for n in remaining if indeg[n] == 0]
        if not ready:
            raise PassOrderingError(
                f"pass ordering constraints form a cycle among {remaining}; "
                f"check the after=/before= declarations of these passes"
            )
        n = ready[0]
        remaining.remove(n)
        order.append(n)
        for v in edges[n]:
            indeg[v] -= 1
    return tuple(order)


def _lookup(name: str) -> PassSpec:
    """Resolve an explicit pipeline entry: exact instance name first,
    then the first registered instance of that base name (so legacy
    tuples like ``("canonicalize", "fuse_activation")`` keep working)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    for spec in _REGISTRY.values():
        if spec.base == name:
            return spec
    raise KeyError(
        f"unknown pass {name!r}; registered: {sorted(_REGISTRY)}"
    )


def _resolve_dump_ir(dump_ir) -> Tuple[str, ...]:
    """Normalize a dump_ir setting to a tuple of sinks.  Accepts None
    (fall back to ``$REPRO_DUMP_IR``), a single directory / ``-`` /
    ``stderr`` string, or a sequence of such sinks (capture bundles tee
    the IR dumps into the bundle alongside any user-requested sink)."""
    if dump_ir is None:
        dump_ir = os.environ.get("REPRO_DUMP_IR") or None
    if dump_ir is None:
        return ()
    if isinstance(dump_ir, str):
        return (dump_ir,)
    return tuple(dump_ir)


def pipeline_candidates() -> Dict[str, Tuple[str, ...]]:
    """Named whole-pipeline variants the graph-level autotuner may pick
    between (``repro_torch.autotune.decisions``, "pipeline" sites), as in
    the reference.

    Each variant is derived from the current default registry order by
    ``PassManager.without`` surgery, so a newly registered pass is part
    of every variant.  ``"default"`` is always present and always first.
    """
    default = PassManager.default()
    return {
        "default": default.pipeline,
        "no_fusion": default.without("fuse_activation").pipeline,
        "no_layout": default.without("optimize_layout").pipeline,
    }


class PassManager:
    """An ordered, verified pass pipeline.

    ``pipeline=None`` resolves the full registry under its constraints;
    an explicit sequence of names (instance or base, duplicates allowed)
    runs exactly those in exactly that order — this is what
    ``CompileOptions.passes`` feeds in.
    """

    def __init__(
        self,
        pipeline: Optional[Sequence[str]] = None,
        *,
        verify: bool = True,
        dump_ir: Optional[object] = None,  # str | Sequence[str] | None
    ) -> None:
        if pipeline is None:
            self._specs = [_REGISTRY[n] for n in resolve_order()]
        else:
            self._specs = [_lookup(n) for n in pipeline]
        self.verify = verify
        self.dump_ir = _resolve_dump_ir(dump_ir)

    # -- registry-style pipeline surgery (ablations, tests) ------------
    @classmethod
    def default(cls, **kw) -> "PassManager":
        return cls(None, **kw)

    @property
    def pipeline(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self._specs)

    def without(self, *names: str) -> "PassManager":
        """A new manager with every instance of the named passes removed
        (base-name match: ``without("fuse_activation")`` drops both the
        pre- and post-BN instances)."""
        drop = set(names)
        kept = [s.name for s in self._specs
                if s.name not in drop and s.base not in drop]
        return PassManager(kept, verify=self.verify, dump_ir=self.dump_ir)

    def with_pass(self, name: str, index: Optional[int] = None) -> "PassManager":
        """A new manager with registered pass ``name`` inserted (at
        ``index``, default: appended)."""
        names = list(self.pipeline)
        names.insert(len(names) if index is None else index, _lookup(name).name)
        return PassManager(names, verify=self.verify, dump_ir=self.dump_ir)

    # -- execution -----------------------------------------------------
    def _dump(self, stage: int, name: str, graph: Graph) -> None:
        if not self.dump_ir:
            return
        text = graph.summary()
        for sink in self.dump_ir:
            if sink in ("-", "stderr"):
                print(f"// IR after {stage:02d}-{name}\n{text}",
                      file=sys.stderr)
                continue
            os.makedirs(sink, exist_ok=True)
            path = os.path.join(sink, f"{stage:02d}-{name}.txt")
            with open(path, "w") as f:
                f.write(text + "\n")

    def _verify(self, name: str, graph: Graph, want_outputs) -> None:
        try:
            specs = graph.infer_shapes()   # also validates the toposort
        except Exception as e:
            raise PassVerificationError(
                f"pass {name!r} produced an invalid graph: {e}"
            ) from e
        got = [(specs[t].shape, specs[t].dtype) for t in graph.outputs]
        if got != want_outputs:
            raise PassVerificationError(
                f"pass {name!r} changed the model's output signature: "
                f"{want_outputs} -> {got}"
            )
        if getattr(graph, "dist", None):
            # Sharded compile: re-check the distribution annotations after
            # every pass, like shape inference; a pass that breaks a
            # collective's mesh axes or (after propagation) leaves a
            # tensor without a resolved spec is rejected, the pass named.
            from ...dist.propagate import ShardingError, check_shardings
            try:
                check_shardings(graph)
            except ShardingError as e:
                raise PassVerificationError(
                    f"pass {name!r} broke the sharding annotations: {e}"
                ) from e

    def run(self, graph: Graph) -> Tuple[Graph, Dict]:
        """Run the pipeline; returns (optimized graph, report).  The
        report carries the resolved pipeline, per-pass stats (wall time,
        node deltas, pass-specific counters) and the memory plan."""
        report: Dict = {"pipeline": self.pipeline, "passes": []}
        g = graph.copy()
        if self.verify:
            specs = g.infer_shapes()
            want_outputs = [(specs[t].shape, specs[t].dtype) for t in g.outputs]
        self._dump(0, "input", g)
        for stage, spec in enumerate(self._specs, start=1):
            before = len(g.nodes)
            t0 = time.perf_counter()
            g, stats = spec.fn(g)
            g.rebuild_index()
            dt = time.perf_counter() - t0
            if self.verify:
                self._verify(spec.name, g, want_outputs)
            self._dump(stage, spec.name, g)
            report["passes"].append({
                "pass": spec.name,
                "nodes_before": before,
                "nodes_after": len(g.nodes),
                "time_ms": dt * 1e3,
                **stats,
            })
        plan = plan_memory(g)
        report["memory_plan"] = plan.stats()
        report["plan"] = plan
        return g, report
