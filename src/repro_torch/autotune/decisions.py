"""Graph-level decision tuning — measure what the *passes* guess.

The port of ``repro.autotune.decisions``.  The kernel tuner measures
per-node lowering choices; this module applies the same
measure-once-remember-forever machinery to the decisions the pass
pipeline makes structurally:

* **fusion** — ``fuse_activation`` fuses every legal producer→activation
  pair.  Choices: ``"fuse"`` / ``"no_fuse"`` (``tune.fuse``).
* **layout** — ``optimize_layout`` picks the dense kernel's storage
  layout from a row-count heuristic.  Choices: ``"io"`` / ``"oi"``
  (``tune.layout``).
* **pipeline** — whole-pipeline variants from
  :func:`repro_torch.core.passes.manager.pipeline_candidates`, measured
  on the fully lowered graph.

Each site is keyed by a **graph-region digest**, a canonical hash of the
region's structure, shapes and dtypes that ignores node names and
insertion order.  Its canonicalization is the reference's, byte for
byte, so the port's digest of a region equals the reference's digest of
the same region.  Winners persist in the same fingerprinted
:class:`~repro_torch.autotune.cache.TacticCache` the kernel tuner uses;
``CompileOptions(autotune="cached")`` replays every decision in another
process without measuring.

On the card a candidate is measured as a *captured* program of its
region (device time of a replay, ``measure.replay_min_us``), never as
an eager walk, whose time is the host's; on the CPU as the eager walk.
Decisions are applied through the passes' hooks (``tune.fuse`` /
``tune.layout`` attrs); with ``autotune="off"`` no attr is written and
the pipeline is the heuristic compiler's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Graph, ACTIVATIONS
from ..core.passes.fuse_activation import FUSABLE_PRODUCERS, TUNE_FUSE_ATTR
from ..core.passes.layout import TUNE_LAYOUT_ATTR
from ..core.passes.manager import PassManager, pipeline_candidates
from ..core.selection import select_kernels
from .cache import TacticCache, environment_fingerprint, tactic_key
from .measure import Deadline, bench_min_us, replay_min_us
from .tuner import MEASURE_REPS, MEASURE_WARMUP

#: Bump when the digest canonicalization or the decision semantics
#: change — old cache entries must miss, not replay a stale meaning.
GRAPH_DECISION_VERSION = 1

#: Fraction of ``autotune_budget_ms`` graph-level tuning may spend;
#: the remainder is reserved for the per-node kernel tuner so a slow
#: pipeline-variant measurement can never starve kernel tactics.
GRAPH_BUDGET_FRACTION = 0.5


# ---------------------------------------------------------------------------
# region digest
# ---------------------------------------------------------------------------
def _node_struct_hash(node, graph: Graph, specs, internal: Dict[str, str]
                      ) -> str:
    """Canonical hash of one node: op, attrs (minus ``tune.*``), param
    roles with shapes/dtypes, epilogue, and inputs identified either by
    the producing region-node's hash (internal) or by shape+dtype
    (external) — never by tensor or node *name*."""
    ins = []
    for t in node.inputs:
        if t in internal:
            ins.append(["ref", internal[t]])
        else:
            s = specs[t]
            ins.append(["ext", list(s.shape), s.dtype])
    attrs = {k: v for k, v in sorted(node.attrs.items())
             if not k.startswith("tune.")}
    params = sorted(
        (role, list(graph.params[p].shape), str(graph.params[p].dtype))
        for role, p in node.params.items())
    payload = json.dumps(
        [node.op, attrs, params, node.epilogue,
         dict(sorted(node.epilogue_attrs.items())), ins],
        sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


def region_digest(graph: Graph, node_names: Sequence[str]) -> str:
    """Digest of the subgraph induced by ``node_names``.

    Invariant to node/tensor naming and to node insertion order (each
    node hashes to a pure function of its content and its region-internal
    producers' hashes; the digest is over the *sorted* hash set), but
    sensitive to any structure, shape or dtype edit — exactly the
    identity a transferred tuning decision is valid for.
    """
    names = set(node_names)
    region = [n for n in graph.toposort() if n.name in names]
    if len(region) != len(names):
        missing = names - {n.name for n in region}
        raise KeyError(f"region names not in graph: {sorted(missing)}")
    specs = graph.infer_shapes()
    internal: Dict[str, str] = {}
    hashes: List[str] = []
    for node in region:
        h = _node_struct_hash(node, graph, specs, internal)
        internal[node.output] = h
        hashes.append(h)
    payload = json.dumps([f"v{GRAPH_DECISION_VERSION}", sorted(hashes)])
    return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# tuning sites
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DecisionSite:
    """One graph-level tuning site: the decision kind, the node carrying
    the decision attr (``""`` for the whole-graph pipeline site), the
    region it is keyed by, and the candidate choice labels."""

    kind: str                     # "fusion" | "layout" | "pipeline"
    node: str
    region: Tuple[str, ...]
    digest: str
    choices: Tuple[str, ...]


def enumerate_sites(graph: Graph, *, passes: Optional[Sequence[str]] = None
                    ) -> List[DecisionSite]:
    """The tunable graph-level decisions of ``graph``, cheapest first.

    Fusion sites mirror ``fuse_activation``'s legality conditions on
    the *input* graph (direct producer→activation adjacency, single
    consumer); layout sites are every dense node; the single pipeline
    site is only emitted when the caller did not pin an explicit pass
    list (an explicit ``CompileOptions.passes`` is a user decision, not
    a tunable one).
    """
    sites: List[DecisionSite] = []
    for node in graph.nodes:
        if node.op == "dense":
            sites.append(DecisionSite(
                "layout", node.name, (node.name,),
                region_digest(graph, (node.name,)), ("io", "oi")))
    for act in graph.nodes:
        if act.op != "activation" or not ACTIVATIONS.get(
                act.attrs.get("fn"), False):
            continue
        src = graph.producer(act.inputs[0])
        if src is None or src.op not in FUSABLE_PRODUCERS:
            continue
        if src.epilogue not in (None, "linear"):
            continue
        if len(graph.consumers(src.output)) != 1:
            continue
        region = (src.name, act.name)
        sites.append(DecisionSite(
            "fusion", act.name, region,
            region_digest(graph, region), ("fuse", "no_fuse")))
    if passes is None and len(graph.nodes) > 1:
        variants = pipeline_candidates()
        sites.append(DecisionSite(
            "pipeline", "", tuple(n.name for n in graph.nodes),
            region_digest(graph, [n.name for n in graph.nodes]),
            tuple(variants)))
    return sites


def extract_region(graph: Graph, node_names: Sequence[str]) -> Graph:
    """A standalone mini-graph of just the named nodes: external inputs
    become graph inputs (shape+dtype from inference), referenced params
    are copied, and every region output not consumed inside the region
    becomes a graph output.  This is what decision candidates are
    measured on — the region's real shapes, isolated from the rest of
    the model."""
    names = set(node_names)
    region = [n for n in graph.toposort() if n.name in names]
    specs = graph.infer_shapes()
    produced = {n.output for n in region}
    mini = Graph()
    for node in region:
        for t in node.inputs:
            if t not in produced and t not in mini.inputs:
                mini.add_input(t, specs[t].shape, specs[t].dtype)
    for node in region:
        for p in node.params.values():
            if p not in mini.params:
                mini.add_param(p, graph.params[p])
        mini.add_node(node.op, node.name, list(node.inputs),
                      output=node.output, attrs=dict(node.attrs),
                      params=dict(node.params))
    consumed = {t for n in region for t in n.inputs}
    outs = [n.output for n in region if n.output not in consumed]
    mini.set_outputs(outs or [region[-1].output])
    return mini


# ---------------------------------------------------------------------------
# applying decisions
# ---------------------------------------------------------------------------
def apply_choice(graph: Graph, site: DecisionSite, choice: str) -> None:
    """Write the decision attr the pass hooks read.  Pipeline choices
    are not attrs (the caller swaps the pass list instead)."""
    if site.kind == "pipeline":
        return
    node = next(n for n in graph.nodes if n.name == site.node)
    if site.kind == "fusion":
        node.attrs[TUNE_FUSE_ATTR] = (choice == "fuse")
    elif site.kind == "layout":
        node.attrs[TUNE_LAYOUT_ATTR] = choice
    else:
        raise ValueError(f"unknown decision kind {site.kind!r}")


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def _probe_us(graph: Graph, pipeline, *, target: str, precision: str,
              batch_size: int, device: torch.device,
              deadline: Deadline) -> Optional[float]:
    """µs of ``graph`` through ``pipeline`` and the real selection and
    lowering, on seeded inputs: on the card the device time of a replay
    of its captured program (the program the decision will produce in
    the executable), on the CPU the eager walk's host time.  Raises if
    the candidate does not build or capture; None past the deadline."""
    from ..core.lowering import (LoweredGraph, LoweringContext,
                                 device_params, quant_params)
    from ..core.program import CapturedProgram

    g2, _ = PassManager(pipeline).run(graph)
    selection = select_kernels(g2, batch_size=batch_size, target=target)
    params = device_params(g2, device)
    params.update(quant_params(g2, params))
    prog = LoweredGraph(g2, LoweringContext(
        params=params, batch_size=batch_size, precision=precision,
        target=target, selection=selection))
    rng = np.random.default_rng(0)
    env = {}
    for name, spec in g2.inputs.items():
        a = rng.standard_normal((batch_size,) + spec.shape).astype(np.float32)
        env[name] = torch.from_numpy(a).to(device=device,
                                           dtype=getattr(torch, spec.dtype))
    if device.type == "cuda":
        prog = CapturedProgram(prog, {
            n: (tuple(spec.shape), getattr(torch, spec.dtype))
            for n, spec in g2.inputs.items()}, device)
        with torch.inference_mode():
            prog(env)                 # the seeded inputs into its statics
        if deadline.expired():
            return None
        return replay_min_us(prog.graph, device, reps=MEASURE_REPS,
                             deadline=deadline)
    return bench_min_us(prog, (env,), reps=MEASURE_REPS,
                        warmup=MEASURE_WARMUP, deadline=deadline)


def _measure_site(site: DecisionSite, graph: Graph, *, target: str,
                  precision: str, passes: Optional[Sequence[str]],
                  batch_size: int, device: torch.device,
                  deadline: Deadline, fingerprint: str) -> Optional[dict]:
    """Measure every choice at ``site``; the cache entry of the winner,
    or None if the budget ran out or every candidate failed (a choice
    that fails to build, capture or run is listed under ``failed``)."""
    measured: Dict[str, float] = {}
    failed = []
    best: Optional[Tuple[str, float]] = None
    variants = pipeline_candidates() if site.kind == "pipeline" else None
    default_pipeline = (tuple(passes) if passes is not None
                        else PassManager.default().pipeline)
    for choice in site.choices:
        if deadline.expired():
            break
        if site.kind == "pipeline":
            mini = graph.copy()
            pipeline = variants[choice]
        else:
            mini = extract_region(graph, site.region)
            apply_choice(mini, site, choice)
            pipeline = default_pipeline
        try:
            us = _probe_us(mini, pipeline, target=target,
                           precision=precision, batch_size=batch_size,
                           device=device, deadline=deadline)
        except Exception:
            failed.append(choice)   # an unbuildable choice is no winner
            continue
        if us is None:
            continue
        measured[choice] = us
        if best is None or us < best[1]:
            best = (choice, us)
    if best is None:
        return None
    winner, us = best
    return {
        "kind": site.kind,
        "winner": winner,
        "best_us": us,
        "measured_us": {k: round(v, 3) for k, v in measured.items()},
        "failed": failed,
        "fingerprint": fingerprint,
    }


def _site_desc(site: DecisionSite, *, target: str, precision: str,
               batch_size: int) -> dict:
    """The tactic-cache key descriptor of one decision site.  Pipeline
    sites mix in the variants' pass lists, so renaming or re-composing a
    variant misses cleanly instead of replaying the old meaning."""
    desc = {
        "graph_decision": site.kind,
        "v": GRAPH_DECISION_VERSION,
        "digest": site.digest,
        "target": target,
        "precision": precision,
        "batch": batch_size,
        "choices": list(site.choices),
    }
    if site.kind == "pipeline":
        desc["variants"] = {k: list(v)
                            for k, v in pipeline_candidates().items()}
    return desc


# ---------------------------------------------------------------------------
# the tuning pass
# ---------------------------------------------------------------------------
def tune_graph_decisions(
    graph: Graph,
    *,
    target: str,
    precision: str,
    passes: Optional[Sequence[str]],
    mode: str,
    budget_ms: Optional[float],
    cache: Optional[TacticCache],
    batch_size: int = 1,
    device="cuda",
) -> Tuple[Graph, Optional[Tuple[str, ...]], dict]:
    """Tune the graph-level decisions of ``graph`` on ``device``.

    Returns ``(decided_graph, pipeline, report)``: a copy with the
    winning decision attrs applied, the chosen pass list (``None`` = the
    caller's default) and a report of every site with its winner, source
    and per-candidate µs (and the raw cache ``entries``).

    ``mode="cached"`` consults the tactic cache only.  ``mode="full"``
    also measures unknown sites within ``budget_ms *
    GRAPH_BUDGET_FRACTION``, at ``batch_size``; the decisions apply to
    every batch size of the executable, since the pipeline runs once a
    compile.  Sites without an entry keep the passes' heuristics.
    """
    if mode not in ("cached", "full"):
        raise ValueError(f"autotune mode must be 'cached' or 'full' here, "
                         f"got {mode!r}")
    device = torch.device(device)
    sites = enumerate_sites(graph, passes=passes)
    graph_budget = (budget_ms * GRAPH_BUDGET_FRACTION
                    if (mode == "full" and budget_ms is not None) else
                    (None if mode == "full" else 0.0))
    deadline = Deadline(graph_budget)
    fingerprint = environment_fingerprint(device)
    decided = graph.copy()
    pipeline: Optional[Tuple[str, ...]] = (tuple(passes)
                                           if passes is not None else None)
    entries: Dict[str, dict] = {}
    site_rows: List[dict] = []
    for site in sites:
        desc = _site_desc(site, target=target, precision=precision,
                          batch_size=batch_size)
        key = tactic_key(desc, fingerprint)
        entry = cache.load(key, fingerprint) if cache is not None else None
        source = "cached" if entry is not None else None
        if entry is None and mode == "full" and not deadline.expired():
            # Pipeline variants are measured on the whole graph with the
            # decisions chosen so far applied: the program the winning
            # pipeline compiles.
            basis = decided if site.kind == "pipeline" else graph
            entry = _measure_site(site, basis, target=target,
                                  precision=precision, passes=passes,
                                  batch_size=batch_size, device=device,
                                  deadline=deadline, fingerprint=fingerprint)
            if entry is not None:
                source = "measured"
                if cache is not None:
                    cache.store(key, entry)
        row = {"kind": site.kind, "node": site.node, "digest": site.digest,
               "choices": list(site.choices)}
        if entry is not None and entry.get("winner") in site.choices:
            entries[key] = entry
            row.update(winner=entry["winner"], source=source,
                       best_us=entry.get("best_us"),
                       measured_us=dict(entry.get("measured_us", {})))
            if site.kind == "pipeline":
                if entry["winner"] != "default":
                    pipeline = tuple(pipeline_candidates()[entry["winner"]])
            else:
                apply_choice(decided, site, entry["winner"])
        else:
            row.update(winner=None, source="heuristic")
        site_rows.append(row)
    report = {
        "mode": mode,
        "device": str(device),
        "budget_ms": graph_budget,
        "spent_ms": round(deadline.spent_ms(), 3),
        "sites": site_rows,
        "pipeline": list(pipeline) if pipeline is not None else None,
        "cache": cache.stats() if cache is not None else None,
        "entries": entries,
    }
    return decided, pipeline, report
