"""The profile-guided tuning pass: heuristic prior → measured winners.

The port of ``repro.autotune.tuner``.  ``tune_selection`` takes the
selector's per-node choices (the *prior*) and refines them:

* ``mode="cached"``: the persistent tactic cache only; nodes without a
  valid entry keep the heuristic choice.  No measurement, deterministic.
* ``mode="full"``: also measure the candidates of every node the cache
  has no entry for, within ``budget_ms`` of wall clock (builds, warm-ups
  and captures count), and store each winner for every later process.

Identical shapes share one measurement within a pass.  A tuned
:class:`~repro_torch.core.selection.KernelChoice` records ``source=
"measured"``, the winning tactic's plan overrides as its ``tactic``
(None when the heuristic's plan won), its plan's facts as its
``block`` and every candidate's µs, and the lowering launches the plan
it names.  On the
card the µs are device time (``measure.bench_min_us``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.selection import KernelChoice
from .cache import TacticCache, environment_fingerprint, tactic_key
from .measure import Deadline, bench_min_us
from .tactics import Tactic, candidates_for_node, untuned_reason

#: Reps per candidate (min-of-reps estimator) and warm-up calls.
MEASURE_REPS = 5
MEASURE_WARMUP = 1

AUTOTUNE_MODES = ("off", "cached", "full")


def _measure_candidates(node_tactics, deadline: Deadline,
                        fingerprint: str) -> Optional[dict]:
    """Measure every candidate; the cache entry of the winner, or None if
    the budget ran out (or every candidate failed) before one finished.
    A candidate that fails to build or launch is listed under
    ``failed``."""
    measured: Dict[str, float] = {}
    failed = []
    best: Optional[Tuple[Tactic, float]] = None
    for tactic, fn, args in node_tactics.make_candidates():
        # Stop before the next candidate's build once over budget.
        if deadline.expired():
            break
        us = bench_min_us(fn, args, reps=MEASURE_REPS,
                          warmup=MEASURE_WARMUP, deadline=deadline)
        if us is None:
            if not deadline.expired():
                failed.append(tactic.label)
            continue
        measured[tactic.label] = us
        if best is None or us < best[1]:
            best = (tactic, us)
    if best is None:
        return None
    tactic, us = best
    return {
        "winner": tactic.kernel,
        "winner_label": tactic.label,
        "tactic": list(tactic.params) if tactic.params else None,
        "block": list(tactic.block) if tactic.block else None,
        "best_us": us,
        "measured_us": {k: round(v, 3) for k, v in measured.items()},
        "failed": failed,
        "desc": node_tactics.desc,
        "fingerprint": fingerprint,
    }


def _measured_choice(node, op: str, entry: dict, prior: KernelChoice
                     ) -> KernelChoice:
    n_cands = len(entry.get("measured_us", {}))
    best_us = entry.get("best_us")
    reason = (f"measured {entry.get('winner_label', entry['winner'])}"
              + (f" = {best_us:.1f}us" if isinstance(best_us, (int, float))
                 else "")
              + f" (best of {n_cands} tactics; heuristic prior: "
              f"{prior.kernel}, {prior.reason})")
    block, tactic = entry.get("block"), entry.get("tactic")
    return KernelChoice(
        node.name, op, entry["winner"], reason,
        source="measured",
        block=tuple(block) if block else None,
        measured_us=dict(entry.get("measured_us", {})),
        tactic=tuple(tactic) if tactic else None)


def tune_selection(
    graph,
    selection: Dict[str, KernelChoice],
    *,
    batch_size: int,
    precision: str,
    mode: str,
    budget_ms: Optional[float],
    cache: Optional[TacticCache],
    device="cuda",
) -> Tuple[Dict[str, KernelChoice], dict]:
    """Refine ``selection`` with cached or measured tactics on ``device``.

    Returns ``(tuned_selection, report)``.  A node without an entry keeps
    its heuristic choice: tuning changes a decision only on the strength
    of a measurement.  An entry whose winner is not the prior's kernel
    (written for another numerics class) is ignored.
    """
    if mode not in ("cached", "full"):
        raise ValueError(f"autotune mode must be 'cached' or 'full' here, "
                         f"got {mode!r}")
    deadline = Deadline(budget_ms if mode == "full" else None)
    fingerprint = environment_fingerprint(device)
    memo: Dict[str, dict] = {}
    tuned: Dict[str, KernelChoice] = dict(selection)
    measured_nodes, cached_nodes, heuristic_nodes = [], [], []
    not_tuned: Dict[str, str] = {}

    specs = graph.infer_shapes()
    for node in graph.nodes:
        prior = selection.get(node.name)
        if prior is None:
            reason = untuned_reason(node, precision)
            if reason is not None:
                not_tuned[node.name] = reason
            continue
        nt = candidates_for_node(node, graph, specs, batch_size=batch_size,
                                 precision=precision, device=device)
        if nt is None:
            continue
        key = tactic_key(nt.desc, fingerprint)
        entry = memo.get(key)
        from_memo = entry is not None
        if entry is None and cache is not None:
            entry = cache.load(key, fingerprint)
            if entry is not None and entry["winner"] != prior.kernel:
                entry = None
            if entry is not None:
                memo[key] = entry
        if entry is None and mode == "full" and not deadline.expired():
            entry = _measure_candidates(nt, deadline, fingerprint)
            if entry is not None:
                memo[key] = entry
                if cache is not None:
                    cache.store(key, entry)
                measured_nodes.append(node.name)
        elif entry is not None and not from_memo and cache is not None:
            cached_nodes.append(node.name)
        if entry is not None:
            tuned[node.name] = _measured_choice(node, prior.op, entry, prior)
            if from_memo and node.name not in measured_nodes:
                cached_nodes.append(node.name)
        else:
            heuristic_nodes.append(node.name)

    report = {
        "mode": mode,
        "device": str(device),
        "budget_ms": budget_ms,
        "spent_ms": round(deadline.spent_ms(), 3),
        "measured_nodes": measured_nodes,
        "cached_nodes": cached_nodes,
        "heuristic_nodes": heuristic_nodes,
        "not_tuned": not_tuned,
        "cache": cache.stats() if cache is not None else None,
        # Raw cache entries by tactic key; stripped from cost_summary().
        "entries": dict(memo),
    }
    return tuned, report
