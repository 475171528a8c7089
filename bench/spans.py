"""Where the card's idle time goes, by the program's own host spans.

The program marks its host phases as ``repro.<kind>`` profiler events
(``repro_torch/runtime/spans.py``: ``step``, ``admit``, ``chunk``,
``prefill``, ``decode``, ``sample``, ``call``, ``input``, ``replay``,
``output``; a request's span adds `` uid=<uid>`` to its name), recorded
only while a profiler records: in a traced run's slice.  The slice's
idle time is what ``trace.summarize`` counts as idle: from its first
event to its last, less the union of every kernel, copy and set on the
card.  :func:`program_spans` gives each instant of it to the innermost
program spans open then on the benchmark's thread (the one that holds
the ``bench.*`` spans), by exact interval intersection: the path of
span kinds from the outermost in, ``()`` where none is open.  Its
values sum to the slice's idle time.

The readers of the per-layer metrics find the slice's events in the
trace file the run wrote (``build/bench/traces``): the newest whose
busy time is the run's reading's (``ctx["trace"]``).  A program without
these spans (one older than them) gives no path but ``()``, and each
reader then reports nothing.
"""

from __future__ import annotations

import bisect
import gzip
import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .stats import merge
from .trace import DEVICE_CATS, SPAN_PREFIX

PREFIX = "repro."
#: A captured program's launch: its idle time belongs to the phase that
#: replays it (the span around it).
REPLAY = "replay"
TRACES = Path(__file__).resolve().parent.parent / "build" / "bench" / \
    "traces"

SpanPath = Tuple[str, ...]


def kind(name: str) -> str:
    """A program span's kind: its name past ``repro.``, up to a space."""
    return name[len(PREFIX):].split(" ", 1)[0]


def _thread(spans: Sequence[tuple]):
    """The benchmark's thread: the one that holds most ``bench.*`` spans,
    else the one that holds most program spans."""
    for prefix in (SPAN_PREFIX, PREFIX):
        tids = Counter(t for _, _, n, t in spans if n.startswith(prefix))
        if tids:
            return tids.most_common(1)[0][0]
    return None


def _parse(events: Iterable[Dict]):
    """The slice's bounds (µs), the card's busy intervals (merged) and
    every host span ``(start, end, name, tid)``."""
    dev, spans = [], []
    lo = hi = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        lo = a if lo is None else min(lo, a)
        hi = a + d if hi is None else max(hi, a + d)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((a, a + d))
        elif cat == "user_annotation":
            spans.append((a, a + d, str(e.get("name", "")), e.get("tid")))
    return lo, hi, merge(dev), spans


def _idle_before(lo: float, hi: float, busy: List[tuple]):
    """``f(t)``: the idle µs of ``[lo, t]`` (``busy`` merged, sorted)."""
    idle = []
    t = lo
    for a, b in busy:
        if a > t:
            idle.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        idle.append((t, hi))
    starts = [a for a, _ in idle]
    cum = [0.0]
    for a, b in idle:
        cum.append(cum[-1] + (b - a))

    def f(x: float) -> float:
        i = bisect.bisect_right(starts, x)
        if i == 0:
            return 0.0
        a, b = idle[i - 1]
        return cum[i - 1] + (min(x, b) - a)
    return f


def program_spans(events: Iterable[Dict]
                  ) -> Tuple[float, Counter, Dict[SpanPath, float]]:
    """``(the card's busy seconds, as trace.summarize counts them; count
    of program spans by kind; idle seconds by path)`` on the benchmark's
    thread (see the module's note)."""
    lo, hi, busy, spans = _parse(events)
    by_path: Dict[SpanPath, float] = {}
    if lo is None:
        return 0.0, Counter(), by_path
    tid = _thread(spans)
    mine = [(a, b, kind(n)) for a, b, n, t in spans
            if t == tid and n.startswith(PREFIX)]
    f = _idle_before(lo, hi, busy)
    edges = [(lo, 1, -1), (hi, 1, -1)]     # bounds: open or close nothing
    for i, (a, b, _) in enumerate(mine):
        edges += [(a, 1, i), (b, 0, i)]    # at a tie, close before open
    edges.sort()
    live: Dict[int, tuple] = {}
    for (t0, op, i), (t1, _, _) in zip(edges, edges[1:]):
        if i >= 0:
            if op:
                live[i] = mine[i]
            else:
                live.pop(i, None)
        if t1 > t0:
            path = tuple(s[2] for s in sorted(live.values(),
                                              key=lambda s: (s[0], -s[1])))
            by_path[path] = by_path.get(path, 0.0) + (f(t1) - f(t0)) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return busy_s, Counter(s[2] for s in mine), by_path


def idle_under(by_path: Dict[SpanPath, float],
               kinds: Sequence[str]) -> float:
    """Idle seconds whose phase is one of ``kinds``: the innermost span
    other than a replay (a replay's idle time is its caller's)."""
    total = 0.0
    for path, s in by_path.items():
        owner = [k for k in path if k != REPLAY]
        if owner and owner[-1] in kinds:
            total += s
    return total


# -- the run's trace --------------------------------------------------------
_found: List = [None, None]          # [the run's reading, its spans]


def _load(path: Path) -> List[Dict]:
    with gzip.open(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def slice_spans(ctx: Dict
                ) -> Optional[Tuple[Counter, Dict[SpanPath, float]]]:
    """:func:`program_spans`' counts and idle by path of the run's traced
    slice (None untraced,
    or where no trace file holds it): the newest file under
    :data:`TRACES` whose busy time is the reading's (``ctx["trace"]``;
    a sum of thousands of intervals, equal only on the same events)."""
    tr = ctx.get("trace")
    if not tr:
        return None
    if _found[0] is tr:
        return _found[1]
    paths = sorted(TRACES.glob("*.json.gz"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        try:
            events = _load(path)
        except (OSError, ValueError):
            continue
        busy_s, counts, by_path = program_spans(events)
        if busy_s == tr["busy_s"]:
            _found[:] = [tr, (counts, by_path)]
            return _found[1]
    return None


def phase_idle(ctx: Dict, kinds: Sequence[str]
               ) -> Optional[Tuple[float, Counter]]:
    """``(idle seconds of the traced slice whose phase is one of kinds,
    count of program spans by kind)``; None where the slice holds no
    span of ``kinds`` (an untraced run, or a program without them)."""
    got = slice_spans(ctx)
    if got is None or not any(got[0][k] for k in kinds):
        return None
    return idle_under(got[1], kinds), got[0]


def idle_share(ctx: Dict, kinds: Sequence[str]) -> Optional[float]:
    """Percent of the traced slice in which the card idled while the
    host was in one of ``kinds`` (or a replay they ran)."""
    got = phase_idle(ctx, kinds)
    return None if got is None else \
        100.0 * got[0] / ctx["trace"]["window_s"]
