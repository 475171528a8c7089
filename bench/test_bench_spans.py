"""The readers of the program's own host spans (``bench/spans.py`` and the
metrics ``sample_idle_share.serve``, ``decode_idle_share.serve``,
``prefill_idle_share.chat`` and ``call_idle_us.frame``), on hand-made
chrome-trace events: idle time goes to the innermost program span on the
benchmark's thread, split exactly where a gap straddles two spans, and
sums to the slice's idle time; the trace's existing reading is the same
with and without program spans; each reader reads nothing where its
spans are absent."""

import gzip
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import run, spans, trace  # noqa: E402

BENCH, OTHER, STREAM = 1, 2, 7


def _span(name, a, b, tid=BENCH):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "pid": 1, "tid": tid}


def _kernel(a, b, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a,
            "pid": 0, "tid": STREAM}


def _chat():
    """One scheduler step of 1000 µs: admission, a chunk and the decode
    step (each replaying a graph), then sampling; two kernels."""
    return [_span("bench.step", 0, 1000), _span("repro.step", 0, 1000),
            _span("repro.admit", 0, 100),
            _span("repro.chunk uid=4", 100, 400),
            _span("repro.replay", 150, 350),
            _span("repro.decode", 400, 800), _span("repro.replay", 450, 700),
            _span("repro.sample", 800, 1000),
            _kernel(160, 340), _kernel(460, 690)]


def _frame():
    """Two calls of a captured program and their readbacks."""
    out = []
    for t in (0, 150):
        out += [_span("bench.call", t, t + 100), _span("repro.call", t,
                                                       t + 100),
                _span("repro.input", t + 5, t + 15),
                _span("repro.replay", t + 15, t + 20),
                _span("repro.output", t + 20, t + 30),
                _span("bench.readback", t + 100, t + 150),
                _kernel(t + 18, t + 90)]
    return out


def _by_path(events):
    """Idle seconds by the path of program spans."""
    return spans.program_spans(events)[2]


def _by_span(events):
    """Idle seconds by the innermost program span (``""``: none)."""
    out = {}
    for path, sec in _by_path(events).items():
        key = path[-1] if path else ""
        out[key] = out.get(key, 0.0) + sec
    return out


def _idle_s(events):
    r = trace.summarize(events, 1.0)
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    return (hi - lo) / 1e6 - r["busy_s"]


# -- idle time by span --------------------------------------------------------
def test_idle_goes_to_the_innermost_span():
    ev = [_span("repro.step", 0, 100), _span("repro.decode", 10, 50),
          _span("repro.replay", 20, 30), _kernel(25, 60), _kernel(80, 90)]
    by_path = _by_path(ev)
    assert by_path == pytest.approx({("step",): 40e-6,
                                     ("step", "decode"): 10e-6,
                                     ("step", "decode", "replay"): 5e-6})
    assert _by_span(ev) == pytest.approx(
        {"step": 40e-6, "decode": 10e-6, "replay": 5e-6})
    assert spans.idle_under(by_path, ["decode"]) == pytest.approx(15e-6)
    assert spans.idle_under(by_path, ["step"]) == pytest.approx(40e-6)


def test_a_gap_across_two_spans_is_split_between_them():
    ev = [_span("repro.step", 0, 100), _span("repro.admit", 0, 40),
          _span("repro.decode", 40, 100), _kernel(10, 20), _kernel(70, 80)]
    assert _by_span(ev) == pytest.approx(
        {"admit": 30e-6, "decode": 50e-6})   # the gap 20..70: 20 + 30


def test_spans_on_another_thread_are_ignored():
    ev = [_span("bench.step", 0, 100), _span("repro.step", 0, 100),
          _span("repro.sample", 0, 100, tid=OTHER),
          _span("repro.decode", 10, 90, tid=OTHER), _kernel(40, 60)]
    assert _by_span(ev) == pytest.approx({"step": 80e-6})
    # no benchmark span: the thread of most program spans
    ev = [e for e in ev if not e["name"].startswith("bench.")]
    assert _by_span(ev) == pytest.approx({"sample": 20e-6,
                                                    "decode": 60e-6})
    _, counts, _ = spans.program_spans(ev)
    assert counts == {"sample": 1, "decode": 1}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_sums_to_the_window_less_the_busy_time(seed):
    """Random nested spans on two threads and random kernels: every
    microsecond the card idled is given out once."""
    rng = np.random.default_rng(seed)
    ev = []
    for tid in (BENCH, OTHER):
        t = 0.0
        for _ in range(40):
            a = t + rng.uniform(0, 30)
            b = a + rng.uniform(50, 400)
            ev.append(_span("repro.step", a, b, tid))
            c = a + rng.uniform(0, (b - a) / 2)
            ev.append(_span("repro.decode", c, c + rng.uniform(0, b - c),
                            tid))
            t = b
    for a in np.sort(rng.uniform(0, t, 200)):
        ev.append(_kernel(float(a), float(a + rng.uniform(1, 60))))
    busy_s = spans.program_spans(ev)[0]
    assert busy_s == trace.summarize(ev, 1.0)["busy_s"]
    got = _by_span(ev)
    assert sum(got.values()) == pytest.approx(_idle_s(ev), abs=1e-6)
    assert set(got) <= {"", "step", "decode"}


def test_the_trace_reading_is_the_same_with_program_spans():
    """``trace.summarize`` returns the keys it always did, and the same
    values (the gaps still named by the benchmark's spans) whether or
    not the program recorded spans."""
    for ev in (_chat(), _frame()):
        bare = [e for e in ev if not e["name"].startswith("repro.")]
        got = trace.summarize(ev, 0.001)
        assert got == trace.summarize(bare, 0.001)
        assert set(got) == {"window_s", "busy_s", "kernel_s", "kernel_n",
                            "device_ops", "idle_gaps"}
        assert {n for n, _ in got["idle_gaps"]} <= {"step", "call",
                                                    "readback"}


# -- the readers -----------------------------------------------------------
READERS = {"sample_idle_share.serve": ("chat", 20.0),
           "decode_idle_share.serve": ("chat", 17.0),
           "prefill_idle_share.chat": ("chat", 22.0),
           "call_idle_us.frame": ("frame", 28.0)}


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader(name, tmp_path, monkeypatch):
    """Each reader on a hand-made trace file: its value (chat: idle
    220 µs in admission and the chunk, 170 in the decode step, 200 in
    sampling, of a 1000 µs slice; frame: 28 µs of idle a call inside the
    program's call, the readbacks' idle left out).  None with no trace,
    with no trace file that holds the run's slice, and on a trace
    without program spans (a program older than them)."""
    kind, want = READERS[name]
    events = _chat() if kind == "chat" else _frame()
    window_s = 0.001 if kind == "chat" else 300e-6
    reader = run.load_module(run.reader_path(name), f"r_{kind}")
    monkeypatch.setattr(spans, "TRACES", tmp_path)
    ctx = {"trace": trace.summarize(events, window_s),
           "slice_latency_s": [100e-6, 100e-6]}
    assert reader.read({}) is None and reader.read({"trace": None}) is None
    assert reader.read(ctx) is None                   # no trace file yet
    _write(tmp_path / "cell.1.json.gz", events)
    _write(tmp_path / "cell.2.json.gz", _chat() + _frame())     # not this run
    assert reader.read(ctx) == pytest.approx(want)
    bare = [e for e in events if not e["name"].startswith("repro.")]
    _write(tmp_path / "cell.3.json.gz", bare)
    assert reader.read({"trace": trace.summarize(bare, window_s),
                        "slice_latency_s": [1.0]}) is None


def test_the_shares_are_parts_of_the_idle_share():
    ctx = {"trace": trace.summarize(_chat(), 0.001)}
    by_path = _by_path(_chat())
    parts = [spans.idle_under(by_path, k) for k in
             (["sample"], ["decode"], ["admit", "chunk", "prefill"])]
    assert 100 * sum(parts) / 0.001 == pytest.approx(trace.idle_share(
        ctx["trace"]))
