"""The port's host spans (``runtime/spans.py``).

It imports neither JAX nor the JAX package at module level (the parity
case imports its helpers inside), so it also runs on a machine with a
card and no JAX:

    python -m pytest -m cuda tests/test_torch_spans.py

On the CPU: a span is the shared null context with no profiler, and no
span site builds a ``record_function`` then; under
``torch.profiler.profile`` one scheduler step nests its phases in
``repro.step`` (chunked, padded and whole-prompt prefill), a compiled
graph's call is ``repro.call``; spans leave every key the parity tests
hold to the reference's scheduler unchanged.  On the card (``cuda``): a captured
call's ``repro.input``, ``repro.replay`` and ``repro.output`` inside
``repro.call``, and the serving programs' replays inside their phases.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import BucketPolicy  # noqa: E402
from repro_torch.runtime.spans import span  # noqa: E402
from repro_torch.serve import (Request, Scheduler,  # noqa: E402
                               SchedulerOptions)
from repro_torch.table1_models import SUITE  # noqa: E402

ARCH = "qwen2.5-14b"
_MODELS = {}


def _model(device="cpu"):
    """The f32 SMOKE model of ``ARCH`` and its params, made once."""
    if device not in _MODELS:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                                  dtype="float32")
        model = get_model(cfg)
        _MODELS[device] = (model, model.init(0, device))
    return _MODELS[device]


def _spans(prof):
    """The host's ``repro.*`` events of a profile: (name, start, end), by
    start (a CUDA profile adds each span's extent on the card as an
    event of its own)."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("repro.")
                   and e.device_type == DeviceType.CPU),
                  key=lambda s: (s[1], -s[2]))


def _inside(outer, spans):
    """The spans that lie within ``outer``, ``outer`` left out."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b]


def _children(outer, spans):
    """The spans directly inside ``outer`` (inside no other one of them)."""
    inner = _inside(outer, spans)
    return [s[0] for s in inner
            if not any(s in _inside(o, inner) for o in inner)]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = span("step")
    assert off is span("chunk", uid=3) and isinstance(
        off, contextlib.nullcontext)
    with _cpu_profile() as prof:
        with span("step"), span("chunk", uid=3):
            pass
    assert [s[0] for s in _spans(prof)] == ["repro.step",
                                           "repro.chunk uid=3"]
    with off:                   # reentrant: nothing to open or close
        with off:
            pass


class _Counting:
    """Greedy sampler that counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, logits, temperature, *, uid, index):
        self.calls += 1
        return int(torch.argmax(logits, dim=-1)[0])


#: Options, and the spans directly inside the first step's ``repro.step``
#: for one request of uid 7 (a whole or padded prefill runs inside
#: admission; a chunked one after it).
STEP_CASES = {
    "chunked": (dict(prefill_chunk=8),
                ["repro.admit", "repro.chunk uid=7", "repro.sample uid=7",
                 "repro.decode", "repro.sample"]),
    "padded": (dict(buckets=BucketPolicy(batch_buckets=(1, 2),
                                         len_buckets=(8, 16, 32))),
               ["repro.admit", "repro.decode", "repro.sample"]),
    "whole": ({}, ["repro.admit", "repro.decode", "repro.sample"]),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_spans(case, monkeypatch):
    """The first step's spans nest in ``repro.step`` in the order the
    step runs its phases (a prefill program's call and its first token
    inside admission); then, with no profiler and no ``record_function``
    allowed, the run drains."""
    opts, want = STEP_CASES[case]
    model, params = _model()
    sampler = _Counting()
    sched = Scheduler(model, params, SchedulerOptions(
        slots=2, max_len=32, fold=False, **opts), sampler=sampler,
        engine_worker="sync")
    rng = np.random.default_rng(11)
    for uid, n in ((7, 5), (8, 12), (9, 3)):
        sched.submit(Request(uid=uid, prompt=rng.integers(
            0, 256, n).astype(np.int32), max_new_tokens=4 + uid % 3))
    with _cpu_profile() as prof:
        sched.step()
    spans = _spans(prof)
    step = next(s for s in spans if s[0] == "repro.step")
    assert len(_inside(step, spans)) == len(spans) - 1
    got = _children(step, spans)
    if case == "chunked":
        # uid 8 is admitted beside 7, and chunked: its first chunk of two
        want = want[:2] + ["repro.chunk uid=8"] + want[2:]
        assert got == want
    else:
        # two requests admitted in the step: each prefill and its first
        # token inside admission
        assert got == want
        admit = next(s for s in spans if s[0] == "repro.admit")
        assert _children(admit, spans) == [
            "repro.prefill uid=7", "repro.sample uid=7",
            "repro.prefill uid=8", "repro.sample uid=8"]
    # a first token and a decoded one for each active request (one
    # chunked: uid 8 is still prefilling)
    assert sampler.calls == (2 if case == "chunked" else 4)
    # a span site that built a record_function now would raise
    monkeypatch.setattr(torch.profiler, "record_function", None)
    sched.run()
    sched.shutdown()
    assert sorted(c.uid for c in sched.done) == [7, 8, 9]
    assert sampler.calls == sum(len(c.tokens) for c in sched.done)


def test_compiled_call_span(monkeypatch):
    """A compiled Table-1 CNN's call is one ``repro.call`` (on the CPU
    the program is eager: no captured input, replay or output), and
    with no profiler it builds no ``record_function``."""
    g = SUITE["C-BH"]()
    exe = repro_torch.compile(g, target="jit", device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (2,) + tuple(g.inputs["input"].shape)).astype(np.float32)
    with _cpu_profile() as prof:
        want = exe(input=x)
    assert [s[0] for s in _spans(prof)] == ["repro.call"]
    monkeypatch.setattr(torch.profiler, "record_function", None)
    got = exe(input=x)
    assert want.keys() == got.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_spans_leave_the_reference_keys_alone():
    """The parity trace (chunked prefill, batch buckets) run with a
    profiler recording: the port's spans are in the profile, and the
    port still gives the reference's tokens, sampler calls, ``summary()``
    and per-request metrics, timestamps included (``run_both`` asserts
    them): no span reads the scheduler's clock."""
    from _serve_parity import Spec, prompts, run_both
    specs = [Spec(u, p, 3 + u % 3) for u, p in
             enumerate(prompts(5, 3, 19, seed=21))]
    with _cpu_profile() as prof:
        run_both(ARCH, specs, slots=2, max_len=32,
                               prefill_chunk=8, worker="manual", warm=True,
                               buckets=dict(batch_buckets=(1, 2)))
    names = {s[0].split(" ")[0] for s in _spans(prof)}
    assert {"repro.step", "repro.admit", "repro.chunk", "repro.decode",
            "repro.sample"} <= names


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captured programs replay on the "
                    "card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["call", "serve"])
def test_captured_spans_on_the_card(card, path):
    """``call``: a captured Table-1 CNN call's static-input copy, replay
    and output clones, in that order, inside ``repro.call``.
    ``serve``: the chunk program's and the decode step's replays inside
    ``repro.chunk`` and ``repro.decode``."""
    if path == "call":
        g = SUITE["C-BH"]()
        exe = repro_torch.compile(g, target="jit", device="cuda")
        x = np.random.default_rng(5).standard_normal(
            (1,) + tuple(g.inputs["input"].shape)).astype(np.float32)
        exe(input=x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe(input=x)
            torch.cuda.synchronize()
        spans = _spans(prof)
        call = next(s for s in spans if s[0] == "repro.call")
        assert _children(call, spans) == ["repro.input", "repro.replay",
                                          "repro.output"]
        return
    model, params = _model("cuda")
    sched = Scheduler(model, params, SchedulerOptions(
        slots=2, max_len=32, fold=False, prefill_chunk=8))
    sched.submit(Request(uid=3, prompt=np.arange(5, dtype=np.int32),
                         max_new_tokens=3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.step()
        torch.cuda.current_stream().synchronize()
    spans = _spans(prof)
    for outer in ("repro.chunk uid=3", "repro.decode"):
        s = next(s for s in spans if s[0] == outer)
        assert _children(s, spans) == ["repro.replay"], outer
    sched.run()
    sched.shutdown()
    assert [c.uid for c in sched.done] == [3]
