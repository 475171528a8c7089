"""The port's serve scheduler against the JAX package's, on the CPU.

``repro_torch.serve`` and ``repro.serve`` run the same request trace over
the same weights (the reference's ``init(PRNGKey(0))``, carried across
with ``repro_torch.weights.params_from_reference``), the same
``TickClock`` and a sampler that records the logits it is handed and
returns either a scripted token or the argmax.  The configs are the
``SMOKE`` ones at ``dtype="float32"``.  Each case asserts:

* the same tokens, finish reasons, finish order and sampler calls;
* every logits row within 1e-5 x max(1, max|logits|) of the reference's;
* ``summary()`` equal key for key, ``runtime`` included (the port's own
  ``engines`` key held apart: every program eager on the CPU).

The cases are the admission policies (fcfs, shortest, deadline), the
queue limit, EOS at admission and mid-run, the ``max_new_tokens`` clamp,
continuous batching with mid-run arrivals (also against the port's
one-slot ``Engine``), ``pop_completions(purge=True)``, whisper's
``frames``, chunked prefill, prefix sharing (the head prefilled once),
a ring cache switching chunking off, and bucketed decode (length-bucket
prefill, batch buckets warmed in ``"manual"`` mode, ``"sync"`` mode)
against fixed shapes.  Every non-hybrid SMOKE config also runs one
bucketed trace (chunked prefill with a prefix cache where the family
supports it).

``recurrentgemma`` is held to the reference's model instead of its
scheduler: the reference's slot manager splices every leaf along axis
1, but recurrentgemma's ``rec_conv``/``rec_h`` carry the batch on axis
2, so its scheduler serves that family with misplaced state.  The
oracle is the reference's ``prefill`` + ``decode_step`` per request.
Requests and prompts come from this file's own
``np.random.default_rng(seed)``.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from _serve_parity import (Recorder, Spec, TickClock, drive,
                           engines_on_cpu, pair, prompts, run_both, sides)
from repro.serve import QueueFullError as RefQueueFullError
from repro_torch.configs import get_config
from repro_torch.runtime import BucketPolicy
from repro_torch.serve import (QueueFullError, Request, Scheduler,
                               SchedulerOptions)
from repro_torch.serve.slots import SlotManager, SlotState, batch_axes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# Scheduling cases, qwen2.5-14b SMOKE
# ---------------------------------------------------------------------------
QWEN = "qwen2.5-14b"
A4 = np.arange(4, dtype=np.int32)


def admitted_order(sched):
    return [m.uid for m in sorted(sched.request_metrics.values(),
                                  key=lambda m: m.admitted_at)]


@pytest.mark.parametrize("admission,specs,want", [
    ("fcfs", [Spec(u, A4, 2) for u in (3, 1, 2)], [3, 1, 2]),
    ("shortest", [Spec(u, np.arange(n, dtype=np.int32), 2)
                  for u, n in ((0, 10), (1, 3), (2, 6))], [1, 2, 0]),
    ("deadline", [Spec(0, A4, 2), Spec(1, A4, 2, slo_ms=9000.0),
                  Spec(2, A4, 2, slo_ms=1000.0)], [2, 1, 0]),
])
def test_admission_order(admission, specs, want):
    _, got, _ = run_both(QWEN, specs, script={}, slots=1, max_len=48,
                         admission=admission)
    assert admitted_order(got) == want


def test_queue_limit_and_submit_errors():
    """Both packages refuse the same submits, with the same errors, and
    count the same rejection."""
    for sched_cls, opt_cls, req_cls, model, params, _ in sides(QWEN):
        sched = sched_cls(model, params, opt_cls(slots=1, max_len=48,
                                                 max_queue=2, fold=False))
        sched.submit(req_cls(uid=0, prompt=A4))
        with pytest.raises(ValueError, match="duplicate"):
            sched.submit(req_cls(uid=0, prompt=A4))
        sched.submit(req_cls(uid=1, prompt=A4))
        with pytest.raises(QueueFullError if sched_cls is Scheduler
                           else RefQueueFullError):
            sched.submit(req_cls(uid=2, prompt=A4))
        assert sched.metrics.rejected == 1
        with pytest.raises(ValueError, match="max_len"):
            sched.submit(req_cls(uid=3, prompt=np.arange(48) % 256))
        assert sched.queue_depth() == 2


def test_eos_at_admission_and_mid_run():
    # uid 0 emits EOS (7) as its first token, uid 1 as its second, uid 2
    # runs to its length; a one-token budget retires at admission too
    specs = [Spec(0, A4, 8, eos_id=7), Spec(1, A4 + 1, 8, eos_id=7),
             Spec(2, np.arange(5, dtype=np.int32), 3, eos_id=7),
             Spec(3, A4 + 2, 1)]
    _, got, _ = run_both(QWEN, specs, script={0: (7,), 1: (5, 7),
                                              2: (2, 3, 4), 3: (9,)},
                         slots=2, max_len=48)
    done = {c.uid: (c.tokens, c.finish_reason) for c in got.done}
    assert done == {0: ([7], "eos"), 1: ([5, 7], "eos"),
                    2: ([2, 3, 4], "length"), 3: ([9], "length")}


def test_max_new_tokens_clamped_to_cache_budget():
    _, got, _ = run_both(QWEN, [Spec(0, np.arange(8, dtype=np.int32), 100)],
                         slots=1, max_len=12)
    assert len(got.done[0].tokens) == 4
    assert got.done[0].finish_reason == "length"


def test_continuous_batching_against_one_slot_engine():
    """Eight requests up front, two arriving after the second step: the
    same greedy tokens as the reference's scheduler and as the port's
    deprecated one-slot ``Engine``, one request at a time."""
    ps = prompts(10, 3, 7, seed=1)
    specs = [Spec(u, p, 6) for u, p in enumerate(ps)]
    _, got, _ = run_both(QWEN, specs[:8], late={2: specs[8:]}, slots=8,
                         max_len=48)
    assert got.summary()["completed"] == 10
    from repro_torch.inference import Engine
    _, _, pm, pp = pair(QWEN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for s in specs:
            eng = Engine(pm, pp, slots=1, max_len=48, fold=False)
            eng.submit(s.make(Request))
            assert eng.run()[0].tokens == got.generated[s.uid]


def test_pop_completions_purge():
    """Streaming drain with ``purge=True`` in both packages: the same
    completions popped, per-request state dropped, a purged uid reusable,
    aggregate counters kept."""
    seen = []
    for sched_cls, opt_cls, req_cls, model, params, _ in sides(QWEN):
        sched = sched_cls(model, params, opt_cls(slots=1, max_len=48,
                                                 fold=False),
                          sampler=Recorder({}), clock=TickClock())
        sched.submit(req_cls(uid=0, prompt=A4, max_new_tokens=2))
        sched.submit(req_cls(uid=1, prompt=A4, max_new_tokens=2))
        assert sched.pop_completions() == []
        while not sched.pop_completions():
            sched.step()
        sched.run()
        assert [c.uid for c in sched.pop_completions(purge=True)] == [1]
        assert [c.uid for c in sched.done] == [0]
        assert 1 not in sched.generated and 1 not in sched.request_metrics
        sched.submit(req_cls(uid=1, prompt=A4, max_new_tokens=2))
        sched.run()
        assert sched.metrics.completed == 3
        seen.append(sched.summary())
    assert seen[1].pop("engines") == engines_on_cpu(sched)
    assert seen[0] == seen[1]


def test_whisper_frames():
    """The ``frames`` extra reaches prefill (batch-less or not), a
    request without it is zero-filled, and names or shapes outside the
    signature are refused at submit."""
    rng = np.random.default_rng(5)
    cfg = get_config("whisper-base", smoke=True)
    frames = rng.standard_normal((cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    specs = [Spec(0, A4, 4, inputs={"frames": frames}),
             Spec(1, A4, 4),
             Spec(2, A4 + 3, 4, inputs={"frames": frames[None] * 0.5})]
    _, got, rec = run_both("whisper-base", specs, slots=2, max_len=32)
    assert not np.allclose(rec.logits[0], rec.logits[1])
    with pytest.raises(ValueError, match="unknown inputs"):
        got.submit(Request(uid=9, prompt=A4, inputs={"patches": frames}))
    with pytest.raises(ValueError, match="expected"):
        got.submit(Request(uid=9, prompt=A4, inputs={"frames": frames[:3]}))
    assert got.queue_depth() == 0


def test_chunked_prefill_and_prefix_sharing():
    """Chunked prefill gives the whole-prompt tokens; with a prefix cache
    the shared head is prefilled once and every other sharer takes a
    copy, skipping its chunks."""
    chunk = 8
    head = (np.arange(2 * chunk, dtype=np.int32) * 5 + 3) % 256
    specs = [Spec(u, p, 5) for u, p in
             enumerate(prompts(6, 3, 11, seed=42, head=head))]
    n_shared = sum(1 for s in specs if len(s.prompt) > len(head))
    _, _, pm, pp = pair(QWEN)
    whole = Scheduler(pm, pp, SchedulerOptions(slots=3, max_len=64,
                                               fold=False))
    drive(whole, Request, specs)
    _, plain, _ = run_both(QWEN, specs, slots=3, max_len=64,
                           prefill_chunk=chunk)
    _, shared, _ = run_both(QWEN, specs, slots=3, max_len=64,
                            prefill_chunk=chunk, prefix_cache=4)
    want = {u: whole.generated[u] for u in whole.generated}
    assert plain.generated == want and shared.generated == want
    summ = shared.summary()
    assert plain.summary()["chunked_prefill"] == {"enabled": True,
                                                  "chunk_len": chunk}
    pc = summ["prefix_cache"]
    assert pc["inserts"] == 1 and pc["hits"] == n_shared - 1
    assert pc["shared_tokens"] == (n_shared - 1) * len(head)
    saved = (n_shared - 1) * (len(head) // chunk)
    assert summ["prefill_chunks"] == \
        plain.summary()["prefill_chunks"] - saved


def test_ring_cache_disables_chunking_and_length_buckets():
    specs = [Spec(0, np.arange(6, dtype=np.int32), 3),
             Spec(1, np.arange(11, dtype=np.int32), 3)]
    _, got, _ = run_both(QWEN, specs, slots=2, max_len=32, prefill_chunk=8,
                         buckets=dict(batch_buckets=(1, 2),
                                      len_buckets=(8, 16, 32)),
                         worker="manual",
                         cfg_changes=dict(pattern="swa", window=8))
    assert got._chunk_engine is None and got._prefill_engine is None
    assert got.summary()["chunked_prefill"] == {"enabled": False,
                                                "chunk_len": 8}
    assert [len(c.tokens) for c in got.done] == [3, 3]


@pytest.mark.parametrize("worker,warm", [("manual", True), ("sync", False)])
def test_bucketed_decode_against_fixed_shapes(worker, warm):
    """Length-bucket prefill and batch-bucket decode give the fixed-shape
    tokens.  ``"manual"`` with every bucket warmed first decodes at the
    batch buckets 1, 2 and 3 as requests retire; ``"sync"`` serves on
    the full-slots step and never stalls."""
    specs = [Spec(u, p, 4 + u % 3) for u, p in
             enumerate(prompts(6, 3, 21, seed=3))]
    _, _, pm, pp = pair(QWEN)
    fixed = Scheduler(pm, pp, SchedulerOptions(slots=3, max_len=32,
                                               fold=False))
    drive(fixed, Request, specs)
    assert "runtime" not in fixed.summary()
    _, got, _ = run_both(
        QWEN, specs, slots=3, max_len=32, worker=worker, warm=warm,
        buckets=dict(batch_buckets=(1, 2, 4), len_buckets=(8, 16, 32)))
    assert got.generated == fixed.generated
    rt = got.summary()["runtime"]
    assert rt["decode"]["compile_stalls"] == 0 and rt["pad_waste_frac"] > 0
    warm_decode = rt["decode"]["warm_buckets"]
    assert warm_decode == (["b1", "b2", "b3"] if warm else ["b3"]), \
        warm_decode


def test_steady_state_decode_keeps_every_buffer():
    """The cache's tensors are made once: across steady-state steps every
    leaf keeps its address, on the fixed-shape and the bucketed path."""
    _, _, pm, pp = pair(QWEN)
    for buckets in (None, BucketPolicy.default(max_batch=4, max_len=48)):
        sched = Scheduler(pm, pp, SchedulerOptions(
            slots=4, max_len=48, fold=False, buckets=buckets),
            engine_worker="sync")
        for uid in range(4):
            sched.submit(Request(uid=uid, prompt=np.arange(6) % 256,
                                 max_new_tokens=30))
        sched.step()
        sched.step()
        ptrs = sched.slot_manager.buffer_pointers()
        for _ in range(6):
            sched.step()
            assert sched.slot_manager.buffer_pointers() == ptrs
        sched.shutdown()


def test_hybrid_splice_uses_each_leafs_batch_axis():
    """A prefilled single-row recurrentgemma cache spliced into slots 0
    and 2 of three equals the prefilled row along each leaf's own batch
    axis (axis 2 for ``rec_conv``/``rec_h``); the other rows are
    untouched; a move carries a row along the same axes."""
    _, _, pm, pp = pair("recurrentgemma-9b")
    axes = batch_axes(pm, 32)
    assert axes["rec_conv"] == axes["rec_h"] == 2
    assert axes["attn_k"] == axes["tail_h"] == 1 and axes["pos"] == 0
    sm = SlotManager(pm, 3, 32)
    with torch.inference_mode():
        one = pm.init_cache(1, 32, "cpu")
        pm.prefill(pp, {"tokens": torch.arange(7)[None] % 256}, one)
    st = lambda u: SlotState(uid=u, remaining=1, eos_id=-1, temperature=0.0)
    sm.admit(0, st(0), one)
    sm.admit(2, st(2), one)
    for name, leaf in sm.cache.items():
        ax = axes[name]
        for slot in (0, 2):
            assert torch.equal(leaf.narrow(ax, slot, 1), one[name]), name
        assert not leaf.narrow(ax, 1, 1).any(), name
    sm.evict(0)
    assert sm.compact() == [(2, 0)]
    for name, leaf in sm.cache.items():
        assert torch.equal(leaf.narrow(axes[name], 0, 1), one[name]), name


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def test_options_validation_and_mesh():
    for bad in (dict(slots=0), dict(admission="lifo"), dict(max_queue=0),
                dict(max_len=48, prefill_chunk=10), dict(prefill_chunk=0),
                dict(prefix_cache=4), dict(min_prefix=-1),
                dict(buckets=(1, 2))):
        with pytest.raises(ValueError):
            SchedulerOptions(**bad)
    from repro_torch.dist import MeshSpec
    meshed = SchedulerOptions(mesh="data=2")       # coerced (A.14b)
    assert meshed.mesh == MeshSpec.parse("data=2")
    assert SchedulerOptions(**meshed.to_dict()) == meshed
    assert meshed == SchedulerOptions(mesh={"data": 2})
    pol = BucketPolicy(batch_buckets=(1, 2))
    o = SchedulerOptions(buckets=pol, max_len=64, prefill_chunk=16,
                         prefix_cache=4, admission="deadline")
    assert SchedulerOptions(**o.to_dict()) == o
    from repro.serve import SchedulerOptions as RefOptions
    assert o.to_dict() == RefOptions(
        buckets=repro.BucketPolicy(batch_buckets=(1, 2)), max_len=64,
        prefill_chunk=16, prefix_cache=4, admission="deadline").to_dict()


def test_serve_entry_points():
    """``repro_torch.serve`` is the callable module and the package;
    ``exe.serve()`` returns a Scheduler; graph executables are refused;
    the precision record follows the executable."""
    assert repro_torch.serve.Scheduler is Scheduler
    assert repro_torch.SchedulerOptions is SchedulerOptions
    cfg = get_config(QWEN, smoke=True)
    exe = repro_torch.compile(cfg, target="engine", device="cpu",
                              precision="bf16")
    sched = exe.serve(slots=2, max_len=32)
    assert isinstance(sched, Scheduler) and sched.fold_report["folds"] > 0
    assert sched.device.type == "cpu"
    assert sched.summary()["precision"] == {
        "precision": "bf16", "decisions": exe.quant_report["decisions"]}
    sched.submit(Request(uid=0, prompt=A4, max_new_tokens=3))
    assert len(sched.run()[0].tokens) == 3
    mb = repro_torch.ModelBuilder().seed(0)
    g = repro_torch.compile(mb.build([mb.dense(mb.input((4,)), 2)]),
                            target="jit", device="cpu")
    with pytest.raises(TypeError, match="target='engine'"):
        repro_torch.serve(g)


def test_engine_shim_warns_once():
    import repro_torch.inference.engine as legacy
    _, _, pm, pp = pair(QWEN)
    legacy._warned = False
    with pytest.warns(DeprecationWarning, match="repro_torch.serve"):
        legacy.Engine(pm, pp, slots=1, max_len=32, fold=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy.Engine(pm, pp, slots=1, max_len=32, fold=False)
    assert not any(issubclass(w.category, DeprecationWarning)
                   for w in caught)


def test_temperature_sampler():
    from repro_torch.serve import TemperatureSampler
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0]])
    s = TemperatureSampler(0)
    assert s(logits, 0.0, uid=0, index=0) == 1      # the first maximum
    # a draw depends on (seed, uid, index) alone: not on the sampler
    # object, nor on the draws made before it
    draws = [TemperatureSampler(3)(logits, 1.0, uid=0, index=i)
             for i in range(2)]
    t = TemperatureSampler(3)
    seq = [t(logits, 1.0, uid=0, index=i) for i in range(20)]
    assert seq[:2] == draws
    assert [t(logits, 1.0, uid=0, index=i)
            for i in reversed(range(20))] == seq[::-1]
    assert set(seq) <= {0, 1, 2, 3} and len(set(seq)) > 1


def test_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", QWEN,
         "--smoke", "--device", "cpu", "--requests", "4", "--slots", "2",
         "--max-new", "6", "--json"], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    summ = json.loads(res.stdout)
    assert summ["completed"] == 4 and summ["total_new_tokens"] == 24
    from repro_torch.dist import MeshUnavailableError
    from repro_torch.launch.serve import main
    # --mesh is ported (A.14b): a 2-device mesh with no process group
    # (no torch.distributed.run) is a typed fault naming the axis
    with pytest.raises(MeshUnavailableError, match="data"):
        main(["--smoke", "--device", "cpu", "--mesh", "data=2"])


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.api.serve, "
        "repro_torch.serve.step, repro_torch.inference.engine, "
        "repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
