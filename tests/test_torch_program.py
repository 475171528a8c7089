"""The captured program (``core/program.py``) and what it leans on.

It imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_program.py

The tests marked ``cuda`` need an NVIDIA GPU (Hopper for the ``cuda``
target) and skip without one; ``chip_smoke.py`` holds the same
properties on the card at the main path's sizes.  The others run
anywhere: the split counters' ownership, the inputs a program refuses,
and the CPU's refusal of what only a card has.
"""

import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch.core import lowering, program
from repro_torch.core.lowering import LoweredGraph
from repro_torch.core.program import CapturedProgram
from repro_torch.kernels.fused_matmul import kernel as fm_kernel
from repro_torch.runtime import BucketPolicy
from repro_torch.table1_models import SUITE


def _x(graph, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch,) + tuple(graph.inputs["input"].shape)).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are captured on the "
                    "card only (chip_smoke.py runs these checks there)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Anywhere
# ---------------------------------------------------------------------------
def test_pool_lays_out_the_largest_batch_first(monkeypatch):
    # GraphPool.admit's order, with the capture stubbed: a batch larger
    # than every captured one releases the others, takes a fresh pool id
    # and captures them again after itself, largest first, on their own
    # static inputs; a smaller one just joins.  A recapture that fails
    # raises and leaves the programs not yet captured without a graph.
    captured, handles = [], iter(range(100))

    class Graph:
        def reset(self):
            pass

    class Eager:
        def __init__(self, batch):
            self.ctx = types.SimpleNamespace(batch_size=batch)

        def __call__(self, env):
            if self.ctx.batch_size == fail_at[0]:
                raise RuntimeError("capture failed")
            captured.append(self.ctx.batch_size)

    def fake_capture(fn, device, pool):
        fn()
        pool.bytes += 1
        return Graph(), {}, 1

    fail_at = [None]
    monkeypatch.setattr(program, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    pool = program.GraphPool(torch.device("cuda"))
    held = []
    for b in (129, 200, 150, 256, 137):
        held.append(pool.admit(Eager(b), {}, held))
    assert captured == [129, 200, 129, 150, 256, 200, 150, 129, 137]
    assert pool.handle == 2 and pool.bytes == 5
    assert [p.batch for p in held] == [129, 200, 150, 256, 137]
    assert all(p.graph is not None and p.pool is pool for p in held)
    fail_at[0] = 150
    with pytest.raises(RuntimeError, match="capture failed"):
        pool.admit(Eager(300), {}, held)
    assert sorted(p.batch for p in held if p.graph is None) == [129, 137,
                                                                  150]


def test_split_counters_grow_without_freeing():
    owner = fm_kernel.SplitCounters()
    cpu = torch.device("cpu")
    small = owner.get(cpu, 10)
    assert small.numel() == 1024 and not small.any()
    assert owner.get(cpu, 1000) is small      # fits: the same buffer
    big = owner.get(cpu, 5000)
    assert big.numel() == 5000 and big is not small
    # The outgrown buffer stays held: a graph captured with its address
    # keeps reading memory that nothing else was handed.
    assert any(t is small for t in owner._bufs[cpu])
    assert owner.get(cpu, 10) is big


def test_programs_own_their_split_counters(monkeypatch):
    # Each batch size's program hands its own context's counters to every
    # dense kernel it calls; a direct wrapper call has the shared ones.
    seen = []
    real = lowering.fused_matmul

    def spy(*a, counters=None, **kw):
        seen.append(counters)
        return real(*a, counters=counters, **kw)

    monkeypatch.setattr(lowering, "fused_matmul", spy)
    g = SUITE["C-BH"]()
    exe = repro_torch.compile(g, target="cuda", device="cpu")
    dense = sum(n.op == "dense" for n in exe.graph.nodes)
    exe(input=_x(g, 1))
    exe(input=_x(g, 2))
    p1, p2 = exe.ensure_compiled(1), exe.ensure_compiled(2)
    assert seen == [p1.ctx.counters] * dense + [p2.ctx.counters] * dense
    assert p1.ctx.counters is not p2.ctx.counters
    assert isinstance(fm_kernel.SHARED_COUNTERS, fm_kernel.SplitCounters)


def test_lowered_graphs_hold_distinct_counters():
    exe = repro_torch.compile(SUITE["C-BH"](), target="cuda", device="cpu")
    p1, p2 = exe.ensure_compiled(1), exe.ensure_compiled(2)
    assert isinstance(p1, LoweredGraph)
    assert p1.ctx.counters is not p2.ctx.counters


def _decode_graph(h=4, hkv=2, d=8, s=16):
    mb = repro_torch.ModelBuilder()
    q = mb.input((h, d), name="q")
    k = mb.input((s, hkv, d), name="k")
    v = mb.input((s, hkv, d), name="v")
    lengths = mb.input((), name="lengths", dtype="int32")
    return mb.build([mb.decode_attention(q, k, v, lengths)])


def _decode_feeds(batch, kv_batch, seed=0):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((batch, 4, 8)).astype(np.float32),
            "k": rng.standard_normal((kv_batch, 16, 2, 8)).astype(np.float32),
            "v": rng.standard_normal((kv_batch, 16, 2, 8)).astype(np.float32),
            "lengths": np.full((batch,), 9, np.int32)}


@pytest.mark.parametrize("kw", [
    dict(target="interpret"), dict(target="jit"), dict(target="cuda"),
    dict(target="cuda", batch_buckets=(8,)),
    dict(target="cuda", buckets=BucketPolicy(batch_buckets=(8,))),
], ids=["interpret", "jit", "cuda", "batch_buckets", "buckets"])
def test_inputs_must_share_the_batch(kw):
    # One KV cache beside a batch of 4 queries: refused, where a copy
    # into the static inputs would broadcast it over every row.
    exe = repro_torch.compile(_decode_graph(), device="cpu", **kw)
    with pytest.raises(ValueError, match="disagree on the batch"):
        exe(**_decode_feeds(4, 1))
    (out,) = exe(**_decode_feeds(4, 4)).values()
    assert tuple(out.shape) == (4, 4, 8)
    if "buckets" in kw:
        exe.shutdown()


def _bare_program(batch=4):
    """A CapturedProgram's input side alone (no graph): what its call
    checks before it copies anything, testable on the CPU."""
    prog = CapturedProgram.__new__(CapturedProgram)
    prog.batch = batch
    prog.static_inputs = {
        "q": torch.zeros((batch, 4, 8)),
        "k": torch.zeros((batch, 16, 2, 8)),
        "lengths": torch.zeros((batch,), dtype=torch.int32)}
    return prog


@pytest.mark.parametrize("case", [
    "broadcast", "dtype", "rows_over_batch", "rows_zero", "missing",
    "unknown"])
def test_captured_program_refuses_mismatched_inputs(case):
    prog = _bare_program()
    env = {n: torch.zeros_like(t) for n, t in prog.static_inputs.items()}
    rows = None
    if case == "broadcast":
        env["k"] = torch.zeros((1, 16, 2, 8))
    elif case == "dtype":
        env["lengths"] = torch.zeros((4,), dtype=torch.int64)
    elif case == "rows_over_batch":
        env = {n: torch.cat([t, t[:1]]) for n, t in env.items()}
        rows = 5
    elif case == "rows_zero":
        env = {n: t[:0] for n, t in env.items()}
        rows = 0
    elif case == "missing":
        del env["q"]
    else:
        env["extra"] = torch.zeros((4,))
    with pytest.raises(ValueError):
        prog(env, rows=rows)
    prog._check({n: t[:3] for n, t in prog.static_inputs.items()}, 3)


def test_the_cpu_runs_the_eager_program():
    g = SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="cuda", device="cpu")
    x = _x(g, 2)
    out = exe(input=x)
    assert isinstance(exe.ensure_compiled(2), LoweredGraph)
    assert exe.cost_summary()["programs"] == {2: {"captured": False}}
    with pytest.raises(ValueError, match="CUDA device"):
        exe.input_buffers(2)
    prog = exe.ensure_compiled(2)
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedProgram(prog, {"input": (tuple(g.inputs["input"].shape),
                                         torch.float32)},
                        torch.device("cpu"))
    (want,) = prog({"input": torch.from_numpy(x)}).values()
    (got,) = out.values()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _compile(name, target="cuda", **kw):
    return repro_torch.compile(SUITE[name](), target=target, device="cuda",
                               **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast", "int8", "bf16"])
@pytest.mark.parametrize("name", ["C-HTWK", "C-BH"])
def test_replay_bit_equal_to_eager_with_fresh_outputs(card, name, precision):
    exe = _compile(name, precision=precision)
    prog = exe.ensure_compiled(4)
    assert isinstance(prog, CapturedProgram)
    x1, x2 = _x(exe.source, 4, 1), _x(exe.source, 4, 2)
    out1 = exe(input=x1)
    keep = {k: v.clone() for k, v in out1.items()}
    out2 = exe(input=x2)
    for x, out in ((x1, out1), (x2, out2)):
        want = prog.eager({"input": torch.from_numpy(x).to(card)})
        for k, opt in zip(exe.source.output_names, exe.graph.outputs):
            assert torch.equal(out[k], want[opt])
    for k in keep:                            # the second call overwrote
        assert torch.equal(out1[k], keep[k])  # nothing the caller held


@pytest.mark.cuda
def test_static_input_skips_the_copy(card):
    exe = _compile("C-BH")
    bufs = exe.input_buffers(2)
    x = torch.from_numpy(_x(exe.source, 2)).to(card)
    bufs["input"].copy_(x)
    assert torch.equal(exe(input=bufs["input"])[exe.source.output_names[0]],
                       exe(input=x)[exe.source.output_names[0]])


@pytest.mark.cuda
def test_bucket_rows_fill_the_static_input(card):
    exe = _compile("C-HTWK", batch_buckets=(8,))
    x = _x(exe.source, 8, 3)
    full = exe(input=x)
    part = exe(input=x[:3])                   # rows 3..7 zeroed, cut back
    padded = np.zeros_like(x)
    padded[:3] = x[:3]
    want = exe(input=padded)
    for k in full:
        assert part[k].shape[0] == 3
        assert torch.equal(part[k], want[k][:3])


@pytest.mark.cuda
def test_replays_count_their_launches(card):
    # The wrapper counts the calls that launched its kernel: the warm-up
    # and the capture.  A replay passes through no wrapper; the profiler
    # sees each of its kernels by name.
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fused_matmul.ops import fused_matmul
    exe = _compile("C-HTWK")
    dense = sum(n.op == "dense" for n in exe.graph.nodes)
    before = fused_matmul.launches
    exe.ensure_compiled(1)
    assert fused_matmul.launches - before == 2 * dense
    x = _x(exe.source, 1)
    exe(input=x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            exe(input=x)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if "fm_gemv_kernel<" in e.key or "fm_tiled_kernel<" in e.key)
    assert kernels == 3 * dense
    assert fused_matmul.launches - before == 2 * dense


@pytest.mark.cuda
def test_captured_program_refuses_mismatched_batches(card):
    exe = repro_torch.compile(_decode_graph(), target="cuda", device="cuda")
    with pytest.raises(ValueError, match="disagree on the batch"):
        exe(**_decode_feeds(4, 1))
    prog = exe.ensure_compiled(4)
    env = {n: torch.from_numpy(a).to(card)
           for n, a in _decode_feeds(4, 1).items()}
    with pytest.raises(ValueError, match="'k'"):
        prog(env)
    env = {n: torch.from_numpy(a).to(card)
           for n, a in _decode_feeds(4, 4).items()}
    (want,) = prog.eager(env).values()
    (got,) = prog(env).values()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_device_sync_during_background_capture(card, monkeypatch):
    # A device-wide synchronize while a cold bucket is captured in the
    # background: CUDA may refuse it and fail that capture.  Whatever it
    # does, no failed graph stays in the cache, the bucket is captured
    # again at a later call, and every answer is right.
    real = torch.cuda.graph
    capturing, synced = threading.Event(), threading.Event()
    held = []

    class graph(real):
        def __enter__(self):
            super().__enter__()
            if not held:                      # hold the first capture open
                held.append(threading.current_thread().name)
                capturing.set()
                synced.wait(timeout=60.0)

    exe = _compile("C-BH", buckets=BucketPolicy(batch_buckets=(1, 64)))
    exe.ensure_compiled(64)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    x = _x(exe.source, 1)
    served = [exe(input=x)]                   # on 64; 1 captured behind
    assert capturing.wait(timeout=60.0)
    try:
        torch.cuda.synchronize()
        refused = None
    except RuntimeError as err:
        refused = str(err)
    finally:
        synced.set()
    assert exe.wait_warm(timeout=120.0)
    torch.cuda.current_stream().synchronize()
    for _ in range(2):                        # a failed bucket recaptures
        served.append(exe(input=x))
        assert exe.wait_warm(timeout=120.0)
    served.append(exe(input=x))
    torch.cuda.synchronize()                  # nothing capturing now
    assert held and held[0] != threading.current_thread().name
    prog = exe.inner.ensure_compiled(1)
    assert isinstance(prog, CapturedProgram)
    xt = torch.from_numpy(x).to(card)
    want = prog.eager({"input": xt})
    (name,) = exe.source.output_names
    (opt,) = exe.inner.graph.outputs
    assert torch.equal(served[-1][name], want[opt])
    assert torch.equal(prog({"input": xt})[opt], want[opt])
    for out in served:
        assert torch.allclose(out[name], want[opt], rtol=0, atol=1e-5)
    s = exe.runtime_stats()
    print(f"device sync during capture: refused={refused!r} stats={s}")
    assert s["compile_stalls"] == 0
    assert str(exe.policy.bucket_for(1)) in s["warm_buckets"]
    exe.shutdown()


@pytest.mark.cuda
def test_background_capture_while_replaying(card):
    exe = _compile("C-BH", buckets=BucketPolicy(batch_buckets=(1, 64)))
    exe.ensure_compiled(64)
    x = _x(exe.source, 1)
    served = exe(input=x)                     # b1 captured in background
    assert exe.wait_warm(timeout=120.0)
    again = exe(input=x)
    s = exe.runtime_stats()
    assert (s["fallback_serves"], s["bucket_hits"], s["compile_stalls"]) \
        == (1, 1, 0)
    for k in served:
        assert torch.allclose(served[k], again[k], rtol=0, atol=1e-5)
    exe.shutdown()


@pytest.mark.cuda
def test_programs_share_one_pool_within_its_bound(card):
    """The programs of one executable capture into one pool: in whatever
    order the batch sizes arrive, the reserved memory grows by the
    largest batch's pool and the programs' static inputs and outputs
    (10% slack), not by one pool a batch size; every program replays
    bit-equal to its eager walk in any order, its outputs unchanged by
    calls to the others and by the pool's relayouts."""
    import random

    batches = (256, 129, 200, 150, 241, 176, 137, 222)
    orders = (batches, tuple(sorted(batches)),
              tuple(random.Random(3).sample(batches, len(batches))))
    # The process's one-time set-up (cuDNN and cuBLAS handles and their
    # workspaces) happens on another executable, outside the growth.
    warm = _compile("VGG19")
    warm(input=_x(warm.source, 1))
    feeds = {b: _x(warm.source, b, b) for b in batches}
    for arrival in orders:
        exe = _compile("VGG19")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        first = {b: exe(input=feeds[b]) for b in arrival}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        growth = torch.cuda.memory_reserved() - before
        progs = {b: exe.ensure_compiled(b) for b in batches}
        assert len({id(p.pool) for p in progs.values()}) == 1
        statics = sum(t.numel() * t.element_size() for p in progs.values()
                      for t in list(p.static_inputs.values())
                      + list(p.static_outputs.values()))
        assert growth <= (progs[256].pool_bytes + statics) * 1.1, arrival
        assert exe.cost_summary()["graph_pool_bytes"] == sum(
            p.pool_bytes for p in progs.values())
        order = list(reversed(batches)) + random.Random(0).sample(
            batches, len(batches))
        (opt,) = exe.graph.outputs
        (pub,) = exe.source.output_names
        for b in order:
            out = exe(input=feeds[b])
            eager = progs[b].eager(
                {"input": torch.from_numpy(feeds[b]).to(card)})
            assert torch.equal(out[pub], eager[opt])
            assert torch.equal(out[pub], first[b][pub])
        del exe, progs, first


@pytest.mark.cuda
def test_two_threads_two_batches_two_streams(card):
    """Two threads call one executable at two batch sizes, each on a
    stream of its own: every replay waits on the card for the previous
    one, so the two programs, which share intermediates, never overlap,
    and every answer is bit-equal to the serial calls'."""
    exe = _compile("C-BH")
    feeds = {b: _x(exe.source, b, b) for b in (3, 17)}
    want = {b: exe(input=feeds[b]) for b in feeds}
    got, errors = {b: [] for b in feeds}, []

    def serve(b):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(50):
                    got[b].append(exe(input=feeds[b]))
                torch.cuda.current_stream().synchronize()
        except Exception as err:          # reported below
            errors.append(err)

    threads = [threading.Thread(target=serve, args=(b,)) for b in feeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for b, outs in got.items():
        assert len(outs) == 50
        for out in outs:
            for k in out:
                assert torch.equal(out[k], want[b][k])
