"""repro_torch.runtime and batch buckets against repro.runtime.

The bucket policy and the engine cache are pure Python, copied from the
reference: the same calls must give the same answers and counters.
Bucketed compiles run on the CPU (``device="cpu"``: the eager program,
every kernel's plain version) and are held to the reference's ``jit``
and ``pallas`` compiles with the same buckets within 1e-5, and bit for
bit to the port's own program on an explicitly padded input.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
from repro.runtime import BucketPolicy as RefPolicy
from repro.runtime import EngineCache as RefEngineCache
from repro.runtime import powers_of_two as ref_powers_of_two
from benchmarks.table1_models import SUITE as REF_SUITE

import repro_torch
from repro_torch.runtime import Bucket, BucketPolicy, EngineCache, powers_of_two
from repro_torch.runtime.bucketed import BucketedExecutable
from repro_torch.table1_models import SUITE as PORT_SUITE

ATOL = 1e-5


def _x(graph, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch,) + tuple(graph.inputs["input"].shape)).astype(np.float32)


def _out(d):
    (v,) = d.values()
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# BucketPolicy: the same arithmetic as the reference's
# ---------------------------------------------------------------------------
POLICIES = [dict(batch_buckets=(1, 2, 4, 8)),
            dict(batch_buckets=(4, 1, 2, 2)),
            dict(batch_buckets=(1, 4, 16, 64, 256)),
            dict(batch_buckets=(3,)),
            dict(batch_buckets=(1, 4), len_buckets=(8, 32)),
            dict(batch_buckets=(2, 8), len_buckets=(16, 48, 64))]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_matches_reference(kw):
    port, ref = BucketPolicy(**kw), RefPolicy(**kw)
    assert port.to_dict() == ref.to_dict()
    assert [tuple(b) for b in port.enumerate_buckets()] == \
        [tuple(b) for b in ref.enumerate_buckets()]
    assert [str(b) for b in port.enumerate_buckets()] == \
        [str(b) for b in ref.enumerate_buckets()]
    for batch in (1, 2, 3, 4, 5, 8, 9, 17, 100, 256, 300):
        for length in (None, 1, 8, 9, 33, 64, 100):
            got = port.bucket_for(batch, length)
            want = ref.bucket_for(batch, length)
            assert tuple(got) == tuple(want)
            assert port.covers(got) == ref.covers(want)
            assert BucketPolicy.pad_waste(batch, length, got) == \
                RefPolicy.pad_waste(batch, length, want)
    for cap in ((None, None), (3, None), (4, 40), (1, 8), (300, 100)):
        assert port.clip(*cap).to_dict() == ref.clip(*cap).to_dict()
    assert BucketPolicy.from_dict(ref.to_dict()) == port


@pytest.mark.parametrize("lo,hi", [(1, 8), (1, 6), (3, 3), (2, 100),
                                   (1, 256)])
def test_powers_of_two_match_reference(lo, hi):
    assert powers_of_two(lo, hi) == ref_powers_of_two(lo, hi)


@pytest.mark.parametrize("kw", [dict(batch_buckets=()),
                                dict(batch_buckets=(0, 2)),
                                dict(batch_buckets=(2,), len_buckets=(-8,))])
def test_policy_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        RefPolicy(**kw)
    with pytest.raises(ValueError):
        BucketPolicy(**kw)


def test_policy_default_matches_reference():
    for args in ((8,), (6, 100), (256, 64, 8)):
        assert BucketPolicy.default(*args).to_dict() == \
            RefPolicy.default(*args).to_dict()


# ---------------------------------------------------------------------------
# EngineCache: one sequence of gets, the same counters on both packages
# ---------------------------------------------------------------------------
class TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _miss_falls_back_then_swaps_in(cache, mk):
    cache.put(mk(4), ("prog", 4))
    trace = [cache.get(2)[1:]]                # cold b2: served on b4
    trace.append(cache.drain())               # background compile lands
    trace.append(cache.get(2)[1:])            # now an exact hit
    return trace


def _stall_when_nothing_covers(cache, mk):
    trace = [cache.get(3)]                    # empty cache: stall
    trace.append(cache.get(3))                # warm now
    return trace


def _fallback_never_uses_smaller_bucket(cache, mk):
    cache.put(mk(1), 1)
    return [cache.get(2)[1:]]                 # b1 warm but too small


def _warm_up_blocking(cache, mk):
    cache.warm_up(block=True)
    trace = [cache.warm_buckets(), cache.wait_warm(timeout=1.0)]
    trace += [cache.get(b)[1:] for b in (1, 2, 3, 4, 5)]
    return trace


def _mixed_traffic(cache, mk):
    cache.put(mk(8), 8)
    trace = [cache.get(b)[1:] for b in (1, 2, 3, 8, 9)]
    trace.append(cache.drain(max_items=2))
    trace += [cache.get(b)[1:] for b in (1, 2, 3, 4)]
    trace.append(cache.drain())
    cache.reset_counters()
    trace += [cache.get(b)[1:] for b in (1, 2, 4, 8, 9)]
    return trace


SEQUENCES = {
    "miss_falls_back_then_swaps_in": (_miss_falls_back_then_swaps_in,
                                      (1, 2, 4)),
    "stall_when_nothing_covers": (_stall_when_nothing_covers, (1, 4)),
    "fallback_never_uses_smaller_bucket": (
        _fallback_never_uses_smaller_bucket, (1, 2, 4)),
    "warm_up_blocking": (_warm_up_blocking, (1, 2, 4)),
    "mixed_traffic": (_mixed_traffic, (1, 2, 4, 8)),
}


def _normalise(trace):
    """Buckets of either package as plain tuples."""
    if isinstance(trace, tuple) and hasattr(trace, "_fields"):
        return tuple(trace)
    if isinstance(trace, (list, tuple)):
        return [_normalise(t) for t in trace]
    return trace


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_engine_cache_counters_match_reference(name):
    seq, batches = SEQUENCES[name]
    results = []
    for policy_cls, cache_cls, bucket_cls in (
            (RefPolicy, RefEngineCache, type(RefPolicy().bucket_for(1))),
            (BucketPolicy, EngineCache, Bucket)):
        cache = cache_cls(policy_cls(batch_buckets=batches),
                          build=lambda b: ("built", b.batch),
                          worker="manual", clock=TickClock())
        trace = seq(cache, lambda b: bucket_cls(b))
        results.append((_normalise(trace), cache.stats()))
    (ref_trace, ref_stats), (port_trace, port_stats) = results
    assert port_trace == ref_trace
    assert port_stats == ref_stats


def test_engine_cache_build_failure_surfaces_and_allows_retry():
    calls = []

    def build(b):
        calls.append(b)
        if len(calls) < 3:
            raise RuntimeError("flaky toolchain")
        return "ok"

    cache = EngineCache(BucketPolicy(batch_buckets=(2,)), build,
                        worker="manual")
    with pytest.raises(RuntimeError):
        cache.get(2)
    assert cache.get(2)[0] == "ok"            # in-flight mark was dropped


def test_engine_cache_thread_worker_swaps_in():
    import threading
    gate = threading.Event()

    def build(b):
        if b.batch == 2:
            assert gate.wait(timeout=30.0)
        return b.batch

    cache = EngineCache(BucketPolicy(batch_buckets=(1, 2, 4)), build,
                        worker="thread")
    cache.put(Bucket(4), 4)
    assert cache.get(2)[1] == Bucket(4)       # served while b2 builds
    gate.set()
    assert cache.wait_warm(timeout=30.0)
    assert cache.get(2)[1] == Bucket(2)
    s = cache.stats()
    assert (s["fallback_serves"], s["background_compiles"],
            s["compile_stalls"], s["bucket_hits"]) == (1, 1, 0, 1)
    cache.shutdown()


# ---------------------------------------------------------------------------
# batch_buckets on the jit and cuda targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["C-HTWK", "C-BH"])
@pytest.mark.parametrize("port_target,ref_target", [("jit", "jit"),
                                                    ("cuda", "pallas")])
def test_batch_buckets_match_reference(name, port_target, ref_target):
    buckets = (4, 8)
    ref = repro.compile(REF_SUITE[name](), repro.CompileOptions(
        target=ref_target, batch_buckets=buckets))
    exe = repro_torch.compile(PORT_SUITE[name](), target=port_target,
                              device="cpu", batch_buckets=buckets)
    g = exe.source
    for batch in (1, 3, 4, 5, 8, 10):
        x = _x(g, batch, seed=batch)
        got = _out(exe(input=x))
        assert got.shape[0] == batch
        np.testing.assert_allclose(got, _out(ref(input=x)), rtol=0,
                                   atol=ATOL)
        # Bit-equal to the bucket's own program on zero-padded input.
        bucket = next((b for b in buckets if b >= batch), batch)
        padded = np.zeros((bucket,) + x.shape[1:], np.float32)
        padded[:batch] = x
        prog = exe.ensure_compiled(bucket)
        want = prog({"input": torch.from_numpy(padded)})
        (want,) = want.values()
        np.testing.assert_array_equal(got, want[:batch].numpy())
    assert sorted(exe._programs) == [4, 8, 10]


def test_batch_buckets_validation():
    with pytest.raises(ValueError):
        repro_torch.CompileOptions(batch_buckets=(0, 4), device="cpu")
    opts = repro_torch.CompileOptions(batch_buckets=(8, 2, 4), device="cpu")
    assert opts.batch_buckets == (2, 4, 8)


# ---------------------------------------------------------------------------
# BucketedExecutable
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("target", ["jit", "cuda"])
def test_bucketed_fallback_bit_equal_to_explicit_padding(target):
    g = PORT_SUITE["C-HTWK"]()
    x = _x(g, 2, seed=3)
    exact = repro_torch.compile(g, target=target, device="cpu")
    padded = np.zeros((4,) + x.shape[1:], np.float32)
    padded[:2] = x
    want = _out(exact(input=padded))[:2]

    inner = repro_torch.compile(g, target=target, device="cpu")
    exe = BucketedExecutable(inner, BucketPolicy(batch_buckets=(1, 2, 4)),
                             worker="manual")
    exe.ensure_compiled(4)                    # only b4 is warm
    got = _out(exe(input=x))                  # b2 cold: served on b4
    s = exe.runtime_stats()
    assert s["fallback_serves"] == 1 and s["warm_buckets"] == ["b4"]
    np.testing.assert_array_equal(want, got)

    exe._cache.drain()                        # b2 swaps in
    got2 = _out(exe(input=x))
    s = exe.runtime_stats()
    assert s["bucket_hits"] == 1 and "b2" in s["warm_buckets"]
    np.testing.assert_array_equal(_out(exact(input=x)), got2)
    exe.shutdown()


def test_bucketed_matches_reference_bucketed():
    pol = dict(batch_buckets=(1, 4, 16))
    ref = repro.compile(REF_SUITE["C-BH"](), repro.CompileOptions(
        target="pallas", buckets=RefPolicy(**pol)))
    exe = repro_torch.compile(PORT_SUITE["C-BH"](), target="cuda",
                              device="cpu", buckets=BucketPolicy(**pol))
    exe.warm_up(block=True)
    for batch in (1, 3, 16):
        x = _x(exe.source, batch, seed=batch)
        np.testing.assert_allclose(_out(exe(input=x)), _out(ref(input=x)),
                                   rtol=0, atol=ATOL)
    assert exe.runtime_stats()["warm_buckets"] == ["b1", "b4", "b16"]
    ref.shutdown()
    exe.shutdown()


def test_bucketed_overflow_batch_compiles_exact():
    g = PORT_SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="jit", device="cpu",
                              buckets=BucketPolicy(batch_buckets=(1, 2)))
    x = _x(g, 5)
    out = _out(exe(input=x))                  # above the largest bucket
    assert out.shape[0] == 5
    assert "b5" in exe.runtime_stats()["warm_buckets"]
    want = _out(repro_torch.compile(g, target="jit", device="cpu")(input=x))
    np.testing.assert_array_equal(want, out)
    exe.shutdown()


def test_bucketed_thread_worker_serves_warm_bucket_while_cold_one_builds():
    g = PORT_SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="cuda", device="cpu",
                              buckets=BucketPolicy(batch_buckets=(1, 4)))
    exe.ensure_compiled(4)
    x = _x(g, 1, seed=5)
    first = _out(exe(input=x))                # b1 cold: served on b4
    assert exe.wait_warm(timeout=60.0)
    second = _out(exe(input=x))               # b1 warm now
    s = exe.runtime_stats()
    assert (s["fallback_serves"], s["bucket_hits"],
            s["compile_stalls"]) == (1, 1, 0)
    np.testing.assert_allclose(first, second, rtol=0, atol=ATOL)
    exe.shutdown()


def test_compile_options_buckets_validation():
    policy = BucketPolicy(batch_buckets=(1, 2))
    with pytest.raises(ValueError):
        repro_torch.CompileOptions(buckets=policy, batch_buckets=(1, 2),
                                   device="cpu")      # mutually exclusive
    with pytest.raises(ValueError):
        repro_torch.CompileOptions(buckets="b4", device="cpu")
    opts = repro_torch.CompileOptions(buckets=policy.to_dict(), device="cpu")
    assert opts.buckets == policy
    with pytest.raises(TypeError):
        repro_torch.compile(PORT_SUITE["C-HTWK"](), target="interpret",
                            device="cpu", buckets=policy)
    with pytest.raises(ValueError):               # a serving-only knob
        BucketedExecutable(
            repro_torch.compile(PORT_SUITE["C-HTWK"](), target="jit",
                                device="cpu"),
            BucketPolicy(batch_buckets=(1,), len_buckets=(8,)))
