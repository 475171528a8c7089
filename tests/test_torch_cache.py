"""repro_torch's executable cache and serialization.

On the CPU (``device="cpu"``): a serialized executable comes back with
bit-equal outputs; a second compile with the same cache directory takes
the pass pipeline's output from disk (no pipeline, no int8 calibration)
and gives bit-equal outputs; the key follows the options, the weights,
the batch and the environment; a corrupt entry degrades to a compile;
``prune`` sweeps least recently used entries.  Compiles with the
reference package (``repro``) show that neither package reads the
other's bytes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro

import repro_torch
from repro_torch.api import cache as cache_mod
from repro_torch.api import targets as targets_mod
from repro_torch.api.cache import ExecutableCache, prune
from repro_torch.runtime import BucketPolicy
from repro_torch.runtime.bucketed import BucketedExecutable
from repro_torch.table1_models import SUITE as PORT_SUITE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(graph, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch,) + tuple(graph.inputs["input"].shape)).astype(np.float32)


def _outs(d):
    return {k: v.numpy() for k, v in d.items()}


def _equal(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["exact", "int8"])
@pytest.mark.parametrize("target", ["interpret", "jit", "cuda"])
def test_serialize_round_trip_bit_equal(target, precision):
    g = PORT_SUITE["C-BH"]()
    x = _x(g, 3)
    exe = repro_torch.compile(g, target=target, precision=precision,
                              device="cpu")
    blob = exe.serialize()
    assert blob.startswith(b"REPROTORCHEXE1\n")
    exe2 = repro_torch.deserialize(blob)
    assert type(exe2) is type(exe)
    assert exe2.options == exe.options
    _equal(_outs(exe(input=x)), _outs(exe2(input=x)))


def test_bucketed_serialize_round_trip(tmp_path):
    pol = BucketPolicy(batch_buckets=(1, 4))
    g = PORT_SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="cuda", device="cpu", buckets=pol,
                              cache_dir=str(tmp_path))
    x = _x(g, 3)
    want = _outs(exe(input=x))
    blob = exe.serialize()
    meta = json.loads(blob.split(b"\n", 2)[1])
    assert meta["kind"] == "bucketed"
    assert meta["artifacts"] == {"b1": exe.inner.disk_key(1),
                                 "b4": exe.inner.disk_key(4)}
    exe2 = repro_torch.deserialize(blob)
    assert isinstance(exe2, BucketedExecutable)
    assert exe2.policy == pol
    _equal(want, _outs(exe2(input=x)))
    exe.shutdown()
    exe2.shutdown()


@pytest.mark.parametrize("blob", [b"not an executable", b"",
                                  b"REPROTORCHEXE1\n{not json\n",
                                  b"REPROTORCHEXE1\n{\"format\": \"x\"}\n",
                                  b"REPROTORCHEXE1\n[1, 2]\n",
                                  b"REPROTORCHEXE1\n{\"format\": "
                                  b"\"repro-torch-executable\"}\n"])
def test_deserialize_rejects_garbage(blob):
    with pytest.raises(ValueError):
        repro_torch.deserialize(blob)


def test_deserialize_rejects_a_reference_blob():
    from benchmarks.table1_models import SUITE as REF_SUITE
    blob = repro.compile(REF_SUITE["C-HTWK"](),
                         repro.CompileOptions(target="jit")).serialize()
    with pytest.raises(ValueError, match="JAX package"):
        repro_torch.deserialize(blob)
    port_blob = repro_torch.compile(PORT_SUITE["C-HTWK"](), target="jit",
                                    device="cpu").serialize()
    with pytest.raises(ValueError):
        repro.deserialize(port_blob)


def test_deserialize_ignores_embedded_cache_dir(tmp_path):
    g = PORT_SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="jit", device="cpu",
                              cache_dir=str(tmp_path), dump_ir=str(tmp_path))
    exe2 = repro_torch.deserialize(exe.serialize())
    assert exe2.options.cache_dir is None
    assert exe2.options.dump_ir is None


@pytest.mark.parametrize("kind,item", [("sharded", "A.14"),
                                       ("engine", "A.12")])
def test_unported_kinds_raise(kind, item):
    """What the port cannot load yet names its ROADMAP item: the sharded
    kind (A.14), and an engine artifact of a family still to port (the
    engine kind itself loads since A.12; its SSM/hybrid/audio families
    are A.12b)."""
    import dataclasses
    from repro_torch.api.executable import pack
    from repro_torch.configs import get_config
    extra = None
    if kind == "engine":
        extra = {"cfg": dataclasses.asdict(get_config("mamba2-780m",
                                                      smoke=True)),
                 "leaf_dtypes": []}
    blob = pack(kind, repro_torch.CompileOptions(device="cpu"), b"",
                extra=extra)
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.deserialize(blob)


# ---------------------------------------------------------------------------
# The disk cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["exact", "fast", "int8", "bf16"])
@pytest.mark.parametrize("target", ["jit", "cuda"])
def test_second_compile_hits_and_runs_no_pipeline(tmp_path, monkeypatch,
                                                  target, precision):
    g = PORT_SUITE["C-HTWK"]()
    x = _x(g, 2)
    opts = dict(target=target, precision=precision, device="cpu",
                cache_dir=str(tmp_path))
    e1 = repro_torch.compile(g, **opts)
    want = _outs(e1(input=x))
    info = e1.cache_info()
    assert (info["hits"], info["misses"]) == (0, 2)
    assert info["graph"] == "miss" and info["programs"] == {2: "miss"}

    def refuse(*a, **kw):
        raise AssertionError("the pass pipeline ran")
    monkeypatch.setattr(targets_mod, "run_pipeline", refuse)
    if precision == "int8":   # the calibration walk is in the pipeline
        monkeypatch.setattr(sys.modules["repro_torch.core.passes.quantize"],
                            "_calibrate", refuse)
    e2 = repro_torch.compile(g, **opts)
    got = _outs(e2(input=x))
    info = e2.cache_info()
    assert (info["hits"], info["misses"]) == (2, 0)
    assert info["graph"] == "hit" and info["programs"] == {2: "hit"}
    _equal(want, got)
    s1, s2 = e1.cost_summary(), e2.cost_summary()
    for k in ("nodes", "params", "param_bytes", "pipeline", "memory_plan",
              "kernel_selection", "quant"):
        assert json.dumps(s1.get(k)) == json.dumps(s2.get(k))
    assert e2.graph.structure_hash() == e1.graph.structure_hash()


def test_key_follows_options_weights_batch_and_environment(tmp_path,
                                                          monkeypatch):
    g = PORT_SUITE["C-HTWK"]()
    base = repro_torch.compile(g, target="cuda", device="cpu",
                               cache_dir=str(tmp_path))
    keys = {base.disk_key(1)}
    assert base.disk_key(1) == repro_torch.compile(
        g, target="cuda", device="cpu", cache_dir=str(tmp_path)).disk_key(1)
    keys.add(base.disk_key(2))                               # batch
    for kw in (dict(precision="fast"), dict(target="jit"),
               dict(precision="int8"), dict(precision="int8", calibrate=2)):
        opts = dict(target="cuda", device="cpu", cache_dir=str(tmp_path))
        opts.update(kw)
        keys.add(repro_torch.compile(g, **opts).disk_key(1))  # options
    g2 = PORT_SUITE["C-HTWK"]()
    k = sorted(g2.params)[0]
    g2.params[k] = g2.params[k] + 1.0
    keys.add(repro_torch.compile(g2, target="cuda", device="cpu",
                                 cache_dir=str(tmp_path)).disk_key(1))
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")  # environment
    keys.add(repro_torch.compile(g, target="cuda", device="cpu",
                                 cache_dir=str(tmp_path)).disk_key(1))
    monkeypatch.undo()

    class OtherLibrary:
        name = "librepro_torch_0000000000000000.so"
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "library_path", lambda: OtherLibrary)
    keys.add(repro_torch.compile(g, target="cuda", device="cpu",
                                 cache_dir=str(tmp_path)).disk_key(1))
    assert len(keys) == 9
    # Not part of the key: where the cache lives, and how batches bucket.
    monkeypatch.undo()
    assert repro_torch.compile(
        g, target="cuda", device="cpu", cache_dir=str(tmp_path / "elsewhere"),
        batch_buckets=(4,)).disk_key(1) == base.disk_key(1)


def test_environment_part_names_the_kernel_library():
    from repro_torch.kernels import build
    env = cache_mod.environment("cpu")
    assert env[1] == f"torch {torch.__version__}"
    assert env[2] == "cpu"
    assert env[3] == build.library_path().name


def test_corrupt_entry_degrades_to_compile(tmp_path):
    g = PORT_SUITE["C-HTWK"]()
    x = _x(g, 1)
    opts = dict(target="cuda", device="cpu", cache_dir=str(tmp_path))
    want = _outs(repro_torch.compile(g, **opts)(input=x))
    entries = sorted(tmp_path.glob("*.entry"))
    assert len(entries) == 2
    for i, f in enumerate(entries):   # one unframed, one not an npz
        f.write_bytes(b"corrupt" if i else
                      cache_mod.MAGIC + b"\n{}\nnot an npz")
    e2 = repro_torch.compile(g, **opts)
    got = _outs(e2(input=x))
    assert e2.cache_info()["graph"] == "miss"
    assert e2.cache_info()["programs"] == {1: "miss"}
    _equal(want, got)
    e3 = repro_torch.compile(g, **opts)       # rewritten: hits again
    _equal(want, _outs(e3(input=x)))
    assert e3.cache_info()["hits"] == 2


def test_env_var_names_the_default_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    g = PORT_SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="jit", device="cpu")
    exe(input=_x(g, 1))
    assert exe.cache_info()["dir"] == str(tmp_path)
    assert len(list(tmp_path.glob("*.entry"))) == 2
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    off = repro_torch.compile(g, target="jit", device="cpu")
    assert off.cache_info() == {"dir": None, "hits": 0, "misses": 0}
    assert not off.has_disk_entry(1)


def test_packages_never_share_a_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    assert cache_mod.resolve_cache_dir(None) is None
    assert cache_mod.MAX_BYTES_ENV == "REPRO_TORCH_CACHE_MAX_BYTES"


def test_prune_lru_sweep_and_tmp_cleanup(tmp_path):
    for i in range(5):
        p = tmp_path / f"e{i}.entry"
        p.write_bytes(b"x" * 100)
        os.utime(p, (i + 1, i + 1))           # e0 oldest ... e4 newest
    (tmp_path / "orphan.tmp").write_bytes(b"partial")
    (tmp_path / "notes.txt").write_bytes(b"keep me")
    rep = prune(250, str(tmp_path))
    assert rep["before_bytes"] == 500
    assert rep["after_bytes"] == 200          # two newest survive
    assert rep["removed"] == 4                # three entries + the .tmp
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["e3.entry", "e4.entry", "notes.txt"]
    assert prune(0, str(tmp_path))["after_bytes"] == 0
    with pytest.raises(ValueError):
        prune(-1, str(tmp_path))
    assert prune(10, str(tmp_path / "nope"))["removed"] == 0


def test_hit_refreshes_recency(tmp_path):
    cache = ExecutableCache(str(tmp_path))
    for k in ("a", "b"):
        assert cache.store(k, {"k": k})
    os.utime(tmp_path / "a.entry", (1, 1))
    os.utime(tmp_path / "b.entry", (2, 2))
    assert cache.load("a") == ({"k": "a"}, b"")   # a is hot now
    size = os.path.getsize(tmp_path / "a.entry")
    prune(size, str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["a.entry"]


def test_store_auto_prunes_under_env_cap(tmp_path, monkeypatch):
    cache = ExecutableCache(str(tmp_path))
    assert cache.store("k0", {}, b"x" * 100)
    assert cache.store("k1", {}, b"x" * 100)
    os.utime(tmp_path / "k0.entry", (1, 1))   # k0 is the LRU entry
    os.utime(tmp_path / "k1.entry", (2, 2))
    cap = 2 * os.path.getsize(tmp_path / "k0.entry")
    monkeypatch.setenv("REPRO_TORCH_CACHE_MAX_BYTES", str(cap))
    assert cache.store("k2", {}, b"x" * 100)  # overflows: the sweep runs
    left = sorted(p.name for p in tmp_path.glob("*.entry"))
    assert left == ["k1.entry", "k2.entry"]


def test_bucketed_prewarms_from_disk(tmp_path, monkeypatch):
    g = PORT_SUITE["C-BH"]()
    opts = dict(target="cuda", device="cpu", cache_dir=str(tmp_path),
                buckets=BucketPolicy(batch_buckets=(1, 2, 4)))
    first = repro_torch.compile(g, **opts)
    first.warm_up(block=True)
    x = _x(g, 3)
    want = _outs(first(input=x))
    first.shutdown()

    def refuse(*a, **kw):
        raise AssertionError("the pass pipeline ran")
    monkeypatch.setattr(targets_mod, "run_pipeline", refuse)
    again = repro_torch.compile(g, **opts)   # warm from disk at once
    assert again.runtime_stats()["warm_buckets"] == ["b1", "b2", "b4"]
    _equal(want, _outs(again(input=x)))
    s = again.runtime_stats()
    assert (s["bucket_hits"], s["compile_stalls"]) == (1, 0)
    again.shutdown()


def _prewarm_report(cache, src):
    """Compile a bucketed C-HTWK int8 executable in a new process with
    ``cache``; return what it reports."""
    prog = f"""
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
import repro_torch
from repro_torch.api import targets
from repro_torch.runtime import BucketPolicy
from repro_torch.table1_models import SUITE
ran = []
real = targets.run_pipeline
def counted(*a, **kw):
    ran.append(1)
    return real(*a, **kw)
targets.run_pipeline = counted
g = SUITE["C-HTWK"]()
exe = repro_torch.compile(g, target="cuda", precision="int8", device="cpu",
                          cache_dir={cache!r},
                          buckets=BucketPolicy(batch_buckets=(1, 2, 4)))
exe.warm_up(block=True)
shape = (3,) + tuple(g.inputs["input"].shape)
x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
out = list(exe(input=x).values())[0]
stats = exe.runtime_stats()
exe.shutdown()
print(json.dumps({{"disk": exe.cache_info(), "warm": stats["warm_buckets"],
                   "stalls": stats["compile_stalls"], "pipelines": len(ran),
                   "out": out.numpy().tolist()}}))
"""
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ, REPRO_TORCH_CACHE_DIR=""))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cross_process_prewarm_runs_no_pipeline(tmp_path):
    first = _prewarm_report(str(tmp_path), os.path.join(REPO, "src"))
    second = _prewarm_report(str(tmp_path), os.path.join(REPO, "src"))
    assert first["pipelines"] == 1
    assert first["disk"]["misses"] == 4       # the graph + three buckets
    assert first["warm"] == ["b1", "b2", "b4"]
    # The second process: the graph and every bucket from disk, warm at
    # construction, no pipeline (no calibration walk), no stall.
    assert second["pipelines"] == 0
    assert (second["disk"]["hits"], second["disk"]["misses"]) == (4, 0)
    assert second["disk"]["graph"] == "hit"
    assert set(second["disk"]["programs"].values()) == {"hit"}
    assert second["warm"] == ["b1", "b2", "b4"]
    assert second["stalls"] == 0
    assert first["out"] == second["out"]      # and bit-equal outputs
