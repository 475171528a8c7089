"""Sharded compilation (``repro_torch.dist``) against ``repro.dist`` on the
CPU, in one process.

* Placement: the six Table-1 graphs (the reference's builders, converted
  with ``weights.from_reference``) on five meshes and rule sets give the
  reference's node lists, ``graph.dist`` (shardings and edit log) and
  ``collective_summary``; the same ``ShardingError`` on a collective
  that names an unknown axis; the reference's two golden tests.
* A single-device mesh: ``jit`` and ``cuda`` bit-equal to the unsharded
  program; ``jit`` within 1e-5 of the reference's ``jit`` on that mesh.
* ``MeshUnavailableError`` for ``data=2,model=2`` in one process, with
  the reference's ``missing_axes``.
* The options, ``partition_spec``, the logical-axis rules, the int8
  kernel's int32-sums mode (plain version against a numpy int64
  product), ``prune``'s manifest groups, the fault-tolerance twins, and a
  ``"sharded"`` artifact deserialized in a fresh process.

Live meshes (gloo groups of 2 and 4 processes) are
``test_torch_sharding_live.py``.  Inputs come from numpy seeds.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
from benchmarks.table1_models import SUITE as REF_SUITE
from repro.core.passes import run_pipeline as ref_pipeline
from repro.dist.mesh import MeshSpec as RefMeshSpec

import repro_torch
from repro_torch.core.passes import run_pipeline
from repro_torch.dist import (MeshSpec, MeshUnavailableError, ShardingError,
                              check_shardings, collective_summary,
                              propagate_shardings)
from repro_torch.weights import from_reference

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODELS = sorted(REF_SUITE)
MESHES = [("data=1,model=1", []), ("data=2,model=2", []), ("model=4", []),
          ("data=4", []), ("data=2,model=2", [["mlp", None]])]
JIT_ATOL = 1e-5


def _annotated(name, mesh, rules):
    ref = REF_SUITE[name]()
    port = from_reference(ref)
    for g in (ref, port):
        g.dist = {"mesh": RefMeshSpec.parse(mesh).to_dict(),
                  "rules": [list(r) for r in rules]}
    return ref, port


def _nodes(g):
    return [(n.op, n.name, list(n.inputs), n.output,
             json.dumps(n.attrs, sort_keys=True), n.epilogue)
            for n in g.nodes]


def _inputs(graph, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s.shape)).astype(
        np.float32) for n, s in graph.inputs.items()}


# ---------------------------------------------------------------------------
# Placement equals the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh,rules", MESHES,
                         ids=[f"{m}{'-mlp_off' if r else ''}"
                              for m, r in MESHES])
@pytest.mark.parametrize("name", MODELS)
def test_placement_equals_reference(name, mesh, rules):
    from repro.dist.propagate import collective_summary as ref_summary
    ref, port = _annotated(name, mesh, rules)
    ref_out, ref_report = ref_pipeline(ref)
    port_out, port_report = run_pipeline(port)
    assert _nodes(port_out) == _nodes(ref_out)
    assert port_out.outputs == ref_out.outputs
    for key in ("mesh", "rules", "shardings", "edits"):
        assert json.dumps(port_out.dist[key], sort_keys=True) == \
            json.dumps(ref_out.dist[key], sort_keys=True), key
    assert json.loads(json.dumps(collective_summary(port_out))) == \
        json.loads(json.dumps(ref_summary(ref_out)))
    stats = lambda rep: next(p for p in rep["passes"]
                             if p["pass"] == "propagate_sharding")
    for k in ("sharded", "reused", "collectives"):
        assert stats(port_report)[k] == stats(ref_report)[k]


def test_unknown_axis_raises_the_reference_error():
    """A hand-inserted collective over an axis the mesh lacks: the same
    ShardingError text from both packages' check_shardings."""
    import repro.dist.collectives  # noqa: F401  (registers the ops)
    from repro.dist.propagate import (ShardingError as RefShardingError,
                                      check_shardings as ref_check)
    ref, port = _annotated("C-HTWK", "data=2,model=2", [])
    for g in (ref, port):
        last = g.outputs[0]
        g.add_node("psum", "bad_psum", [last], attrs={"axis": "nope"})
        g.outputs = ["bad_psum:out"]
    with pytest.raises(RefShardingError) as want:
        ref_check(ref)
    with pytest.raises(ShardingError) as got:
        check_shardings(port)
    assert str(got.value) == str(want.value)
    # In the pipeline the verifier names the pass, as the reference's does.
    from repro_torch.core.passes import PassVerificationError
    with pytest.raises(PassVerificationError, match="nope"):
        run_pipeline(port)


def _mlp_block():
    """The reference golden's MLP block, built with the port's builder."""
    from repro_torch.core import ModelBuilder
    mb = ModelBuilder().seed(7)
    x = mb.input((16,))
    up = mb.dense(x, 32, activation="relu")
    down = mb.dense(up, 16)
    out = mb.add(down, x)
    return mb.build([out]), x, up, down, out


def test_propagation_golden_partition_specs():
    """Under DEFAULT_RULES on data=2,model=2 the MLP block resolves to
    the textbook placement: batch over data everywhere, the expansion
    column-parallel over model, the contraction row-parallel closed by
    exactly one psum, residual and output replicated."""
    g, x, up, down, out = _mlp_block()
    g.dist = {"mesh": MeshSpec.parse("data=2,model=2").to_dict(),
              "rules": []}
    stats = propagate_shardings(g)
    assert stats == {"sharded": True, "reused": False, "collectives": 1}
    sh = g.dist["shardings"]
    assert sh[x] == [["data"], None]
    assert sh[up] == [["data"], ["model"]]
    assert sh[down] == [["data"], None]
    assert sh[out] == [["data"], None]
    psums = [n for n in g.nodes if n.op == "psum"]
    assert len(psums) == 1
    assert psums[0].attrs == {"axis": ["model"], "axis_size": 2}
    assert sh[psums[0].output] == [["data"], None]
    add = next(n for n in g.nodes if n.op == "add")
    assert psums[0].output in add.inputs and down not in add.inputs
    edits = g.dist["edits"]
    assert [e["op"] for e in edits["inserted"]] == ["psum"]
    assert edits["outputs"] == g.outputs


def test_propagation_rule_override_forces_replication():
    """sharding_rules=(("mlp", None),) deletes the tensor-parallel rule:
    no column split, no collectives, batch sharding only."""
    g, *_ = _mlp_block()
    g.dist = {"mesh": MeshSpec.parse("data=2,model=2").to_dict(),
              "rules": [["mlp", None]]}
    assert propagate_shardings(g)["collectives"] == 0
    assert all(e == [["data"]] + [None] * (len(e) - 1)
               for e in g.dist["shardings"].values())


# ---------------------------------------------------------------------------
# A single-device mesh is the unsharded program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("target", ["jit", "cuda"])
@pytest.mark.parametrize("name", MODELS)
def test_single_device_mesh_bit_identical(name, target):
    from repro_torch.dist import ShardedExecutable
    g = from_reference(REF_SUITE[name]())
    feeds = _inputs(g)
    opts = repro_torch.CompileOptions(target=target, device="cpu")
    base = repro_torch.compile(g, opts)(**feeds)
    exe = repro_torch.compile(g, opts.replace(mesh="data=1,model=1"))
    assert isinstance(exe, ShardedExecutable) and exe.mesh is None
    got = exe(**feeds)
    assert list(got) == list(base)
    assert all(torch.equal(got[k], base[k]) for k in base)
    sh = exe.cost_summary()["sharding"]
    assert sh["devices"] == 1 and sh["sliced_params"] == {}
    assert not sh["communicates"] and not sh["staged_through_host"]


@pytest.mark.parametrize("name", MODELS)
def test_single_device_mesh_jit_matches_reference(name):
    ref = REF_SUITE[name]()
    feeds = _inputs(ref)
    want = repro.compile(ref, repro.CompileOptions(
        target="jit", mesh="data=1,model=1"))(**feeds)
    got = repro_torch.compile(from_reference(ref), repro_torch.CompileOptions(
        target="jit", device="cpu", mesh="data=1,model=1"))(**feeds)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=JIT_ATOL)


def test_partition_spec_is_a_tuple():
    g = from_reference(REF_SUITE["VGG19"]())
    exe = repro_torch.compile(g, repro_torch.CompileOptions(
        target="jit", device="cpu", mesh="data=1,model=1"))
    out = exe.graph.outputs[0]
    assert exe.partition_spec(out) == ("data", None)
    public = exe.source.output_names[0]
    assert exe.partition_spec(public) == exe.partition_spec(out)
    with pytest.raises(KeyError):
        exe.partition_spec("no-such-tensor")


# ---------------------------------------------------------------------------
# The mesh spec, options and rules
# ---------------------------------------------------------------------------
def test_mesh_unavailable_matches_reference():
    from repro.dist.mesh import (MeshUnavailableError as RefError,
                                 ensure_mesh_available)
    spec = "data=2,model=2"
    with pytest.raises(RefError) as want:
        ensure_mesh_available(RefMeshSpec.parse(spec))
    g = from_reference(REF_SUITE["C-HTWK"]())
    with pytest.raises(MeshUnavailableError) as got:
        repro_torch.compile(g, repro_torch.CompileOptions(
            target="cuda", device="cpu", mesh=spec))
    assert got.value.missing_axes == want.value.missing_axes
    assert (got.value.needed, got.value.available) == \
        (want.value.needed, want.value.available)
    assert str(got.value) == str(want.value)


def test_mesh_spec_matches_reference():
    for text in ("data=4,model=2", "model=4", "pod=2,data=2,model=2"):
        ref, port = RefMeshSpec.parse(text), MeshSpec.parse(text)
        assert port.to_dict() == ref.to_dict()
        assert port.cache_token() == ref.cache_token()
        assert port.describe() == ref.describe() == text
        for n in range(0, 9):
            assert port.missing_axes(n) == ref.missing_axes(n)
        assert MeshSpec.coerce(port.to_dict()) == port
        assert MeshSpec.coerce(dict(port.axes)) == port
    with pytest.raises(ValueError):
        MeshSpec.parse("data")
    assert MeshSpec.parse("data=1,model=1").build() is None


def test_options_carry_mesh_and_rules_like_the_reference():
    kw = dict(mesh="data=2,model=2",
              sharding_rules={"mlp": None, "batch": ["data"]})
    port = repro_torch.CompileOptions(device="cpu", **kw)
    ref = repro.CompileOptions(**kw)
    assert port.mesh == MeshSpec.parse("data=2,model=2")
    assert port.sharding_rules == ref.sharding_rules
    d = json.loads(json.dumps(port.to_dict()))
    assert repro_torch.CompileOptions.from_dict(d) == port
    assert d["mesh"] == json.loads(json.dumps(ref.to_dict()))["mesh"]
    token = port.cache_token()
    assert token != port.replace(mesh=None).cache_token()
    assert token != port.replace(sharding_rules=None).cache_token()


def test_logical_axis_rules_match_reference():
    from repro.distributed import sharding as ref_shd
    from repro_torch.distributed import sharding as shd
    assert shd.DEFAULT_RULES == ref_shd.DEFAULT_RULES
    for axes in (("batch", "seq", "heads"), ("heads", "kv_heads"),
                 ("batch", "mlp"), ("fsdp", "embed", None)):
        assert shd.spec_for(*axes) == tuple(ref_shd.spec_for(*axes))
    x = torch.ones(4, 4)
    assert shd.logical(x, "batch", "embed") is x
    mesh = MeshSpec.parse("data=2,model=2")
    with shd.use_mesh(mesh, {"mlp": None}):
        assert shd.current_rules()["mlp"] is None
        assert shd.current_mesh() is mesh
        # placement only on a mesh (A.14b): every rank holds x whole
        assert shd.logical(x, "batch", "embed") is x
        assert shd.named_sharding(mesh, "batch", "mlp").spec == \
            ("data", None)
    assert shd.current_rules() is shd.DEFAULT_RULES
    assert shd.current_mesh() is None


def test_engine_target_with_a_mesh_names_a14b():
    """Since A.14b an engine compile takes a mesh: a 1-device mesh
    serves with the sharding block and the unsharded tokens."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Request
    cfg = get_config("qwen2.5-14b", smoke=True)
    outs = []
    for mesh in (None, "data=1,model=1"):
        exe = repro_torch.compile(cfg, target="engine", device="cpu",
                                  mesh=mesh)
        sched = exe.serve(slots=2, max_len=32)
        assert sched.options.mesh == exe.options.mesh
        for i in range(3):
            sched.submit(Request(uid=i, prompt=np.arange(3 + i) + 1,
                                 max_new_tokens=4))
        outs.append({c.uid: c.tokens for c in sched.run()})
        summ = sched.summary()
    assert outs[0] == outs[1]
    assert summ["faults"] == []
    assert summ["sharding"]["mesh"] == "data=1,model=1"
    assert summ["sharding"]["devices"] == 1
    assert summ["sharding"]["collectives"]["per_axis"] == {}


# ---------------------------------------------------------------------------
# The int8 kernel's int32-sums mode (what a row-parallel site reduces)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["io", "oi"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (256, 64, 128),
                                   (3, 1037, 7), (17, 4096, 33)])
def test_q8_sums_mode_plain_equals_numpy(m, k, n, layout):
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.standard_normal((m, k)).astype(np.float32) * 3
    wq = rng.integers(-127, 128, (k, n) if layout == "io" else (n, k),
                      dtype=np.int8)
    x_scale = 0.0271
    got = fused_matmul_q8(torch.from_numpy(x), torch.from_numpy(wq), None,
                          x_scale=x_scale, w_layout=layout, sums=True)
    xq = np.clip(np.rint(x / np.float32(x_scale)), -127, 127).astype(np.int64)
    w = wq.astype(np.int64)
    want = xq @ (w if layout == "io" else w.T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_q8_sums_mode_refuses_an_epilogue():
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8
    x, wq = torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="sums=True"):
        fused_matmul_q8(x, wq, torch.ones(4), x_scale=1.0, sums=True)
    with pytest.raises(ValueError, match="sums=True"):
        fused_matmul_q8(x, wq, None, x_scale=1.0, fn="relu", sums=True)
    with pytest.raises(ValueError, match="deq"):
        fused_matmul_q8(x, wq, None, x_scale=1.0)


# ---------------------------------------------------------------------------
# The executable cache: manifest groups, and a second process
# ---------------------------------------------------------------------------
def test_prune_sharded_manifest_is_one_atomic_group(tmp_path):
    """A sharded executable's entries and its manifest are one LRU unit:
    recency is the hottest member, eviction takes the whole group, and
    a dangling manifest is cleaned up front."""
    from repro_torch.api.cache import SUFFIX, prune
    for i, key in enumerate(("s1", "s2")):
        p = tmp_path / f"{key}{SUFFIX}"
        p.write_bytes(b"x" * 100)
        os.utime(p, (1 + 4 * i, 1 + 4 * i))
    man = tmp_path / "g.manifest.json"
    man.write_text(json.dumps({"mesh": {"axes": [["data", 1]]},
                               "members": ["s1", "s2"]}))
    loose = tmp_path / f"loose{SUFFIX}"
    loose.write_bytes(b"x" * 100)
    os.utime(loose, (3, 3))
    group_bytes = 200 + man.stat().st_size

    rep = prune(group_bytes, str(tmp_path))
    assert rep["removed"] == 1                      # just the loose entry
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["g.manifest.json", f"s1{SUFFIX}", f"s2{SUFFIX}"]

    rep = prune(50, str(tmp_path))
    assert rep["after_bytes"] == 0
    assert list(tmp_path.iterdir()) == []

    man.write_text(json.dumps({"members": ["gone"]}))
    assert prune(10_000, str(tmp_path))["removed"] == 1
    assert list(tmp_path.iterdir()) == []


def test_sharded_compile_writes_its_manifest(tmp_path):
    from repro_torch.api.cache import SUFFIX, prune
    g = from_reference(REF_SUITE["C-HTWK"]())
    exe = repro_torch.compile(g, repro_torch.CompileOptions(
        target="cuda", device="cpu", mesh="data=1,model=1",
        cache_dir=str(tmp_path)))
    exe(**_inputs(g, 1))
    exe(**_inputs(g, 3))
    man = tmp_path / f"{exe.manifest_key()}.manifest.json"
    members = json.loads(man.read_text())["members"]
    assert len(members) == 3                # the graph entry + 2 batches
    assert all((tmp_path / f"{k}{SUFFIX}").exists() for k in members)
    prune(0, str(tmp_path))
    assert list(tmp_path.iterdir()) == []


_SECOND_PROCESS = """
import json, sys
import numpy as np, torch
import repro_torch
blob = open(sys.argv[1], "rb").read()
exe = repro_torch.deserialize(blob)
feeds = dict(np.load(sys.argv[2]))
out = exe(**feeds)
want = dict(np.load(sys.argv[3]))
print(json.dumps({
    "type": type(exe).__name__,
    "reused": exe.cost_summary()["sharding"]["reused"],
    "dist": exe.graph.dist,
    "cache": {k: v for k, v in exe.cache_info().items() if k != "dir"},
    "equal": all(np.array_equal(out[k].numpy(), want[k]) for k in want)}))
"""


@pytest.mark.parametrize("mesh", ["data=1,model=1", "data=1"])
def test_sharded_round_trip_in_a_fresh_process(tmp_path, mesh):
    """A ``"sharded"`` artifact deserialized in a new process replays the
    placement (reused), ends with the same ``graph.dist``, takes the
    graph and program entries from the warm cache (0 misses) and gives
    the first process's outputs bit for bit."""
    g = from_reference(REF_SUITE["VGG19"]())
    cache = tmp_path / "cache"
    exe = repro_torch.compile(g, repro_torch.CompileOptions(
        target="cuda", precision="int8", device="cpu", mesh=mesh))
    feeds = _inputs(g, 2)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               REPRO_TORCH_CACHE_DIR=str(cache))
    # Warm the cache as a user's first process would: same options,
    # cache from the environment.
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(cache)
    try:
        warm = repro_torch.deserialize(exe.serialize())
        out = warm(**feeds)
    finally:
        del os.environ["REPRO_TORCH_CACHE_DIR"]
    (tmp_path / "exe.bin").write_bytes(exe.serialize())
    np.savez(tmp_path / "feeds.npz", **feeds)
    np.savez(tmp_path / "want.npz", **{k: v.numpy() for k, v in out.items()})
    res = subprocess.run(
        [sys.executable, "-c", _SECOND_PROCESS, str(tmp_path / "exe.bin"),
         str(tmp_path / "feeds.npz"), str(tmp_path / "want.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["type"] == "ShardedExecutable" and got["reused"]
    assert json.dumps(got["dist"], sort_keys=True) == \
        json.dumps(exe.graph.dist, sort_keys=True)
    assert got["cache"]["graph"] == "hit"
    assert got["cache"]["programs"] == {"2": "hit"}
    assert got["cache"]["misses"] == 0 and got["equal"]


# ---------------------------------------------------------------------------
# Fault tolerance (twins of tests/test_fault.py's)
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_slow_step():
    from repro_torch.distributed import StragglerWatchdog
    fired = []
    wd = StragglerWatchdog(0.05, on_timeout=lambda s, el: fired.append(s))
    with wd.step(7):
        time.sleep(0.15)
    assert fired == [7]
    assert wd.timeouts and wd.timeouts[0][0] == 7


def test_watchdog_quiet_on_fast_step():
    from repro_torch.distributed import StragglerWatchdog
    fired = []
    wd = StragglerWatchdog(0.5, on_timeout=lambda s, el: fired.append(s))
    with wd.step(1):
        pass
    time.sleep(0.05)
    assert fired == []


def test_run_with_restarts_recovers():
    from repro_torch.distributed import run_with_restarts
    completed = []
    saved = {"step": 0}
    crashes = {"left": 2}

    def make_step():
        def step(i):
            if crashes["left"] and i == 5:
                crashes["left"] -= 1
                raise RuntimeError("simulated node failure")
            completed.append(i)
            saved["step"] = i + 1
        return step

    restarts = run_with_restarts(make_step, n_steps=8, max_restarts=3,
                                 start_step=lambda: saved["step"])
    assert restarts == 2
    assert completed[-1] == 7
    assert sorted(set(completed)) == list(range(8))


def test_run_with_restarts_gives_up():
    from repro_torch.distributed import run_with_restarts

    def make_step():
        def step(i):
            raise RuntimeError("permafail")
        return step
    with pytest.raises(RuntimeError):
        run_with_restarts(make_step, n_steps=2, max_restarts=1)


def test_check_mesh_polls_without_raising():
    from repro_torch.distributed import check_mesh
    assert check_mesh(MeshSpec.parse("data=1,model=1")) is None
    fault = check_mesh(MeshSpec.parse("data=2,model=2"))
    assert fault == {"mesh": "data=2,model=2", "needed": 4, "available": 1,
                     "missing_axes": ["data", "model"]}
    assert check_mesh(MeshSpec.parse("data=2,model=2"), available=4) is None


def test_dist_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.dist, repro_torch.dist.executable, "
        "repro_torch.distributed, repro_torch.distributed.fault\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
