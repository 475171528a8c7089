"""The port's kernel autotuner (``repro_torch.autotune``) on the CPU.

The cases of the reference's ``tests/test_autotune.py``, ported: the
tactic cache round-trips (across processes too), ``autotune="off"`` is
the heuristic selector bit for bit, and corrupt, stale or malformed
entries fall back instead of crashing.  Then what the port adds: the
kernels' plan overrides (each with its default arguments is the
committed plan, every grid point is a legal launch, and the plain
version on the CPU is the same for every tactic), and a measured winner
reaching the wrapper it names as a plan.

On the CPU every candidate is a wrapper's plain version timed on the
host; the card times the device (``chip_smoke.py``'s ``autotune``
phase).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch import CompileOptions
from repro_torch.autotune import (Deadline, TacticCache, Tactic,
                                  bench_min_us, candidates_for_node,
                                  environment_fingerprint, open_tactic_cache,
                                  tactic_key, tune_selection)
from repro_torch.core import ModelBuilder
from repro_torch.core.lowering import LoweredGraph, LoweringContext
from repro_torch.autotune.tactics import enumerate_tactics
from repro_torch.core.selection import (KernelChoice, select_kernels,
                                        tactic_plan)
from repro_torch.kernels import qmath
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.fused_matmul import kernel as fm_kernel
from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8
from repro_torch.kernels.tiles import (MAX_GRID_YZ, SMEM_BUDGET_BYTES,
                                       STATIC_SMEM_BYTES, TACTIC_PARAMS)
from repro_torch.table1_models import SUITE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mlp():
    mb = ModelBuilder().seed(0)
    x = mb.input((32,))
    h = mb.dense(x, 64, activation="relu")
    out = mb.dense(h, 8)
    return mb.build([out])


def _x(graph, batch, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s.shape)).astype(np.float32)
            for n, s in graph.inputs.items()}


def _compile_tuned(graph, cache_dir, mode="full", budget_ms=10_000, **kw):
    return repro_torch.compile(graph, CompileOptions(
        target="cuda", autotune=mode, autotune_budget_ms=budget_ms,
        cache_dir=str(cache_dir), device="cpu", **kw))


# ---------------------------------------------------------------------------
# the plan overrides and the grids
# ---------------------------------------------------------------------------
#: (M, K, N) on each path of both plans: GEMV, tiled, split K, ragged.
SHAPES = [(1, 256, 128), (8, 2048, 96), (16, 256, 128), (17, 256, 128),
          (256, 256, 128), (256, 2048, 128), (300, 257, 130), (4096, 64, 16)]


@pytest.mark.parametrize("layout", ["io", "oi"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_overrides_default_to_the_heuristic(m, k, n, layout):
    for itemsize in (2, 4):
        want = fm_kernel.plan(m, k, n, w_layout=layout, itemsize=itemsize)
        assert fm_kernel.plan(
            m, k, n, w_layout=layout, itemsize=itemsize,
            target_blocks=fm_kernel.TARGET_BLOCKS,
            min_ksplit=fm_kernel.MIN_KSPLIT) == want
        assert enumerate_tactics("cuda.fused_matmul", m=m, k=k, n=n,
                                 w_layout=layout,
                                 itemsize=itemsize)[0][1] == want
    want = fm_kernel.plan_q8(m, k, n, w_layout=layout)
    assert fm_kernel.plan_q8(
        m, k, n, w_layout=layout, tile=fm_kernel.Q8_TILE,
        wide_k=fm_kernel.Q8_WIDE_K, min_ksplit=fm_kernel.Q8_MIN_KSPLIT,
        gemv_cols=fm_kernel.Q8_GEMV_COLS) == want
    assert enumerate_tactics("cuda.fused_matmul_q8", m=m, k=k, n=n,
                             w_layout=layout)[0][1] == want


@pytest.mark.parametrize("b,hkv,s", [(1, 8, 32768), (8, 8, 32768),
                                     (2, 1, 4096), (4, 8, 9000), (1, 2, 16)])
def test_chunk_plan_overrides_default_to_the_heuristic(b, hkv, s):
    want = da_kernel.chunk_plan(b, hkv, s)
    assert da_kernel.chunk_plan(
        b, hkv, s, tiles_per_chunk=da_kernel.MAX_TILES_PER_CHUNK,
        target_blocks=da_kernel.TARGET_BLOCKS) == want
    grid = enumerate_tactics("cuda.decode_attention", b=b, hkv=hkv, s=s)
    assert grid[0][1] == want
    ntiles = -(-s // 512)
    for _, (tpc, chunks) in grid:          # every chunking covers S
        assert tpc >= 1 and chunks == -(-ntiles // tpc)


@pytest.mark.parametrize("kernel", ["cuda.fused_matmul",
                                    "cuda.fused_matmul_q8"])
@pytest.mark.parametrize("layout", ["io", "oi"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_every_grid_point_is_a_legal_plan(kernel, layout, m, k, n):
    shape = dict(m=m, k=k, n=n, w_layout=layout)
    grid = enumerate_tactics(kernel, **shape)
    plans = [p for _, p in grid]
    assert len(plans) == len(set(plans)) >= 1
    assert grid[0][0] is None                  # the heuristic's plan
    for params, p in grid:
        assert params is None or len(params) == len(TACTIC_PARAMS[kernel])
        assert tactic_plan(kernel, params, **shape) == p
        assert p.smem_bytes <= STATIC_SMEM_BYTES <= SMEM_BUDGET_BYTES
        assert max(p.grid[1:]) <= MAX_GRID_YZ
        fm_kernel.check_plan(p, m, k, n, kernel)       # lays out M, K, N
        edges = p.split_edges(k)
        assert edges[0][0] == 0 and edges[-1][1] == k
        assert all(k1 > k0 for k0, k1 in edges) or k == 0
        if p.path == "gemv":
            assert m <= 16 and p.ksplit * fm_kernel.gemv_rows(m) <= (
                4096 if kernel == "cuda.fused_matmul" else 16384)
        elif kernel == "cuda.fused_matmul_q8":
            assert p.ksplit % 32 == 0 and p.ksplit <= 256
            assert p.threads in (256, 512)
        else:
            assert p.ksplit % 32 == 0


def test_check_plan_refuses_another_shape():
    p = fm_kernel.plan(256, 256, 128)
    with pytest.raises(ValueError, match="does not lay out"):
        fm_kernel.check_plan(p, 200, 256, 128, "fused_matmul")
    fm_kernel.check_plan(p, 255, 256, 128, "fused_matmul")   # masked rows
    with pytest.raises(ValueError, match="does not lay out"):
        fm_kernel.check_plan(p, 256, 513, 128, "fused_matmul")
    with pytest.raises(ValueError):
        fm_kernel.plan_q8(256, 256, 128, tile=(64, 64))


def test_the_plain_versions_ignore_the_tactic():
    """On the CPU each wrapper runs its plain version, whatever plan it is
    handed: every grid point gives the heuristic's result bit for bit."""
    rng = np.random.default_rng(3)
    m, k, n = 17, 300, 40
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = fused_matmul(x, w, b, fn="relu")
    for _, p in enumerate_tactics("cuda.fused_matmul", m=m, k=k, n=n):
        assert torch.equal(fused_matmul(x, w, b, fn="relu", plan=p), want)
    xs = 0.05
    wq, deq = qmath.quantize_weight(w, xs, qmath.channel_scales(w.numpy(), 1))
    want = fused_matmul_q8(x, wq, deq, b, x_scale=xs, fn="relu")
    for _, p in enumerate_tactics("cuda.fused_matmul_q8", m=m, k=k, n=n):
        assert torch.equal(
            fused_matmul_q8(x, wq, deq, b, x_scale=xs, fn="relu", plan=p), want)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 1300, 2, 8)).astype(np.float32))
    lens = torch.tensor([1300, 700], dtype=torch.int32)
    for fast in (False, True):
        want = decode_attention(q, kv, kv, lens, fast=fast)
        for _, (tpc, _) in enumerate_tactics("cuda.decode_attention", b=2,
                                             hkv=2, s=1300):
            assert torch.equal(decode_attention(q, kv, kv, lens, fast=fast,
                                                tiles_per_chunk=tpc), want)


# ---------------------------------------------------------------------------
# autotune="off": the heuristic selector, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SUITE))
def test_off_mode_matches_heuristic_on_all_table1_configs(name):
    g = SUITE[name]()
    exe = repro_torch.compile(g, target="cuda", device="cpu")
    feeds = _x(g, 2)
    out = exe(**feeds)
    heuristic = select_kernels(exe.graph, batch_size=2, target="cuda")
    sel = exe._selections.get(2, {})
    assert set(sel) == set(heuristic)
    for node, choice in sel.items():
        assert choice == heuristic[node]
        assert choice.source == "heuristic"
    summary = exe.cost_summary()
    assert "autotune" not in summary and "graph_decisions" not in summary
    assert not any(k.startswith("tune.") for n in exe.graph.nodes
                   for k in n.attrs)
    # The program a context without a selection runs: the wrappers'
    # own plans, as before the selection reached the lowering.
    bare = LoweredGraph(exe.graph, LoweringContext(
        params=exe.params, batch_size=2, target="cuda"))
    with torch.inference_mode():
        want = bare({n: torch.from_numpy(v) for n, v in feeds.items()})
    for pub, opt in zip(g.output_names, exe.graph.outputs):
        assert torch.equal(out[pub], want[opt])


def test_options_validate_autotune_fields():
    with pytest.raises(ValueError):
        CompileOptions(autotune="always")
    with pytest.raises(ValueError):
        CompileOptions(autotune_budget_ms=0)
    assert (CompileOptions(autotune="full").cache_token()
            == CompileOptions().cache_token())


# ---------------------------------------------------------------------------
# full mode: measured winners, budget, and the persistent cache
# ---------------------------------------------------------------------------
def test_full_mode_measures_and_reports(tmp_path):
    g = _mlp()
    exe = _compile_tuned(g, tmp_path)
    x = _x(g, 2)["input"]
    y = exe(input=x)
    cost = exe.cost_summary()
    sel = cost["kernel_selection"][2]
    dense = [c for c in sel if c["op"] == "dense"]
    assert dense and all(c["source"] == "measured" for c in dense)
    assert all(c["measured_us"] for c in dense)
    for c in dense:
        assert c["kernel"] == "cuda.fused_matmul"
        assert any(lbl.split("[")[0] == c["kernel"]
                   for lbl in c["measured_us"])
        label = Tactic(c["kernel"], tuple(c["tactic"]) if c["tactic"]
                       else None).label
        assert label in c["measured_us"]
    rep = cost["autotune"][2]
    assert rep["mode"] == "full" and rep["measured_nodes"]
    assert rep["cache"]["stores"] == len(rep["measured_nodes"])
    assert "entries" not in rep and "entries" not in cost["graph_decisions"]
    oracle = repro_torch.compile(g, target="interpret", device="cpu")(input=x)
    (k,) = oracle
    np.testing.assert_allclose(y[k].numpy(), oracle[k].numpy(), rtol=2e-5,
                               atol=2e-6)


def test_exhausted_budget_falls_back_to_heuristic(tmp_path):
    g = _mlp()
    exe = _compile_tuned(g, tmp_path, budget_ms=1e-3)
    exe.ensure_compiled(batch_size=1)
    sel = exe._selections[1]
    heuristic = select_kernels(exe.graph, batch_size=1, target="cuda")
    assert all(c.source == "heuristic" for c in sel.values())
    assert sel == heuristic
    rep = exe.cost_summary()["autotune"][1]
    assert rep["heuristic_nodes"] and not rep["measured_nodes"]


PROG = """
import json, sys
sys.path.insert(0, {src!r})
import repro_torch
from repro_torch import CompileOptions
from repro_torch.core import ModelBuilder
mb = ModelBuilder().seed(0)
x = mb.input((32,))
h = mb.dense(x, 64, activation="relu")
out = mb.dense(h, 8)
g = mb.build([out])
exe = repro_torch.compile(g, CompileOptions(
    target="cuda", autotune={mode!r}, autotune_budget_ms=20000,
    cache_dir={cache!r}, device="cpu"))
exe.ensure_compiled(batch_size=1)
summary = exe.cost_summary()
print(json.dumps({{"autotune": summary["autotune"][1],
                   "decisions": summary["graph_decisions"],
                   "selection": summary["kernel_selection"][1]}}))
"""


def _run(mode, cache):
    r = subprocess.run(
        [sys.executable, "-c",
         PROG.format(src=os.path.join(REPO, "src"), cache=str(cache),
                     mode=mode)],
        capture_output=True, text=True, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_tactic_cache_round_trip_across_processes(tmp_path):
    """Process 1 measures and stores; process 2 compiles the same model
    and takes every tactic from the cache without measuring."""
    first, second = _run("full", tmp_path), _run("full", tmp_path)
    assert first["autotune"]["measured_nodes"] == ["dense_1", "dense_3"]
    assert second["autotune"]["measured_nodes"] == []
    assert set(second["autotune"]["cached_nodes"]) == {"dense_1", "dense_3"}
    assert second["autotune"]["cache"]["hits"] == 2
    assert ([(c["node"], c["kernel"], c["block"], c["tactic"])
             for c in first["selection"]]
            == [(c["node"], c["kernel"], c["block"], c["tactic"])
                for c in second["selection"]])


def test_cached_mode_never_measures(tmp_path):
    g = _mlp()
    exe = _compile_tuned(g, tmp_path, mode="cached")
    exe.ensure_compiled(batch_size=1)
    rep = exe.cost_summary()["autotune"][1]
    assert not rep["measured_nodes"] and rep["cache"]["stores"] == 0
    assert all(c.source == "heuristic"
               for c in exe._selections[1].values())
    assert exe.cost_summary()["graph_decisions"]["spent_ms"] < 50


# ---------------------------------------------------------------------------
# corruption / staleness: heuristic fallback, never a crash
# ---------------------------------------------------------------------------
def _populate_cache(tmp_path):
    g = _mlp()
    exe = _compile_tuned(g, tmp_path)
    exe.ensure_compiled(batch_size=1)
    tactics_dir = os.path.join(str(tmp_path), "tactics")
    files = [os.path.join(tactics_dir, f) for f in os.listdir(tactics_dir)]
    assert files
    return g, files


def test_corrupt_tactic_entries_fall_back(tmp_path):
    g, files = _populate_cache(tmp_path)
    for f in files:
        with open(f, "w") as fh:
            fh.write("{not json")
    exe = _compile_tuned(g, tmp_path, mode="cached")
    exe.ensure_compiled(batch_size=1)
    assert all(c.source == "heuristic"
               for c in exe._selections[1].values())
    tactics_dir = os.path.dirname(files[0])
    remaining = [f for f in os.listdir(tactics_dir) if f.endswith(".json")]
    assert len(remaining) < len(files)


def test_stale_fingerprint_entries_ignored(tmp_path):
    g, files = _populate_cache(tmp_path)
    for f in files:
        with open(f) as fh:
            entry = json.load(fh)
        entry["fingerprint"] = "0" * 64
        with open(f, "w") as fh:
            json.dump(entry, fh)
    exe = _compile_tuned(g, tmp_path, mode="cached")
    exe.ensure_compiled(batch_size=1)
    assert all(c.source == "heuristic"
               for c in exe._selections[1].values())
    assert os.path.exists(files[0])


def test_malformed_winner_entry_falls_back(tmp_path):
    g, files = _populate_cache(tmp_path)
    fp = environment_fingerprint("cpu")
    for f in files:
        with open(f, "w") as fh:
            json.dump({"winner": 42, "fingerprint": fp}, fh)
    exe = _compile_tuned(g, tmp_path, mode="cached")
    exe.ensure_compiled(batch_size=1)
    assert all(c.source == "heuristic"
               for c in exe._selections[1].values())


# ---------------------------------------------------------------------------
# plumbing details
# ---------------------------------------------------------------------------
def test_tactic_key_depends_on_desc_and_fingerprint():
    fp = environment_fingerprint("cpu")
    d1 = {"op": "dense", "m": 8, "k": 32, "n": 64}
    d2 = {"op": "dense", "m": 8, "k": 32, "n": 128}
    assert tactic_key(d1, fp) == tactic_key(d1, fp)
    assert tactic_key(d1, fp) != tactic_key(d2, fp)
    assert tactic_key(d1, fp) != tactic_key(d1, "f" * 64)
    assert environment_fingerprint("cpu") == fp


def test_candidates_shared_shapes_measured_once(tmp_path):
    mb = ModelBuilder().seed(0)
    x = mb.input((64,))
    h = mb.dense(x, 64, activation="relu")
    h = mb.dense(h, 64, activation="relu")
    out = mb.dense(h, 64, activation="relu")
    g = mb.build([out])
    cache = open_tactic_cache(str(tmp_path))
    heuristic = select_kernels(g, batch_size=1, target="cuda")
    tuned, rep = tune_selection(g, heuristic, batch_size=1,
                                precision="exact", mode="full",
                                budget_ms=20_000, cache=cache, device="cpu")
    assert len(rep["measured_nodes"]) == 1
    assert len(rep["cached_nodes"]) == 2
    assert all(tuned[n].source == "measured"
               for n, c in heuristic.items() if c.op == "dense")


def _measured(selection, tactic=(32, 64)):
    return {n: KernelChoice(c.node, c.op, c.kernel, "measured",
                            source="measured", block=c.block, tactic=tactic)
            for n, c in selection.items()}


def test_program_key_tracks_selection(tmp_path):
    g = _mlp()
    exe = repro_torch.compile(g, target="cuda", device="cpu",
                              cache_dir=str(tmp_path))
    heuristic = select_kernels(exe.graph, batch_size=1, target="cuda")
    key = exe._program_key(1, heuristic)
    assert exe._program_key(1, _measured(heuristic)) != key
    assert exe._program_key(1, _measured(heuristic, (16, 64))) != \
        exe._program_key(1, _measured(heuristic))
    # The same resolved selection -> the same key, whatever the mode.
    exe2 = repro_torch.compile(g, target="cuda", device="cpu",
                               autotune="cached", cache_dir=str(tmp_path))
    assert exe2._program_key(1, select_kernels(
        exe2.graph, batch_size=1, target="cuda")) == key
    assert exe2.disk_key(1) == exe.disk_key(1)


def test_off_and_tuned_compiles_keep_their_entries_apart(tmp_path):
    """A tuned compile's decided graph and selection key entries of their
    own: an autotune="off" compile with the same cache directory loads
    neither the tuned graph nor the tuned selection."""
    g = _mlp()
    tuned = _compile_tuned(g, tmp_path)
    tuned.ensure_compiled(1)
    assert any(k.startswith("tune.") for n in tuned.graph.nodes
               for k in n.attrs)
    off = repro_torch.compile(g, target="cuda", device="cpu",
                              cache_dir=str(tmp_path))
    off.ensure_compiled(1)
    assert off.cache_info()["graph"] == "miss"
    assert off.cache_info()["programs"] == {1: "miss"}
    assert not any(k.startswith("tune.") for n in off.graph.nodes
                   for k in n.attrs)
    assert all(c.source == "heuristic" for c in off._selections[1].values())
    again = _compile_tuned(g, tmp_path, mode="cached")
    again.ensure_compiled(1)
    assert again.cache_info()["graph"] == "hit"
    assert again.cache_info()["programs"] == {1: "hit"}
    assert again.graph.structure_hash() == tuned.graph.structure_hash()


def test_a_measured_tactic_is_the_plan_the_wrapper_launches(monkeypatch,
                                                            tmp_path):
    """A winner other than the heuristic's plan reaches the wrapper as its
    ``plan``: the lowering runs what the selection names."""
    from repro_torch.core import lowering

    g = _mlp()
    exe = repro_torch.compile(g, target="cuda", device="cpu")
    heuristic = select_kernels(exe.graph, batch_size=1, target="cuda")
    seen = []

    def spy(*a, plan=None, **kw):
        seen.append(plan)
        return fused_matmul(*a, plan=plan, **kw)

    monkeypatch.setattr(lowering, "fused_matmul", spy)
    prog = LoweredGraph(exe.graph, LoweringContext(
        params=exe.params, batch_size=1, target="cuda",
        selection=_measured(heuristic, (16, 32))))
    with torch.inference_mode():
        prog({"input": torch.zeros((1, 32))})
    specs = exe.graph.infer_shapes()
    want = []
    for node in exe.graph.nodes:
        if node.op == "dense":
            kshape = exe.graph.params[node.params["kernel"]].shape
            oi = node.attrs.get("kernel_layout") == "oi"
            k, n = (kshape[1], kshape[0]) if oi else kshape
            want.append(fm_kernel.plan(1, k, n, w_layout="oi" if oi else "io",
                                       target_blocks=16, min_ksplit=32))
    assert seen == want
    seen.clear()
    LoweredGraph(exe.graph, LoweringContext(
        params=exe.params, batch_size=1, target="cuda",
        selection=heuristic))({"input": torch.zeros((1, 32))})
    assert seen == [None, None]        # the wrapper's own plan
    bad = _measured(heuristic, (16,))
    with pytest.raises(ValueError, match="no tactic"):
        LoweredGraph(exe.graph, LoweringContext(
            params=exe.params, batch_size=1, target="cuda",
            selection=bad))({"input": torch.zeros((1, 32))})


def test_int8_sites_tune_the_q8_grid(tmp_path):
    g = SUITE["C-HTWK"]()
    exe = _compile_tuned(g, tmp_path, precision="int8")
    exe.ensure_compiled(2)
    dense = [c for c in exe._selections[2].values() if c.op == "dense"]
    assert dense and all(c.kernel == "cuda.fused_matmul_q8" and
                         c.source == "measured" for c in dense)
    assert all(len(c.block) == 3 and (c.tactic is None or len(c.tactic) == 5)
               for c in dense)
    specs = exe.graph.infer_shapes()
    node = next(n for n in exe.graph.nodes if n.op == "dense")
    nt = candidates_for_node(node, exe.graph, specs, batch_size=2,
                             precision="int8", device="cpu")
    assert nt.desc["quant"] == "int8"
    tactic, run, args = nt.make_candidates()[0]
    assert tactic.kernel == "cuda.fused_matmul_q8"
    assert args[1].dtype == torch.int8          # the calibrated operand


def test_decode_attention_tunes_its_chunking(tmp_path):
    from repro_torch.core.graph import Graph
    g = Graph()
    g.add_input("q", (8, 16))
    g.add_input("k", (1300, 2, 16))
    g.add_input("v", (1300, 2, 16))
    g.add_node("decode_attention", "attn", ["q", "k", "v"])
    g.set_outputs(["attn:out"])
    exe = _compile_tuned(g, tmp_path)
    rng = np.random.default_rng(0)
    feeds = {n: rng.standard_normal((2,) + s.shape).astype(np.float32)
             for n, s in g.inputs.items()}
    got = exe(**feeds)
    (c,) = exe._selections[2].values()
    assert c.kernel == "cuda.decode_attention" and c.source == "measured"
    assert len(c.measured_us) == len(enumerate_tactics(
        "cuda.decode_attention", b=2, hkv=2, s=1300))
    want = repro_torch.compile(g, target="interpret", device="cpu")(**feeds)
    np.testing.assert_allclose(got["attn:out"].numpy(),
                               want["attn:out"].numpy(), atol=1e-5, rtol=0)


def test_fast_activations_are_reported_untuned(tmp_path):
    g = SUITE["Segmenter"]()
    exe = _compile_tuned(g, tmp_path, precision="fast", budget_ms=1)
    exe.ensure_compiled(1)
    rep = exe.cost_summary()["autotune"][1]
    assert rep["not_tuned"]
    assert all(r.startswith("cuda.fast_act: one candidate")
               for r in rep["not_tuned"].values())


def test_bench_min_us_times_the_host_and_refuses_failures():
    x = torch.ones(64)
    us = bench_min_us(torch.exp, (x,), reps=3)
    assert us is not None and us > 0

    def broken(x):
        raise RuntimeError("does not launch")
    assert bench_min_us(broken, (x,)) is None
    spent = Deadline(1e-6)
    assert spent.expired() or spent.spent_ms() >= 0
    assert Deadline(None).expired() is False
