"""Graph-level decision tuning (``repro_torch.autotune.decisions``).

The cases of the reference's ``tests/test_decisions.py``, ported: the
region digest ignores names and insertion order and changes on any
shape, dtype or structure edit; the pass hooks (``tune.fuse``,
``tune.layout``, pipeline variants) steer the passes; tuned decisions
replay across processes with ``autotune="cached"``; ``autotune="off"``
writes no decision attr.  Then parity with the reference on the six
Table-1 graphs: the same sites with the same digests, the same pipeline
variants, and with the same decisions forced on the same sites the same
optimized graph and outputs within 1e-5 (the reference's own
interpret-versus-jit spread, ROADMAP C).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
from benchmarks.table1_models import SUITE as REF_SUITE
from repro.autotune import enumerate_sites as ref_enumerate_sites
from repro.autotune import region_digest as ref_region_digest
from repro.core.passes.manager import pipeline_candidates as ref_candidates

import repro_torch
from repro_torch import CompileOptions
from repro_torch.autotune import (enumerate_sites, extract_region,
                                  region_digest, tune_graph_decisions)
from repro_torch.autotune.cache import TacticCache
from repro_torch.core import ModelBuilder
from repro_torch.core.graph import Graph
from repro_torch.core.passes import PassManager, run_pipeline
from repro_torch.core.passes.fuse_activation import TUNE_FUSE_ATTR
from repro_torch.core.passes.layout import TUNE_LAYOUT_ATTR
from repro_torch.core.passes.manager import pipeline_candidates
from repro_torch.table1_models import SUITE as PORT_SUITE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _mlp(in_dim=16, hidden=32, out=8):
    mb = ModelBuilder().seed(0)
    x = mb.input((in_dim,))
    h = mb.dense(x, hidden, activation="relu")
    o = mb.dense(h, out)
    return mb.build([o])


def _dense_act_graph(names=("d", "a"), tensors=("t0", "t1"), in_dim=16,
                     out_dim=32, dtype="float32"):
    rng = np.random.default_rng(0)
    g = Graph()
    g.add_input("x", (in_dim,), dtype)
    g.add_param("w", rng.standard_normal((in_dim, out_dim)))
    g.add_node("dense", names[0], ["x"], output=tensors[0],
               params={"kernel": "w"})
    g.add_node("activation", names[1], [tensors[0]], output=tensors[1],
               attrs={"fn": "relu"})
    g.set_outputs([tensors[1]])
    return g


# ---------------------------------------------------------------------------
# region digest
# ---------------------------------------------------------------------------
def test_digest_invariant_to_node_and_tensor_names():
    a = _dense_act_graph(names=("d", "a"), tensors=("t0", "t1"))
    b = _dense_act_graph(names=("layer7", "omega"), tensors=("u", "v"))
    assert (region_digest(a, [n.name for n in a.nodes])
            == region_digest(b, [n.name for n in b.nodes]))


def test_digest_invariant_to_insertion_order():
    rng = np.random.default_rng(0)

    def build(flip):
        g = Graph()
        g.add_input("x", (16,))
        g.add_param("w1", rng.standard_normal((16, 32)))
        g.add_param("w2", rng.standard_normal((16, 8)))
        heads = [("h1", "w1"), ("h2", "w2")]
        for name, w in (reversed(heads) if flip else heads):
            g.add_node("dense", name, ["x"], params={"kernel": w})
        g.set_outputs([n.output for n in g.nodes])
        return g

    a, b = build(False), build(True)
    assert (region_digest(a, ["h1", "h2"])
            == region_digest(b, ["h1", "h2"]))


@pytest.mark.parametrize("edit", ["shape", "dtype", "structure"])
def test_digest_changes_on_semantic_edits(edit):
    base = _dense_act_graph()
    if edit == "shape":
        other = _dense_act_graph(in_dim=24)
    elif edit == "dtype":
        other = _dense_act_graph(dtype="bfloat16")
    else:
        other = _dense_act_graph()
        other.nodes[1].attrs["fn"] = "tanh"
    assert (region_digest(base, [n.name for n in base.nodes])
            != region_digest(other, [n.name for n in other.nodes]))


def test_digest_ignores_tune_attrs():
    a = _dense_act_graph()
    b = _dense_act_graph()
    b.nodes[0].attrs[TUNE_LAYOUT_ATTR] = "oi"
    b.nodes[1].attrs[TUNE_FUSE_ATTR] = False
    assert (region_digest(a, [n.name for n in a.nodes])
            == region_digest(b, [n.name for n in b.nodes]))


def test_digest_unknown_node_raises():
    with pytest.raises(KeyError):
        region_digest(_dense_act_graph(), ["nope"])


# ---------------------------------------------------------------------------
# site enumeration + region extraction
# ---------------------------------------------------------------------------
def test_enumerate_sites_shapes():
    sites = enumerate_sites(_mlp())
    kinds = [s.kind for s in sites]
    assert kinds.count("layout") == 2
    assert kinds.count("fusion") == 1
    assert kinds.count("pipeline") == 1
    assert kinds[-1] == "pipeline"
    assert set(sites[-1].choices) == set(pipeline_candidates())


def test_enumerate_sites_explicit_passes_pins_pipeline():
    sites = enumerate_sites(_mlp(), passes=("canonicalize",))
    assert all(s.kind != "pipeline" for s in sites)


def test_extract_region_is_self_contained():
    g = _mlp()
    fusion = [s for s in enumerate_sites(g) if s.kind == "fusion"][0]
    mini = extract_region(g, fusion.region)
    assert len(mini.nodes) == 2
    mini.infer_shapes()
    assert (region_digest(mini, [n.name for n in mini.nodes])
            == fusion.digest)


# ---------------------------------------------------------------------------
# pass hooks
# ---------------------------------------------------------------------------
def test_tune_fuse_attr_blocks_fusion():
    fused, _ = run_pipeline(_dense_act_graph())
    assert len(fused.nodes) == 1
    g2 = _dense_act_graph()
    g2.nodes[1].attrs[TUNE_FUSE_ATTR] = False
    unfused, _ = run_pipeline(g2)
    assert len(unfused.nodes) == 2
    assert unfused.nodes[0].epilogue is None


def test_tune_layout_attr_overrides_heuristic():
    g = _dense_act_graph()
    g.nodes[0].attrs[TUNE_LAYOUT_ATTR] = "io"
    out, _ = run_pipeline(g)
    dense = [n for n in out.nodes if n.op == "dense"][0]
    assert dense.attrs["kernel_layout"] == "io"
    out2, _ = run_pipeline(_dense_act_graph())
    dense2 = [n for n in out2.nodes if n.op == "dense"][0]
    assert dense2.attrs["kernel_layout"] == "oi"


def test_pipeline_candidates_contract():
    variants = pipeline_candidates()
    assert list(variants)[0] == "default"
    assert variants["default"] == PassManager.default().pipeline
    assert not any("fuse_activation" in p for p in variants["no_fusion"])
    assert "optimize_layout" not in variants["no_layout"]


def test_pipeline_candidates_match_reference():
    assert pipeline_candidates() == ref_candidates()


# ---------------------------------------------------------------------------
# tuning + cross-process cached replay
# ---------------------------------------------------------------------------
def test_tune_graph_decisions_cached_replays(tmp_path):
    g = _mlp()
    cache = TacticCache(os.path.join(str(tmp_path), "tactics"))
    _, pipe1, rep1 = tune_graph_decisions(
        g, target="cuda", precision="exact", passes=None,
        mode="full", budget_ms=20_000, cache=cache, batch_size=1,
        device="cpu")
    assert all(r["source"] == "measured" for r in rep1["sites"])
    assert rep1["entries"]
    _, pipe2, rep2 = tune_graph_decisions(
        g, target="cuda", precision="exact", passes=None,
        mode="cached", budget_ms=None, cache=cache, batch_size=1,
        device="cpu")
    assert pipe1 == pipe2
    assert ([(r["kind"], r["node"], r["winner"]) for r in rep1["sites"]]
            == [(r["kind"], r["node"], r["winner"]) for r in rep2["sites"]])
    assert all(r["source"] == "cached" for r in rep2["sites"])
    assert rep2["spent_ms"] < 50


def test_cached_mode_without_entries_keeps_heuristics(tmp_path):
    g = _mlp()
    cache = TacticCache(os.path.join(str(tmp_path), "tactics"))
    decided, pipe, rep = tune_graph_decisions(
        g, target="cuda", precision="exact", passes=None,
        mode="cached", budget_ms=None, cache=cache, batch_size=1,
        device="cpu")
    assert pipe is None
    assert all(r["source"] == "heuristic" and r["winner"] is None
               for r in rep["sites"])
    assert decided.structure_hash() == g.structure_hash()


def test_autotune_off_writes_no_decision_attrs(tmp_path):
    exe = repro_torch.compile(_mlp(), target="cuda", device="cpu",
                              autotune="off", cache_dir=str(tmp_path))
    exe.ensure_compiled(1)
    for node in exe.graph.nodes:
        assert not any(k.startswith("tune.") for k in node.attrs)
    assert exe.cost_summary().get("graph_decisions") is None


PROG = """
import json, sys
sys.path.insert(0, {src!r})
import repro_torch
from repro_torch import CompileOptions
from repro_torch.core import ModelBuilder
mb = ModelBuilder().seed(0)
x = mb.input((16,))
h = mb.dense(x, 32, activation="relu")
out = mb.dense(h, 8)
g = mb.build([out])
exe = repro_torch.compile(g, CompileOptions(
    target="cuda", autotune={mode!r}, autotune_budget_ms=20000,
    cache_dir={cache!r}, device="cpu"))
exe.ensure_compiled(batch_size=1)
rep = exe.cost_summary()["graph_decisions"]
print(json.dumps({{"sites": [(r["kind"], r["node"], r["winner"])
                             for r in rep["sites"]],
                  "sources": sorted({{r["source"] for r in rep["sites"]}}),
                  "spent_ms": rep["spent_ms"]}}))
"""


def test_decisions_replay_cross_process(tmp_path):
    out = []
    for mode in ("full", "cached"):
        r = subprocess.run(
            [sys.executable, "-c",
             PROG.format(src=os.path.join(REPO, "src"), cache=str(tmp_path),
                         mode=mode)],
            capture_output=True, text=True, check=True)
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, second = out
    assert first["sites"] == second["sites"]
    assert first["sources"] == ["measured"]
    assert second["sources"] == ["cached"]
    assert second["spent_ms"] < 50


# ---------------------------------------------------------------------------
# parity with the reference on the Table-1 graphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(PORT_SUITE))
def test_sites_and_digests_match_reference(name):
    ref_g, port_g = REF_SUITE[name](), PORT_SUITE[name]()
    ref_sites, port_sites = ref_enumerate_sites(ref_g), enumerate_sites(port_g)
    assert ([(s.kind, s.node, s.region, s.digest, s.choices)
             for s in port_sites]
            == [(s.kind, s.node, s.region, s.digest, s.choices)
                for s in ref_sites])
    names = [n.name for n in port_g.nodes][:5]
    assert region_digest(port_g, names) == ref_region_digest(ref_g, names)


def _forced(graph, sites):
    """Flip every layout site off its heuristic (layouts alternate "io"
    and "oi") and every other fusion site to "no_fuse"."""
    nodes = {n.name: n for n in graph.nodes}
    fusion = 0
    for i, s in enumerate(sites):
        if s.kind == "layout":
            nodes[s.node].attrs["tune.layout"] = ("io", "oi")[i % 2]
        elif s.kind == "fusion":
            if fusion % 2 == 0:
                nodes[s.node].attrs["tune.fuse"] = False
            fusion += 1
    return graph


@pytest.mark.parametrize("name", list(PORT_SUITE))
def test_forced_decisions_give_the_reference_graph(name):
    from repro.core.passes import run_pipeline as ref_run_pipeline
    ref_g = _forced(REF_SUITE[name](), ref_enumerate_sites(REF_SUITE[name]()))
    port_g = _forced(PORT_SUITE[name](), enumerate_sites(PORT_SUITE[name]()))
    ref_out, _ = ref_run_pipeline(ref_g)
    port_out, _ = run_pipeline(port_g)
    assert port_out.structure_hash() == ref_out.structure_hash()
    assert sorted(port_out.params) == sorted(ref_out.params)
    for k in ref_out.params:
        np.testing.assert_array_equal(np.asarray(port_out.params[k]),
                                      np.asarray(ref_out.params[k]))
    rng = np.random.default_rng(0)
    feeds = {n: rng.standard_normal((2,) + tuple(s.shape)).astype(np.float32)
             for n, s in ref_g.inputs.items()}
    want = repro.compile(ref_g, repro.CompileOptions(target="jit"))(**feeds)
    for target in ("jit", "cuda"):
        got = repro_torch.compile(port_g, target=target, device="cpu")(**feeds)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=ATOL)
