"""Mesh serving (``SchedulerOptions.mesh``) and the models' sharded forms
on live meshes: gloo groups of 4 and 2 processes on the CPU
(``tests/_mesh_serve_worker.py``), each spawned once per module with a
``file://`` rendezvous in a temporary directory.

The reference's oracle (``test_sharding.py::
test_serve_data_model_mesh_tokens_identical_8dev``: qwen2.5-14b SMOKE,
4 slots, max_len 64, 6 prompts, 8 new tokens) on ``data=2,model=2``,
``data=2`` and ``model=2``, at a fixed shape and with buckets, chunked
prefill, a prefix cache and deadline admission (rank 0's clock is the
single-device run's; the other ranks' clocks run backwards, so only
rank 0's decisions give the single-device order), and the same with
staggered budgets (compaction moves rows between ranks) and with
budgets whose compaction moves rows both within a data shard and across
(the moves recorded and checked):

* every rank's tokens equal the port's single-device scheduler's and
  the reference's unsharded scheduler's, over the same weights;
* ``summary()["sharding"]`` has the reference's keys, ``per_axis`` ⊆
  {data, model}, count ≥ 1 and bytes > 0 on every axis that splits;
  ``summary()["faults"] == []``;
* a device source that shrinks mid-run raises ``MeshUnavailableError``
  on every rank, recorded in ``faults`` with the reference's fields;
* on the meshes that split the slots, temperature sampling gives every
  rank the single-device tokens (a draw depends on the request and its
  index, not on the rank that samples it).

Under ``model=2`` the expert-parallel MoE (deepseek-v3 and mixtral
SMOKE), its TP mode (one expert: the hidden width splits) and
``tp_psum`` (qwen2.5-14b SMOKE) forward at f32 against the unsharded
port (bit-equal where each token's two expert outputs sum on one rank or
meet in the psum, else within 1e-5 × max(1, max|logits|)) and the
reference's forward (the engine tests' f32 limit, 1e-4).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _mesh_serve_worker as W

GROUPS = {"data=2,model=2": 4, "data=2": 2, "model=2": 2}
DATA_MESHES = [m for m in GROUPS if "data" in m]
CASES = W.CASES
F32_LIMIT = 1e-5
REF_F32_TOL = 1e-4
#: The forwards whose sums are exact under model=2 (top_k 2 over 2
#: ranks: a token's two outputs add on one rank or in the psum, and
#: a + 0 and b + a are exact); TP mode and tp_psum reduce partial
#: products, reordered.
BIT_EQUAL = {"deepseek-v3", "mixtral-ep"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's per-rank results, each group run once."""
    out = {}
    for mesh, world in GROUPS.items():
        d = tmp_path_factory.mktemp(mesh.replace(",", "_").replace("=", ""))
        W.spawn_group(mesh, world, str(d))
        out[mesh] = [json.load(open(d / f"{r}.json")) for r in range(world)]
        if mesh == "model=2":
            out["forward.npz"] = dict(np.load(d / "forward.npz"))
    return out


def _tokens(got):
    return {int(u): t for u, t in got.items()}


def _spec(mesh):
    from repro_torch.dist import MeshSpec
    return MeshSpec.parse(mesh)


@pytest.fixture(scope="module")
def single():
    """The port's single-device tokens per case."""
    return {case: W.serve(None, case=case,
                          clock=None if case == "fixed" else W.TickClock())[0]
            for case in CASES + ("sampled",)}


@pytest.fixture(scope="module")
def reference():
    """The reference's unsharded scheduler over the port's weights (seed
    0), per case."""
    import jax.numpy as jnp
    import repro
    from repro.configs import get_config as ref_config
    from repro.serve import Request
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import common as C
    cfg = get_config(W.ARCH, smoke=True)
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device="cpu"), init_seed=0)
    params = C.tree_map(lambda t: jnp.asarray(t.numpy()), exe.params)
    out = {}
    for case in CASES:
        bucketed = case != "fixed"
        ref = repro.compile(ref_config(W.ARCH, smoke=True),
                            repro.CompileOptions(target="engine"),
                            params=params)
        kw = {}
        if bucketed:
            kw = dict(W.bucketed_options(), buckets=repro.BucketPolicy.default(
                max_batch=W.SLOTS, max_len=W.MAX_LEN))
        sched = repro.serve(ref, repro.SchedulerOptions(
            slots=W.SLOTS, max_len=W.MAX_LEN, **kw),
            **({"clock": W.TickClock()} if bucketed else {}))
        for i, (p, new) in enumerate(zip(W.prompts(cfg.vocab),
                                         W.new_tokens(case))):
            sched.submit(Request(uid=i, prompt=p, max_new_tokens=new,
                                 slo_ms=W.SLO_MS[i] if bucketed else None))
        out[case] = {c.uid: list(c.tokens) for c in sched.run()}
        sched.shutdown()
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(GROUPS))
def test_every_rank_serves_the_single_device_tokens(runs, single, mesh, case):
    want = single[case]
    assert [len(want[u]) for u in range(W.N_PROMPTS)] == \
        list(W.new_tokens(case))
    for rank, r in enumerate(runs[mesh]):
        assert r[case]["error"] is None
        assert _tokens(r[case]["tokens"]) == want, (mesh, case, rank)


@pytest.mark.parametrize("case", CASES)
def test_single_device_tokens_equal_the_reference(single, reference, case):
    assert single[case] == reference[case]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(GROUPS))
def test_sharding_summary_has_the_reference_keys(runs, mesh, case):
    spec = _spec(mesh)
    for r in runs[mesh]:
        sh = r[case]["sharding"]
        assert sh["mesh"] == mesh and sh["devices"] == spec.size
        assert sh["decode_programs"] >= 1
        per = sh["collectives"]["per_axis"]
        split = {a for a, s in spec.axes if s > 1}
        assert set(per) == split and set(per) <= {"data", "model"}
        assert all(v["count"] >= 1 and v["bytes"] > 0 for v in per.values())
        assert sh["collectives"]["total_bytes"] == int(
            sum(v["bytes"] for v in per.values()))
        assert sh["collectives"]["counts"]["all-gather"] >= len(per)
        assert not sh["captured"]          # the CPU captures nothing
        assert r[case]["faults"] == []


def test_ranks_store_their_part_of_the_cache(runs):
    """``data`` halves the slots a rank stores; ``model`` alone keeps
    them all (it halves the KV sequence instead)."""
    for mesh, local in (("data=2,model=2", 2), ("data=2", 2),
                        ("model=2", 4)):
        assert {r["fixed"]["sharding"]["local_slots"]
                for r in runs[mesh]} == {local}
    # model-axis gathers move the sequence's other half: twice the bytes
    # on model=2 (4 local rows) as on data=2,model=2 (2 local rows)
    m2 = runs["model=2"][0]["fixed"]["sharding"]["collectives"]
    dm = runs["data=2,model=2"][0]["fixed"]["sharding"]["collectives"]
    assert m2["per_axis"]["model"]["bytes"] == \
        2 * dm["per_axis"]["model"]["bytes"]


@pytest.mark.parametrize("mesh", DATA_MESHES)
def test_compaction_moves_rows_within_and_across_data_shards(runs, single,
                                                             mesh):
    """Two slots a rank: 3 -> 2 and 1 -> 0 stay on one rank, 2 -> 1
    crosses; every rank takes part in the same moves and serves the
    single-device tokens."""
    for r in runs[mesh]:
        assert [tuple(m) for m in r["compacting"]["moves"]] == \
            list(W.COMPACTING_MOVES)
        assert r["compacting"]["sharding"]["local_slots"] == 2
        assert _tokens(r["compacting"]["tokens"]) == single["compacting"]


@pytest.mark.parametrize("mesh", DATA_MESHES)
def test_sampled_tokens_equal_single_device(runs, single, mesh):
    want = single["sampled"]
    assert want != single["compacting"]      # the draws are not greedy
    for r in runs[mesh]:
        assert r["sampled"]["error"] is None
        assert _tokens(r["sampled"]["tokens"]) == want


def test_shrinking_device_source_raises_and_records_the_fault(runs):
    for r in runs["data=2"]:
        f = r["fault"]
        assert f["error"] == {"type": "MeshUnavailableError",
                              "missing_axes": ["data"]}
        assert len(f["faults"]) == 1
        fault = f["faults"][0]
        assert set(fault) == {"at", "mesh", "needed", "available",
                              "missing_axes"}
        assert (fault["mesh"], fault["needed"], fault["available"],
                fault["missing_axes"]) == ("data=2", 2, 1, ["data"])


@pytest.mark.parametrize("name", [f[0] for f in W.FORWARDS])
def test_sharded_forward_matches_unsharded_on_model2(runs, name):
    for r in runs["model=2"]:
        rec = r["forwards"][name]
        assert rec["aux_equal"], name
        if name in BIT_EQUAL:
            assert rec["bit_equal"], (name, rec["max_abs_err"])
        else:
            assert rec["max_abs_err"] <= F32_LIMIT * rec["scale"], rec


@pytest.mark.parametrize("name", [f[0] for f in W.FORWARDS])
def test_sharded_forward_matches_reference(runs, name):
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import get_model as ref_model
    from repro_torch.models import common as C
    from repro_torch.models import get_model
    _, arch, changes = next(f for f in W.FORWARDS if f[0] == name)
    cfg = W.forward_cfg(arch, changes)
    params = get_model(cfg).init(0, "cpu")
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               dtype="float32", **changes)
    rparams = C.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    want, _ = ref_model(rcfg).forward(
        rparams, {"tokens": jnp.asarray(W.forward_inputs(cfg.vocab))})
    np.testing.assert_allclose(runs["forward.npz"][name],
                               np.asarray(want, np.float32),
                               rtol=REF_F32_TOL, atol=REF_F32_TOL)


def test_serve_cli_on_a_mesh_of_two_ranks():
    """``torch.distributed.run`` starts two ranks of the serve CLI on
    ``data=2``; only rank 0 prints, and its summary has the mesh's
    blocks and a single-device CLI run's counts."""
    env = dict(os.environ, PYTHONPATH="src")
    args = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
            "--requests", "4", "--slots", "2", "--max-new", "6", "--json"]
    one = subprocess.run([sys.executable] + args, env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2"] + args + ["--mesh", "data=2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    summ = json.loads(two.stdout)        # one JSON object: rank 0 alone
    base = json.loads(one.stdout)
    assert summ["sharding"]["mesh"] == "data=2"
    assert summ["faults"] == []
    for k in ("completed", "total_new_tokens", "decode_steps"):
        assert summ[k] == base[k]
