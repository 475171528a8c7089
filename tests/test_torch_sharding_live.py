"""ShardedExecutable on live meshes: gloo groups of 2 and 4 processes on
the CPU (``tests/_dist_worker.py``), each spawned once per module with a
``file://`` rendezvous in a temporary directory.

Against the unsharded program of the same options, called in the same
rank on the same global inputs (numpy seeds):

* ``model=2``: f32 outputs within 1e-5 × max(1, max|out|), int8
  bit-equal (the row-parallel dense all-reduces exact int32 sums);
* ``data=2``: each rank's rows bit-equal to the unsharded program
  called on those rows alone; at batch 1, which does not divide, every
  rank runs the whole batch, bit-equal to the unsharded output;
* ``data=2,model=2``: within the f32 limit, int8 bit-equal.

Each rank's weight slices are half the full channels along one dim; the
MLP block's row-parallel dense applies its bias (3.0) and relu once;
``cost_summary()["sharding"]["collectives"]`` equals the reference's
``collective_summary``; a serialized executable deserializes on every
rank by replaying its placement.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_worker as W

GROUPS = {"model=2": 2, "data=2": 2, "data=2,model=2": 4}
F32_LIMIT = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's per-rank results, each group run once."""
    out = {}
    for mesh, world in GROUPS.items():
        d = tmp_path_factory.mktemp(mesh.replace(",", "_").replace("=", ""))
        W.spawn_group(mesh, world, str(d))
        out[mesh] = [json.load(open(d / f"{r}.json")) for r in range(world)]
    return out


CASES = [(m, p, b) for m in list(W.MODELS) + ["mlp"]
         for p in W.PRECISIONS for b in W.BATCHES]


def _key(model, precision, batch):
    return f"{model}/{precision}/{batch}"


@pytest.mark.parametrize("model,precision,batch", CASES)
def test_model_axis_within_limit_and_int8_exact(runs, model, precision,
                                                batch):
    for mesh in ("model=2", "data=2,model=2"):
        for rank, res in enumerate(runs[mesh]):
            r = res[_key(model, precision, batch)]
            if precision == "int8":
                assert r["equal"], (mesh, rank, r["err"])
            else:
                assert r["err"] <= F32_LIMIT * r["scale"], (mesh, rank, r)


@pytest.mark.parametrize("model,precision,batch", CASES)
def test_data_axis_rows_bit_equal(runs, model, precision, batch):
    for rank, res in enumerate(runs["data=2"]):
        r = res[_key(model, precision, batch)]
        assert r["rows_split"] == (2 if batch % 2 == 0 else 1)
        assert r["rows_equal"], (rank, r["err"])
        assert r["equal"], (rank, r["err"])
        assert r["sliced"] == {} and not r["communicates"]


@pytest.mark.parametrize("model", ["C-HTWK", "C-BH", "VGG19", "mlp"])
def test_weight_slices_halve_one_dim(runs, model):
    """Every sliced param keeps its rank and halves exactly one dim;
    column-parallel kernels, their bias and dequant vectors, and
    row-parallel kernels (bias whole) are among them."""
    res = runs["model=2"][1][_key(model, "int8", 4)]
    assert res["sliced"], "nothing sliced under model=2"
    for name, shape in res["sliced"].items():
        full = res["full"].get(name)
        if full is None:          # a quantized operand: no graph param
            continue
        assert len(shape) == len(full)
        halved = [d for d, (a, b) in enumerate(zip(shape, full)) if a != b]
        assert len(halved) == 1 and full[halved[0]] == 2 * shape[halved[0]]
    kinds = {n.rsplit("/", 1)[-1] for n in res["sliced"]}
    assert {"quant.wq", "quant.deq"} <= kinds


def test_row_parallel_epilogue_applies_once(runs):
    """The MLP block's contraction is row parallel (its input's channels
    split): a bias applied on both ranks would move every output by
    MLP_BIAS; the outputs stay within the f32 limit, bias and relu
    included."""
    for mesh in ("model=2", "data=2,model=2"):
        for res in runs[mesh]:
            r = res[_key("mlp", "exact", 4)]
            assert r["communicates"] and not r["captured"]
            assert r["err"] <= F32_LIMIT * r["scale"] < W.MLP_BIAS / 2


@pytest.mark.parametrize("mesh", list(GROUPS))
@pytest.mark.parametrize("model", ["C-HTWK", "C-BH", "VGG19", "Detector"])
def test_collectives_equal_the_reference(runs, mesh, model):
    from benchmarks.table1_models import SUITE
    from repro.core.passes import run_pipeline
    from repro.dist.mesh import MeshSpec
    from repro.dist.propagate import collective_summary
    g = SUITE[model]()
    g.dist = {"mesh": MeshSpec.parse(mesh).to_dict(), "rules": []}
    want = json.loads(json.dumps(collective_summary(run_pipeline(g)[0])))
    for res in runs[mesh]:
        assert res[_key(model, "exact", 4)]["collectives"] == want


@pytest.mark.parametrize("mesh", list(GROUPS))
def test_ranks_agree_and_know_their_coordinates(runs, mesh):
    world = GROUPS[mesh]
    coords = [res[_key("C-HTWK", "exact", 1)]["coords"] for res in runs[mesh]]
    names = [a.split("=")[0] for a in mesh.split(",")]
    sizes = [int(a.split("=")[1]) for a in mesh.split(",")]
    want = [dict(zip(names, np.unravel_index(r, sizes))) for r in range(world)]
    assert coords == [{k: int(v) for k, v in c.items()} for c in want]


@pytest.mark.parametrize("mesh", list(GROUPS))
def test_serialized_placement_replays_on_every_rank(runs, mesh):
    for res in runs[mesh]:
        r = res["round_trip"]
        assert r["type"] == "ShardedExecutable" and r["reused"]
        assert r["pass_reused"] is True
        assert r["dist_equal"] and r["nodes_equal"] and r["equal"]
