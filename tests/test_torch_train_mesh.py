"""The mesh train step on ``data=2``: two gloo ranks on the CPU
(``tests/_train_mesh_worker.py``), spawned once for the module.

Each of the ten SMOKE configs at f32, plus ``microbatches=2`` (minicpm-2b
and mixtral-8x22b), ``compress_grads``, ``cast_params`` and labels whose
unmasked counts differ between the two row parts, from params drawn with
``np.random.default_rng``: three steps, each against the port's
one-device computation of that step from the same state and global batch
(``_train_mesh_worker.expected_step``):

* the loss within 1e-5 x max(1, |loss|), each reduced gradient leaf
  within 1e-4 x max(1, max|g|), ``grad_norm`` within 1e-5 relative;
* params and moments bit-equal on every rank that holds the same part
  (each rank holds its part of every leaf with an ``fsdp`` dim), the
  state gathered whole the same bits as the replicated layout's (AdamW
  on the whole state with the whole reduced gradients), and the loss
  and ``grad_norm`` the same bits on both;
* each rank's rows the reference's microbatch grouping (``rank_rows``);
* nothing cut over ``model`` in compute on a ``data``-only mesh, the
  state cut over ``data`` alone;
* the reference oracle on ``data=2`` (``_train_mesh_worker.ORACLE_SCRIPT``
  on 2 host devices, Auto axes): qwen2.5-14b and mixtral-8x22b SMOKE at
  f32, the port's 3 losses from the same params within the limits of
  ``test_torch_train_mesh_model.py``.  On a mesh without ``model`` the
  reference's MoE routes each microbatch whole, and so does the port's.

The one-device computation is the one-device step on the global batch
(a MoE too: it routes the whole microbatch here), except where the mesh
step is per row part by design (the bf16 gradients of ``cast_params``
are each rank's, before the reduce; ``compress_grads`` rounds each
microbatch's reduced mean): there each microbatch's gradient is the mean
over the row parts of the one-device gradient on each part's rows.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import _train_mesh_worker as W

MESH = "data=2"
NAMES = [n for n, c in W.CASES.items()
         if c[0] == MESH and n not in W.PLACEMENT_CASES]
LOSS_TOL, GRAD_TOL, NORM_TOL = 1e-5, 1e-4, 1e-5
ORACLE_TOL = (1e-5, 1e-4, 1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    oracle = W.reference_oracle(MESH, str(tmp_path_factory.mktemp("oracle")),
                                ROOT)
    d = tmp_path_factory.mktemp("data2")
    W.spawn_group(MESH, W.GROUPS[MESH], str(d), NAMES, oracle)
    return [json.load(open(d / f"{r}.json")) for r in range(W.GROUPS[MESH])]


def check_oracle(res):
    """The port's 3 losses against the reference's, on one rank."""
    got, want = res["loss"], res["want"]
    assert len(got) == len(want) == 3
    for s, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= ORACLE_TOL[s] * max(1.0, abs(b)), (s, a, b)


def check_against_one_device(res):
    """Every step of one rank's case within the limits."""
    assert res["finite"]
    for s in range(W.STEPS):
        loss, want = res["loss"][s], res["loss_want"][s]
        assert abs(loss - want) <= LOSS_TOL * max(1.0, abs(want)), (s, loss,
                                                                    want)
        assert res["grad_ratio"][s] <= GRAD_TOL, (s, res["worst_leaf"][s],
                                                  res["grad_ratio"][s])
        norm, want = res["norm"][s], res["norm_want"][s]
        assert abs(norm - want) <= NORM_TOL * want, (s, norm, want)
    # gradients rounded to bf16 on a split mesh: also one device's within
    # one bf16 ulp at each leaf's largest magnitude
    for s, ulps in enumerate(res.get("one_ulps", [])):
        assert ulps <= 1.0, (s, ulps)


def check_replicas_bit_equal(results):
    """Params and moments the same bits on every rank that holds the
    same part of a leaf (the ranks whose coordinates agree on every axis
    the leaf is cut over; every rank, for a leaf held whole); the state
    gathered whole on each rank the same bits as the replicated layout's
    (AdamW on the whole state with the whole reduced gradients); the
    loss and ``grad_norm`` the same bits on every rank."""
    for s in range(W.STEPS):
        for key, pre in (("param_sha", "params/"), ("moment_sha", "opt/")):
            for path in results[0][key][s]:
                groups = {}
                for res in results:
                    axes = res["cut_axes"].get(pre + path, [])
                    coord = tuple(res["coords"][a] for a in axes)
                    groups.setdefault(coord, set()).add(res[key][s][path])
                assert all(len(v) == 1 for v in groups.values()), (
                    s, key, path)
        for key in ("loss", "norm"):
            assert len({res[key][s] for res in results}) == 1, (s, key)
        assert all(res["whole_equal"][s] for res in results), s


@pytest.mark.parametrize("name", NAMES)
def test_mesh_step_matches_one_device(ranks, name):
    for res in ranks:
        check_against_one_device(res[name])


@pytest.mark.parametrize("name", NAMES)
def test_state_bit_equal_across_ranks(ranks, name):
    check_replicas_bit_equal([res[name] for res in ranks])


@pytest.mark.parametrize("name", NAMES)
def test_rows_are_the_reference_grouping_and_nothing_is_cut(ranks, name):
    """Nothing is cut in compute; the state is cut over ``data`` alone
    (its ``fsdp`` dims)."""
    n = W.CASES[name][3].get("microbatches", 1)
    for r, res in enumerate(ranks):
        assert res[name]["rows"] == [list(x) for x in W.part_rows(W.B, n, 2,
                                                                  r)]
        assert res[name]["cut"] == [] and res[name]["parts"]
        assert all(a == ["data"] for a in res[name]["cut_axes"].values())


def test_unequal_case_counts_differ_between_row_parts():
    """The masked case is one the mean of per-rank means gets wrong."""
    cfg = W.config("minicpm-2b")
    labels = W.make_batch(cfg, masked=True)["labels"]
    counts = [int((labels[lo:hi] != -1).sum())
              for lo, hi in (r[0] for r in (W.part_rows(W.B, 1, 2, 0),
                                            W.part_rows(W.B, 1, 2, 1)))]
    assert counts[0] != counts[1], counts


@pytest.mark.parametrize("arch", W.ORACLE_ARCHS)
def test_reference_mesh_step_losses(ranks, arch):
    for res in ranks:
        check_oracle(res[f"oracle/{arch}"])
