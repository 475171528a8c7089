"""The mesh train step where ``model`` splits compute, and the reference's
own mesh step as an oracle: gloo groups of two (``model=2``) and four
(``data=2,model=2``) ranks on the CPU (``tests/_train_mesh_worker.py``).

* ``model=2``: the MoE configs expert-parallel, and ``tp_psum=True``
  for the transformer (qwen2.5-14b), mla (deepseek-v3-671b), rglru
  (recurrentgemma-9b) and whisper families; ``data=2,model=2``:
  qwen2.5-14b (plain and ``tp_psum``) and mixtral-8x22b.  Every case's
  compute is split over ``model`` (heads, MLP columns, vocab), as the
  reference's constraints split it.  Every rank
  holds its part of the state (the reference's placement).  Three steps
  each against the one-device computation of the same step, within the
  limits of ``test_torch_train_mesh.py``, params and moments bit-equal
  across the ranks that hold the same part and, gathered, the
  replicated layout's, the loss and ``grad_norm`` the same bits
  everywhere;
* the leaves model code cuts over ``model`` in compute
  (``step.cut_leaves``, from the ``split_param`` marks of a forward on
  the meta device) are exactly the weights the reference's constraints
  split (heads, KV heads, MLP columns, vocab rows, the routed experts;
  never a norm or the router), each held in part over ``model`` where
  its placement allows;
* each autograd-aware collective's forward and backward against the
  one-process computation over every rank's inputs; a mesh larger than
  the group is refused with ``MeshUnavailableError``, a smaller one with
  ``ValueError``, and so is a state whose experts are whole where the
  rank holds its part;
* a checkpoint of a partitioned state (the experts among its parts):
  byte-equal to one device's save of the gathered state, restored whole
  on one device and in part on each rank;
* the reference oracle (``_train_mesh_worker.ORACLE_SCRIPT``):
  ``repro.training.make_jitted_train_step`` on 4 host devices, the
  ``(data, model)`` mesh built with Auto axes (under jax 0.9
  ``jax.make_mesh`` makes Explicit ones, which the reference's
  ``with_sharding_constraint`` refuses), qwen2.5-14b and mixtral-8x22b
  SMOKE at f32 with the reference SPMD test's batch, microbatches and LR;
  the port's mesh step from the same params (``params_from_reference``)
  gives its 3 losses, step 1 within 1e-5 x max(1, |loss|), steps 2-3
  within 1e-4 x max(1, |loss|).  The reference's expert-parallel
  ``shard_map`` reports the first data shard's aux loss, and so does the
  port.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import _train_mesh_worker as W
from test_torch_train_mesh import (check_against_one_device, check_oracle,
                                   check_replicas_bit_equal)
from test_torch_train_tp import _expected_cuts, model_ranks

NAMES = {m: [n for n, c in W.CASES.items()
             if c[0] == m and n not in W.PLACEMENT_CASES
             and n not in W.TP_CASES]
         for m in ("model=2", "data=2,model=2")}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """{arch: the file of the reference's params, batch and 3 losses}."""
    return W.reference_oracle("data=2,model=2",
                              str(tmp_path_factory.mktemp("oracle")), ROOT)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, oracle):
    out = {}
    for mesh, names in NAMES.items():
        d = tmp_path_factory.mktemp(mesh.replace(",", "_").replace("=", ""))
        W.spawn_group(mesh, W.GROUPS[mesh], str(d), names,
                      oracle if mesh == "data=2,model=2" else None)
        out[mesh] = [json.load(open(d / f"{r}.json"))
                     for r in range(W.GROUPS[mesh])]
    return out


CASES = [(m, n) for m, names in NAMES.items() for n in names]


@pytest.mark.parametrize("mesh,name", CASES)
def test_mesh_step_matches_one_device(groups, mesh, name):
    for res in groups[mesh]:
        check_against_one_device(res[name])


@pytest.mark.parametrize("mesh,name", CASES)
def test_state_bit_equal_across_ranks(groups, mesh, name):
    check_replicas_bit_equal([res[name] for res in groups[mesh]])


@pytest.mark.parametrize("mesh,name", CASES)
def test_split_leaves_are_the_cut_weights(groups, mesh, name):
    """The leaves model code cuts over ``model`` in compute
    (``step.cut_leaves``) are the weights whose logical axes name
    ``heads``, ``kv_heads``, ``mlp``, ``vocab`` or ``experts``, with or
    without ``tp_psum`` (the split follows the reference's constraints;
    ``test_torch_train_tp.py``), never a norm or the router; each is held
    in part over ``model`` where its placement allows: every one but
    recurrentgemma's one KV head, which every rank computes whole."""
    arch = W.CASES[name][1]
    want = _expected_cuts(arch, W.CASES[name][2], model_ranks(mesh))
    for res in groups[mesh]:
        got = res[name]["cut"]
        assert sorted(got) == want, sorted(set(got) ^ set(want))
        whole = {p for p in got if arch == "recurrentgemma-9b"
                 and p.endswith(("/wk", "/wv"))}
        assert set(res[name]["held"]) == set(got) - whole, name
        for path in got:
            assert not any(k in path for k in ("ln", "norm", "router")), path
            assert "model" in res[name]["cut_axes"]["params/" + path], path
        assert set(got) - whole <= {p[len("params/"):]
                                    for p in res[name]["parts"]}


@pytest.mark.parametrize("mesh", list(NAMES))
@pytest.mark.parametrize("fn", ["copy_to_model", "reduce_from_model",
                                "gather_rows", "split_to_model", "all_reduce_",
                                "forward_alone_equal", "larger_mesh_refused",
                                "whole_state_refused"])
def test_collective_forward_and_backward(groups, mesh, fn):
    for res in groups[mesh]:
        assert res["collectives"][fn], (mesh, fn)


def test_mesh_leaving_ranks_out_is_refused(groups):
    for res in groups["data=2,model=2"]:
        assert res["collectives"]["smaller_mesh_refused"]


@pytest.mark.parametrize("check", ["byte_equal", "one_device_equal",
                                   "rank_equal"])
def test_checkpoint_of_cut_experts(groups, check):
    ranks = groups["model=2"]
    experts = {f"{pre}layers/ffn/{e}" for pre in ("params/", "opt/m/",
                                                  "opt/v/")
               for e in ("wi_gate", "wi_up", "wo")}
    assert all(experts <= set(res["checkpoint"]["parts"]) for res in ranks)
    have = [res["checkpoint"][check] for res in ranks
            if check in res["checkpoint"]]
    assert have and all(have), (check, have)


@pytest.mark.parametrize("arch", W.ORACLE_ARCHS)
def test_reference_mesh_step_losses(groups, arch):
    for res in groups["data=2,model=2"]:
        check_oracle(res[f"oracle/{arch}"])
