"""The mesh train step on the card (needs an NVIDIA GPU).

The ``cuda``-marked twins of ``chip_smoke.py``'s train_mesh phase (tm1)
at SMOKE size: two gloo ranks share the card (collectives staged through
the host), each running three f32 mesh train steps against the one-device
computation of each step on the card (``tests/_train_mesh_worker.py``,
the limits of ``test_torch_train_mesh.py``: loss within 1e-5 x max(1,
|loss|), each reduced gradient leaf within 1e-4 x max(1, max|g|),
``grad_norm`` within 1e-5 relative, TF32 off), params and moments
bit-equal across the ranks that hold the same part.  Cases: minicpm-2b
on ``data=2`` (plain and ``microbatches=2``), mixtral-8x22b on ``data=2``
and expert-parallel on ``model=2``, qwen2.5-14b with ``tp_psum`` on
``model=2``.  This file imports no JAX, so it runs on a machine without
it::

    python -m pytest -m cuda tests/test_torch_train_mesh_cuda.py
"""

import json

import pytest
import torch

import _train_mesh_worker as W
from test_torch_train_mesh import (check_against_one_device,
                                   check_replicas_bit_equal)

pytestmark = pytest.mark.cuda

NAMES = {"data=2": ["data2/minicpm-2b", "data2_microbatches/minicpm-2b",
                    "data2/mixtral-8x22b"],
         "model=2": ["model2/mixtral-8x22b", "model2_tp/qwen2.5-14b"]}
CASES = [(m, n) for m, names in NAMES.items() for n in names]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh step's ranks share the "
                    "card")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 is on; the f32 limits need it off")
    out = {}
    for mesh, names in NAMES.items():
        d = tmp_path_factory.mktemp(mesh.replace("=", ""))
        W.spawn_group(mesh, 2, str(d), names, device="cuda")
        out[mesh] = [json.load(open(d / f"{r}.json")) for r in range(2)]
    return out


@pytest.mark.parametrize("mesh,name", CASES)
def test_mesh_step_on_the_card_matches_one_device(groups, mesh, name):
    for res in groups[mesh]:
        check_against_one_device(res[name])


@pytest.mark.parametrize("mesh,name", CASES)
def test_state_on_the_card_bit_equal_across_ranks(groups, mesh, name):
    check_replicas_bit_equal([res[name] for res in groups[mesh]])
