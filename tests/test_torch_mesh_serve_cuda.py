"""Mesh serving on the card (needs an NVIDIA GPU).

The ``cuda``-marked twins of ``test_torch_mesh_serve.py``: two rank
processes share the card over gloo (NCCL refuses two ranks on one
device), on ``data=2`` and on ``model=2``, serving the reference's
oracle at SMOKE size (qwen2.5-14b, 4 slots, max_len 64, 6 prompts, 8
new tokens) at a fixed shape, bucketed, and bucketed with staggered
budgets; every rank's tokens equal the single-device scheduler's on the
card.  Under ``data=2`` every decode
step with rows on a rank is a captured CUDA graph; under ``model=2`` the
steps gather the KV sequence over gloo and run eagerly.  The
expert-parallel MoE, its TP mode and ``tp_psum`` forward at f32 on
``model=2`` within 1e-5 × max(1, max|logits|) of the unsharded
forward.  This file imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_mesh_serve_cuda.py
"""

import json

import pytest
import torch

import _mesh_serve_worker as W

pytestmark = pytest.mark.cuda

MESHES = ("data=2", "model=2")
CASES = W.CASES
F32_LIMIT = 1e-5


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    """Each mesh's two ranks on the card, run once; and the single-device
    tokens on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 is on; the f32 comparison needs it off")
    out = {}
    for mesh in MESHES:
        d = tmp_path_factory.mktemp(mesh.replace("=", ""))
        W.spawn_group(mesh, 2, str(d), device="cuda")
        out[mesh] = [json.load(open(d / f"{r}.json")) for r in range(2)]
    out["single"] = {
        case: W.serve(None, case=case, device="cuda",
                      clock=None if case == "fixed" else W.TickClock())[0]
        for case in CASES}
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_card_ranks_serve_the_single_device_tokens(card_runs, mesh, case):
    want = card_runs["single"][case]
    for r in card_runs[mesh]:
        assert r[case]["error"] is None
        assert {int(u): t for u, t in r[case]["tokens"].items()} == want


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_card_steps_capture_unless_they_gather(card_runs, mesh, case):
    for r in card_runs[mesh]:
        sh = r[case]["sharding"]
        assert sh["captured"] is (mesh == "data=2")
        assert r[case]["faults"] == []


@pytest.mark.parametrize("name", [f[0] for f in W.FORWARDS])
def test_card_sharded_forward_matches_unsharded(card_runs, name):
    for r in card_runs["model=2"]:
        rec = r["forwards"][name]
        assert rec["max_abs_err"] <= F32_LIMIT * rec["scale"], rec
        assert rec["aux_equal"]
