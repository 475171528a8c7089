"""The dry-run's weighing for serving cells, and on a mesh.

Prefill and decode of the ten SMOKE configs on one device and at rank 0
of a fake ``data=2,model=2`` group (the partitioned serving program),
and the train step of qwen2.5-14b (plain and with ``tp_psum``) and
mixtral-8x22b there: the counts weighed from the traced depths equal
the program traced whole, collectives included."""

import dataclasses

import pytest

import _weigh_cases as W
from repro_torch.configs import ARCH_NAMES
from repro_torch.launch import cells


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_weighed_equals_whole(arch, kind):
    W.assert_weighed_equals_whole(W.counted_config(arch), kind)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_serve_weighed_equals_whole(arch, kind):
    with cells.dry_group("data=2,model=2", device="cpu") as live:
        lowered, whole = W.assert_weighed_equals_whole(
            W.counted_config(arch), kind, live)
    # the split compute talks over model
    assert whole.cost.collective_bytes["all-reduce"] > 0
    assert lowered.rank == 0
    assert lowered.argument_bytes == lowered.placed_argument_bytes


@pytest.mark.parametrize("arch,tp", [("qwen2.5-14b", False),
                                     ("qwen2.5-14b", True),
                                     ("mixtral-8x22b", False)],
                         ids=["qwen2.5-14b", "qwen2.5-14b-tp_psum",
                              "mixtral-8x22b"])
def test_mesh_train_weighed_equals_whole(arch, tp):
    cfg = dataclasses.replace(W.counted_config(arch), tp_psum=tp)
    with cells.dry_group("data=2,model=2", device="cpu") as live:
        lowered, whole = W.assert_weighed_equals_whole(cfg, "train", live)
    # the gradient reduce (data) and the split compute (model) talk
    assert whole.cost.collective_bytes["all-reduce"] > 0
    assert lowered.rank == 0
