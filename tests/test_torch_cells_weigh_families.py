"""The dry-run's weighing for the MoE, vlm, ssm, hybrid and audio
families' train steps (``test_torch_cells_weigh.py`` has the dense
transformers): weighed counts equal the step traced whole."""

import pytest

import _weigh_cases as W

ARCHS = ("mixtral-8x22b", "mamba2-780m", "internvl2-2b",
         "recurrentgemma-9b", "whisper-base")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_weighed_equals_whole(arch):
    W.assert_weighed_equals_whole(W.counted_config(arch), "train")
