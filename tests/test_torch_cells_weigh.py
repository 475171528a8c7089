"""The dry-run's weighing (``launch/op_analysis.py``): the counts of a
train step traced at a few depths and two microbatches, carried to the
config's depth and microbatches, equal the step traced whole, on one
device on fake cpu tensors.  The transformer families here; the others
in ``test_torch_cells_weigh_families.py``."""

import pytest

import _weigh_cases as W

ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_weighed_equals_whole(arch):
    W.assert_weighed_equals_whole(W.counted_config(arch), "train")


@pytest.mark.parametrize("microbatches", [3, 4])
def test_microbatches_weighed_equal_whole(microbatches):
    """Two traced microbatches carry to more: each further one adds
    what a ``microbatch`` region of the trace counts."""
    lowered, _ = W.assert_weighed_equals_whole(
        W.counted_config("minicpm-2b"), "train", microbatches=microbatches)
    assert lowered.microbatches == microbatches
    assert {t["microbatches"] for t in lowered.traced} == {2}
