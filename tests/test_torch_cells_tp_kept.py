"""The dry-run's count of the mesh train step split over ``model``, for
the configs that repeat some products on every ``model`` rank: rank 0's
FLOPs of the SMOKE train cell at a fake ``data=2,model=2`` group, times
four, over one device's, held to the measured ratio within 0.5% (the
kept divergences of ROADMAP C; ``test_torch_cells_tp.py`` holds the
configs that repeat nothing):

* deepseek-v3-671b: MLA's down projections (``q_down``, ``kv_down``),
  which the reference's constraints leave whole, and the MoE router run
  on every ``model`` rank;
* mixtral-8x22b: the MoE router runs on every ``model`` rank;
* mamba2-780m: the mixer stays whole on ``model`` (its ``in_proj`` packs
  z|x|B|C|dt in one ``mlp`` dim, so a column cut crosses its parts); only
  the tied head is vocab-parallel;
* recurrentgemma-9b: its one KV head (``n_kv_heads=1``) is computed on
  every rank.
"""

import pytest

from test_torch_cells_tp import rank0_and_one_device

#: arch -> 4 x rank 0's FLOPs over one device's, measured.
KEPT = {"deepseek-v3-671b": 1.09690, "mixtral-8x22b": 1.00204,
        "mamba2-780m": 1.83673, "recurrentgemma-9b": 1.01135}
KEPT_LIMIT = 0.005


@pytest.mark.parametrize("arch", sorted(KEPT))
def test_rank0_repeats_the_kept_products(arch):
    rank0, one = rank0_and_one_device(arch)
    ratio = 4 * rank0 / one
    assert abs(ratio - KEPT[arch]) <= KEPT_LIMIT * KEPT[arch], (arch, ratio)
