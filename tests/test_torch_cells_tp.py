"""The dry-run's count of the mesh train step with its compute split over
``model``: the SMOKE train cells (8 x 64 in 2 microbatches) traced at
rank 0 of a fake ``data=2,model=2`` group (``cells.dry_group``) against
one device.

Where every product the reference's constraints split is split (heads,
KV heads, MLP columns, vocab rows), four times rank 0's FLOPs are one
device's within 1%: qwen2.5-14b, deepseek-7b, gemma3-27b, minicpm-2b,
internvl2-2b and whisper-base (every split even on this mesh, so rank 0
holds a quarter of each product).  The same traces are held against the
reference's ``flops_per_device`` x 4 on ``data=2,model=2``
(``_dryrun_oracle.check_ratio``; its lowering runs in a subprocess while
the port traces here).  The configs that repeat some products on
``model`` are held to their measured ratios in
``test_torch_cells_tp_kept.py``.

On ``model=8`` the SMOKE configs' 4 heads are fewer than the ranks:
the heads are then computed whole on every rank (no rank gets an empty
range), so rank 1 traces and counts rank 0's FLOPs.
"""

import json
import os
import subprocess
import sys

import pytest

import _dryrun_oracle as O
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import cells
from repro_torch.training import TrainConfig

SPLIT = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "internvl2-2b", "whisper-base")
LIMIT = 0.01


def rank0_and_one_device(arch):
    """(rank 0's FLOPs on data=2,model=2, one device's) of the arch's
    SMOKE train cell, traced on fake cpu tensors."""
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec("t", O.SEQ, O.BATCH, "train")
    tc = TrainConfig(microbatches=O.MICROBATCHES)
    one = cells.trace_program(cfg, shape, None, tc, device="cpu").cost.flops
    with cells.dry_group("data=2,model=2", 0, "cpu") as live:
        rank0 = cells.trace_program(cfg, shape, live, tc,
                                    device="cpu").cost.flops
    return rank0, one


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's train FLOPs per device on data=2,model=2."""
    path = tmp_path_factory.mktemp("flops_tp") / "reference.json"
    args = json.dumps([O.SEQ, O.BATCH, O.MICROBATCHES,
                       {"4": O.MESHES[4]}])
    proc = subprocess.Popen([sys.executable, "-c", O._SCRIPT, str(path),
                             args, "train"], cwd=O.ROOT,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        yield lambda: O.reference(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("arch", SPLIT)
def test_rank0_is_a_quarter_of_one_device(ref, arch):
    rank0, one = rank0_and_one_device(arch)
    assert abs(4 * rank0 / one - 1) <= LIMIT, (arch, rank0, one)
    O.check_ratio(arch, "train", 4, 4 * rank0, ref()[f"{arch}|train|4"])


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2.5-14b"])
def test_heads_fewer_than_model_ranks_run_whole_on_every_rank(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.n_heads < 8
    shape = ShapeSpec("t", O.SEQ, O.BATCH, "train")
    tc = TrainConfig(microbatches=O.MICROBATCHES)
    flops = []
    for rank in (0, 1):
        with cells.dry_group("model=8", rank, "cpu") as live:
            flops.append(cells.trace_program(cfg, shape, live, tc,
                                             device="cpu").cost.flops)
    assert flops[0] == flops[1] > 0, flops
