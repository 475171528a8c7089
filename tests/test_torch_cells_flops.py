"""The dry-run's train-step FLOPs against the reference's.

For the ten SMOKE configs at a global batch of 8 x 64 in 2 microbatches,
the port's FLOPs of one device's train step (traced whole on fake cpu
tensors) against the reference's ``flops_per_device`` x chips from its
own ``lower_cell`` and ``flops_from_pre`` on a 1-device mesh and on
``data=2,model=2``: within 1%, or a kept divergence of ROADMAP C held to
its measured ratio within 0.5% (``tests/_dryrun_oracle.py``).  The
reference lowers in a subprocess while the port traces here.
"""

import pytest

import _dryrun_oracle as O
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_config
from repro_torch.launch import cells
from repro_torch.training import TrainConfig


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("flops") / "reference.json"
    proc = O.start_reference(path, ["train"])
    try:
        yield lambda: O.reference(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_flops_match_reference(ref, arch):
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec("t", O.SEQ, O.BATCH, "train")
    port = cells.trace_program(cfg, shape, None,
                               TrainConfig(microbatches=O.MICROBATCHES),
                               device="cpu").cost.flops
    want = ref()
    for chips in O.MESHES:
        O.check_ratio(arch, "train", chips, port,
                      want[f"{arch}|train|{chips}"])
