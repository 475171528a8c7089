"""The dry-run's prefill and decode FLOPs: against the reference's, and
what ``data`` and ``model`` do to a rank's share.

For the ten SMOKE configs at a batch of 8 x 64, one device's prefill
and decode FLOPs against the reference's on a 1-device mesh and on
``data=2,model=2`` (within 1%, or a kept divergence held to its ratio;
``tests/_dryrun_oracle.py``).  Then each rank's share on a fake group:
on ``data=2`` a rank runs half the rows (twice its prefill FLOPs are one
device's), except that a decode step's head runs at the full slot count
on every rank (serving's ``step_rows``) and a MoE routes the whole
microbatch where no ``model`` axis splits its experts; on ``model=2``
only the ``tp_psum`` projections and the expert-parallel MoE split
compute, and every other family repeats it whole on each rank.
"""

import dataclasses

import pytest

import _dryrun_oracle as O
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_config
from repro_torch.launch import cells

KINDS = ("prefill", "decode")
#: The families whose compute ``model`` splits: (arch, overrides).
SPLITS = {("qwen2.5-14b", True), ("mixtral-8x22b", False),
          ("deepseek-v3-671b", False)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("flops") / "reference.json"
    proc = O.start_reference(path, KINDS)
    try:
        yield lambda: O.reference(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _shape(kind):
    return ShapeSpec("t", O.SEQ, O.BATCH, kind)


def _flops(cfg, kind, mesh=None):
    return cells.trace_program(cfg, _shape(kind), mesh,
                               device="cpu").cost.flops


@pytest.fixture(scope="module")
def one_device():
    return {(a, k): _flops(get_config(a, smoke=True), k)
            for a in ARCH_NAMES for k in KINDS}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_flops_match_reference(ref, one_device, arch):
    want = ref()
    for kind in KINDS:
        for chips in O.MESHES:
            O.check_ratio(arch, kind, chips, one_device[arch, kind],
                          want[f"{arch}|{kind}|{chips}"])


def test_data_axis_splits_the_rows(one_device):
    with cells.dry_group("data=2", device="cpu"):
        for arch in ARCH_NAMES:
            cfg = get_config(arch, smoke=True)
            pre = 2 * _flops(cfg, "prefill", "data=2")
            dec = 2 * _flops(cfg, "decode", "data=2")
            if cfg.n_experts:
                # the whole microbatch routed on every rank
                assert pre > one_device[arch, "prefill"], arch
                assert dec > one_device[arch, "decode"], arch
                continue
            assert pre == one_device[arch, "prefill"], arch
            # each rank's head runs the other rank's rows too
            head = 2 * (O.BATCH // 2) * cfg.d_model * cfg.vocab
            assert dec - one_device[arch, "decode"] == 2 * head, arch


@pytest.mark.parametrize("tp", [False, True], ids=["plain", "tp_psum"])
def test_model_axis_splits_only_the_sharded_forms(one_device, tp):
    with cells.dry_group("model=2", device="cpu"):
        for arch in ARCH_NAMES:
            if tp and arch != "qwen2.5-14b":
                continue
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      tp_psum=tp)
            for kind in KINDS:
                got = _flops(cfg, kind, "model=2")
                if (arch, tp) in SPLITS:
                    assert got < one_device[arch, kind], (arch, kind)
                else:
                    assert got == one_device[arch, kind], (arch, kind)
