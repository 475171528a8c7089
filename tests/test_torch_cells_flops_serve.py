"""The dry-run's prefill and decode FLOPs: against the reference's, and
what ``data`` and ``model`` do to a rank's share of the partitioned
serving program (``launch.cells.serve_program``).

For the ten SMOKE configs at a batch of 8 x 64, one device's prefill
and decode FLOPs against the reference's on a 1-device mesh, and four
times rank 0's at a fake ``data=2,model=2`` group against the
reference's on that mesh (within 1%, or a kept divergence held to its
ratio; ``tests/_dryrun_oracle.py``).  Then each rank's share on a fake
group: on ``data=2`` a rank runs half the rows, so twice its FLOPs are
one device's exactly, except that a MoE routes the whole microbatch
where no ``model`` axis splits its experts; on ``model=2`` every family
splits its heads, MLP columns and vocab rows, so twice rank 0's FLOPs
are one device's, times what ROADMAP C keeps whole on every ``model``
rank, held to its measured ratio within 0.5%: deepseek-v3-671b's MLA
down projections and router, mixtral-8x22b's router, mamba2-780m's
mixer, internvl2-2b's image projection (prefill), recurrentgemma-9b's
one KV head.
"""

import dataclasses

import pytest

import _dryrun_oracle as O
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_config
from repro_torch.launch import cells

KINDS = ("prefill", "decode")
#: (arch, kind) -> 2 x rank 0's FLOPs on model=2 over one device's,
#: measured, where the rank repeats a kept product (else 1).
MODEL2_KEPT = {("deepseek-v3-671b", "prefill"): 1.07494,
               ("deepseek-v3-671b", "decode"): 1.06557,
               ("mixtral-8x22b", "prefill"): 1.00214,
               ("mixtral-8x22b", "decode"): 1.00211,
               ("mamba2-780m", "prefill"): 1.99620,
               ("mamba2-780m", "decode"): 1.78451,
               ("internvl2-2b", "prefill"): 1.00281,
               ("recurrentgemma-9b", "prefill"): 1.01147,
               ("recurrentgemma-9b", "decode"): 1.01132}
KEPT_LIMIT = 0.005


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
    cfg = get_config(arch, smoke=True)
    with cells.dry_group("data=2,model=2", 0, "cpu") as live:
        rank0 = {k: _flops(cfg, k, live) for k in KINDS}
    want = ref()
    for kind in KINDS:
        O.check_ratio(arch, kind, 1, one_device[arch, kind],
                      want[f"{arch}|{kind}|1"])
        O.check_ratio(arch, kind, 4, 4 * rank0[kind],
                      want[f"{arch}|{kind}|4"])


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
            # the head runs on the rank's rows too
            assert pre == one_device[arch, "prefill"], arch
            assert dec == one_device[arch, "decode"], arch


@pytest.mark.parametrize("tp", [False, True], ids=["plain", "tp_psum"])
def test_model_axis_splits_only_the_sharded_forms(one_device, tp):
    """Every family splits over ``model``; a rank repeats only the
    products the reference's constraints leave whole (ROADMAP C)."""
    with cells.dry_group("model=2", device="cpu"):
        for arch in ARCH_NAMES:
            if tp and arch != "qwen2.5-14b":
                continue
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      tp_psum=tp)
            for kind in KINDS:
                ratio = 2 * _flops(cfg, kind, "model=2") / \
                    one_device[arch, kind]
                want = MODEL2_KEPT.get((arch, kind), 1.0)
                assert abs(ratio - want) <= KEPT_LIMIT * want, \
                    (arch, kind, ratio)
