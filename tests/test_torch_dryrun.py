"""The dry-run's command line (``python -m repro_torch.launch.dryrun``)
at the published widths on the CPU, and the entry points that must not
fall back to the CPU without a card.

qwen2.5-14b and mixtral-8x22b x train_4k on the 16x16 production mesh
(rank 0 of a fake group of 256) each write their record in a subprocess
under 180 s; the record has the reference's keys that carry over, finite
terms, and the rank's argument bytes: its state, as ``StateLayout`` says
the rank holds it (its part of every leaf, the reference's placement:
equal to ``argument_size_if_placed``), plus its rows of the batch.
qwen2.5-14b x decode_32k there counts the partitioned serving program
(``cells.serve_program``): its argument bytes (the rank's part of the
params and of the cache, and its rows) equal the placed bytes and the
reference's, its FLOPs a rank within 1.25 x the reference's.
``--shape long_500k`` is skipped with the reference's reason, and
``--device cuda`` on a machine without a card exits with an error
naming ``--device cpu`` before anything is traced."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.models import get_model
from repro_torch.training import TrainConfig, make_jitted_train_step
from repro_torch.training.train import StateLayout, rank_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_LIMIT_S = 180

#: The reference's record keys whose meaning carries over (its XLA-only
#: keys are left out).
KEYS = {"arch", "shape", "mesh", "chips", "flops_per_device",
        "bytes_per_device", "collective_bytes_per_device", "memory_analysis",
        "compute_s", "memory_s", "collective_s", "bottleneck", "model_flops",
        "useful_flops_ratio", "step_time_bound_s", "roofline_fraction",
        "status", "mesh_kind", "lower_s"}
XLA_ONLY = {"xla_raw_flops", "xla_raw_bytes", "unresolved_whiles"}


def _cli(out, *args):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--out", str(out), *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The two train_4k records, their CLIs run side by side."""
    out = tmp_path_factory.mktemp("dryrun")
    archs = ("qwen2.5-14b", "mixtral-8x22b")
    procs = [_cli(out, "--arch", a, "--shape", "train_4k", "--device", "cpu")
             for a in archs]
    try:
        for p in procs:
            _, err = p.communicate(timeout=CLI_LIMIT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {a: json.loads((out / f"{a}__train_4k__single.json").read_text())
            for a in archs}


def _state_bytes(arch):
    """The bytes of rank 0's train state on 16x16 from StateLayout's
    shapes (params, both moments, the step) and its rows of train_4k
    (tokens and labels, int32)."""
    model = get_model(get_config(arch))
    dtypes = {p: t.dtype for p, t in _flat(model.init(0, "meta"))}
    with cells.dry_group(production_mesh_spec(), 0, "cpu") as live:
        layout = StateLayout(model, live)
        rows = sum(hi - lo for lo, hi in rank_rows(256, 8, live))
    params = sum(math.prod(s) * torch.empty((), dtype=dtypes[p]).element_size()
                 for p, s in layout.shapes.items())
    return 3 * params + 4 + 2 * rows * 4096 * 4


def _flat(tree):
    from repro_torch.models.common import tree_flatten
    return tree_flatten(tree)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x22b"])
def test_train_4k_record(records, arch):
    rec = records[arch]
    assert KEYS <= set(rec) and not (XLA_ONLY & set(rec))
    assert rec["status"] == "ok" and rec["mesh_kind"] == "single"
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["rank"] == 0 and rec["device"] == "cpu"
    for k in ("compute_s", "memory_s", "collective_s", "step_time_bound_s",
              "roofline_fraction", "useful_flops_ratio"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["step_time_bound_s"] == max(rec["compute_s"], rec["memory_s"],
                                           rec["collective_s"])
    assert rec["depth"] == {"layer": 56 if arch == "mixtral-8x22b" else 48}
    assert rec["microbatches"] == 8
    assert [t["depth"]["layer"] for t in rec["traced"]] == [1, 2]
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _state_bytes(arch)
    assert mem["argument_size_in_bytes"] == rec["argument_size_if_placed"]
    assert mem["alias_size_in_bytes"] == mem["argument_size_in_bytes"] \
        - 2 * 16 * 4096 * 4
    # the gradient reduce over data, and (mixtral) the experts' sums
    assert rec["collective_bytes_per_device"]["all-reduce"] > 0


def test_mixtral_rank_holds_its_part_of_each_expert(records):
    """mixtral's 8 experts on a 16-way model axis: each rank holds a
    sixteenth of every expert's hidden width and, over ``data``, a
    sixteenth of its ``d_model`` (``fsdp``), params and moments; its
    arguments are the placed bytes."""
    cfg = get_config("mixtral-8x22b")
    model = get_model(cfg)
    with cells.dry_group(production_mesh_spec(), 0, "cpu") as live:
        layout = StateLayout(model, live)
    L, e, d, f = cfg.num_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert layout.shapes["layers/ffn/wi_gate"] == (L, e, d // 16, f // 16)
    assert layout.shapes["layers/ffn/wo"] == (L, e, f // 16, d // 16)
    rec = records["mixtral-8x22b"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        rec["argument_size_if_placed"]


#: The reference's count of qwen2.5-14b x decode_32k on the 16x16 mesh
#: (``python -m repro.launch.dryrun --arch qwen2.5-14b --shape
#: decode_32k``): FLOPs and argument bytes a device.
REF_DECODE_32K = {"flops_per_device": 30_096_752_640,
                  "argument_size_in_bytes": 3_454_066_752}
SERVE_FLOPS_OVER_REF = 1.25


def test_decode_32k_record(tmp_path):
    p = _cli(tmp_path, "--arch", "qwen2.5-14b", "--shape", "decode_32k",
             "--device", "cpu")
    _, err = p.communicate(timeout=CLI_LIMIT_S)
    assert p.returncode == 0, err[-3000:]
    rec = json.loads((tmp_path / "qwen2.5-14b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == rec["argument_size_if_placed"] \
        == REF_DECODE_32K["argument_size_in_bytes"]
    assert 0 < rec["flops_per_device"] <= \
        SERVE_FLOPS_OVER_REF * REF_DECODE_32K["flops_per_device"]
    # the rank's part of the cache is donated, and the split compute talks
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert rec["collective_bytes_per_device"]["all-reduce"] > 0


def test_long_500k_is_skipped(tmp_path):
    p = _cli(tmp_path, "--arch", "qwen2.5-14b", "--shape", "long_500k",
             "--device", "cpu")
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    rec = json.loads((tmp_path / "qwen2.5-14b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == "full-attention arch; long_500k skipped per spec"
    assert "skipped" in out


def test_cuda_without_a_card_is_refused(tmp_path):
    """``--device cuda`` (the default) without a card exits with an
    error that names ``--device cpu``, before a fake CUDA tensor could
    abort the process; nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(tmp_path, "--arch", "qwen2.5-14b", "--shape", "train_4k")
    _, err = p.communicate(timeout=120)
    assert p.returncode == 2, err
    assert "--device cpu" in err
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cells.lower_cell(get_config("qwen2.5-14b", smoke=True),
                         ShapeSpec("t", 8, 2, "train"))


def test_mesh_train_step_without_a_card_raises():
    """A mesh train step built from a spec runs on the card unless told
    otherwise: without one it raises, naming ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    model = get_model(get_config("minicpm-2b", smoke=True))
    with cells.dry_group("data=2", device="cpu"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_jitted_train_step(model, TrainConfig(), mesh="data=2")
        step = make_jitted_train_step(model, TrainConfig(), mesh="data=2",
                                      device="cpu")
        assert step.mesh.device == torch.device("cpu")
