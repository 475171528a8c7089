"""The trainer on the card against the CPU (needs an NVIDIA GPU).

The ``cuda``-marked twins of ``chip_smoke.py``'s train phase (t1) and
(t3) at SMOKE size: one train step of each of the ten ``SMOKE`` configs
at f32 on the card and on the CPU from the same state and batch (the
loss within 1e-5 x max(1, |loss|), ``grad_norm`` within 1e-5 relative,
the updated params within 1e-4 x max(1, max|p|) with TF32 off), a
checkpoint written from the card that restores bit-equal onto the card
and onto the CPU, and three captured train steps bit-equal to three
eager ones under deterministic algorithms, donated and not.  This file
imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_training_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import (CapturedTrainStep, OptConfig,
                                  TrainConfig, init_state,
                                  make_jitted_train_step)
from repro_torch.training.train import make_train_step

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base"]
LOSS_TOL = 1e-5
NORM_TOL = 1e-5
PARAM_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 is on; the f32 comparison needs it off")
    return "cuda"


def _batch(cfg, b=2, s=16):
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_card_matches_cpu(arch, card):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, eps=1e-6, total_steps=10,
                                   warmup_steps=0))
    cpu = init_state(model, 0, "cpu")
    dev = tree_map(lambda t: t.to(card), cpu)
    batch = _batch(cfg)
    s_cpu, m_cpu = make_jitted_train_step(model, tc)(cpu, batch)
    s_dev, m_dev = make_jitted_train_step(model, tc)(dev, batch)
    assert m_dev["loss"].device.type == "cuda"
    want = float(m_cpu["loss"])
    assert abs(float(m_dev["loss"]) - want) <= LOSS_TOL * max(1.0, abs(want))
    norm = float(m_cpu["grad_norm"])
    assert abs(float(m_dev["grad_norm"]) - norm) <= NORM_TOL * norm
    for a, b in zip(tree_leaves(s_dev["params"]), tree_leaves(s_cpu["params"])):
        scale = max(1.0, float(b.abs().max()))
        assert float((a.cpu() - b).abs().max()) <= PARAM_TOL * scale


def test_checkpoint_round_trip_from_card(card, tmp_path):
    model = get_model(get_config("minicpm-2b", smoke=True))
    state = init_state(model, 0, card)
    state["params"]["layers"]["ln1"] = state["params"]["layers"]["ln1"].to(
        torch.bfloat16)
    make = make_jitted_train_step(model, TrainConfig(opt=OptConfig(
        warmup_steps=0)))
    state, _ = make(state, _batch(model.cfg))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    ck.wait()
    for device in (None, "cpu"):
        out = ck.restore(1, state, device=device)
        for a, b in zip(tree_leaves(out), tree_leaves(state)):
            assert a.device.type == (device or "cuda")
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x22b",
                                  "whisper-base"])
def test_three_captured_steps_bit_equal_to_eager(card, arch, donate,
                                                monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, eps=1e-6, total_steps=10,
                                   warmup_steps=0), microbatches=2)
    start = init_state(model, 0, card)
    eager_state = tree_map(torch.clone, start)
    state = tree_map(torch.clone, start)
    step = make_jitted_train_step(model, tc, donate=donate)
    eager = make_train_step(model, tc, donate=True)
    assert isinstance(step, CapturedTrainStep)
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(3):
            batch = _batch(cfg, b=4)
            state, met = step(state, batch)
            _, want = eager(eager_state, batch)
            for k in ("loss", "lr", "grad_norm"):
                assert torch.equal(met[k], want[k]), k
    finally:
        torch.use_deterministic_algorithms(False)
    assert step.captured
    for a, b in zip(tree_leaves(state), tree_leaves(eager_state)):
        assert torch.equal(a, b)
