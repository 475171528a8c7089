"""The engine target on the card against the CPU (needs an NVIDIA GPU).

The ``cuda``-marked twins of ``chip_smoke.py``'s engine phase (a): each
transformer-family ``SMOKE`` config compiled with ``target="engine"`` on
the card and on the CPU over the same weights (made on the CPU from a
seed): f32 forward logits within 1e-4 x max(1, max|logits|) with TF32
off, prefill plus 8 greedy decode steps giving the same tokens, and the
configured bf16 forward within the reference's 0.05 budget.  This file
imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_models_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models import get_model

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b"]
F32_TOL = 1e-4
BF16_BUDGET = 0.05
B, S, STEPS = 2, 24, 8

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 is on; the f32 comparison needs it off")
    return "cuda"


def _pair(arch, dtype, device):
    base = get_config(arch, smoke=True)
    params = get_model(base).init(0, "cpu")
    cfg = dataclasses.replace(base, dtype=dtype)
    return [repro_torch.compile(
        cfg, repro_torch.CompileOptions(target="engine", device=dev),
        params=params) for dev in ("cpu", device)]


def _batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    return batch


def _greedy(exe, batch, device):
    model, params = exe.model, exe.params
    cache = model.init_cache(B, S + STEPS, device)
    feed = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    lg, cache = model.prefill(params, feed, cache)
    toks = []
    for _ in range(STEPS):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        lg, cache = model.decode_step(params, cache, tok)
    return torch.cat(toks, 1).cpu()


@pytest.mark.parametrize("arch", ARCHS)
def test_card_forward_f32_matches_cpu(card, arch):
    cpu, gpu = _pair(arch, "float32", card)
    batch = _batch(cpu.cfg)
    want = cpu(**batch)["logits"]
    got = gpu(**batch)["logits"]
    assert got.device.type == "cuda"
    err = float((got.cpu() - want).abs().max())
    limit = F32_TOL * max(1.0, float(want.abs().max()))
    assert err <= limit, (arch, err, limit)


@pytest.mark.parametrize("arch", ARCHS)
def test_card_greedy_decode_matches_cpu(card, arch):
    cpu, gpu = _pair(arch, "float32", card)
    batch = _batch(cpu.cfg)
    assert torch.equal(_greedy(gpu, batch, card), _greedy(cpu, batch, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_card_forward_bf16_within_budget(card, arch):
    cpu, gpu = _pair(arch, get_config(arch, smoke=True).dtype, card)
    batch = _batch(cpu.cfg)
    want = cpu(**batch)["logits"]
    got = gpu(**batch)["logits"]
    err = float((got.cpu() - want).abs().max())
    limit = BF16_BUDGET * max(1.0, float(want.abs().max()))
    assert err <= limit, (arch, err, limit)
