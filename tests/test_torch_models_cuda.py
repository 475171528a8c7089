"""The engine target on the card against the CPU (needs an NVIDIA GPU).

The ``cuda``-marked twins of ``chip_smoke.py``'s engine phase (a): each
of the ten ``SMOKE`` configs compiled with ``target="engine"`` on the
card and on the CPU over the same weights (made on the CPU from a seed):
f32 forward logits within 1e-4 x max(1, max|logits|) with TF32 off,
prefill plus 8 greedy decode steps giving the same tokens, and the
configured bf16 forward within the reference's 0.05 budget.  The twins
of (d)-(f) at SMOKE size: mamba2, recurrentgemma and whisper decode
against their own forward on the card at f32, over a prompt that is not
a multiple of mamba2's chunk and runs past recurrentgemma's window.
Each ``exe(...)`` call is a replay of the signature's captured forward:
bit-equal to ``model.forward`` run eagerly on the same params and batch,
one program a signature, and replaced params honoured.  This file
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
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base"]
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


def _batch(cfg, s=S):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
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


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-base"])
def test_card_decode_matches_forward_f32(card, arch):
    """Prefill 37 tokens, then 8 greedy steps on the card: each step's
    logits within 1e-4 x max(1, max|logits|) of the forward's over the
    prompt and the tokens chosen, and the forward's argmax the tokens."""
    _, gpu = _pair(arch, "float32", card)
    cfg, prompt = gpu.cfg, 37
    if cfg.family == "ssm":
        assert prompt % cfg.ssm_chunk
    if cfg.family == "hybrid":
        assert prompt > cfg.window
    batch = _batch(cfg, prompt)
    model, params = gpu.model, gpu.params
    feed = {k: torch.as_tensor(v, device=card) for k, v in batch.items()}
    cache = model.init_cache(B, prompt + STEPS, card)
    lg, cache = model.prefill(params, feed, cache)
    logits, toks = [lg[:, -1]], []
    for _ in range(STEPS):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        lg, cache = model.decode_step(params, cache, tok)
        logits.append(lg[:, -1])
    toks = torch.cat(toks, 1)
    full = gpu(**dict(batch, tokens=torch.cat(
        [feed["tokens"], toks], 1).cpu().numpy()))["logits"]
    want = full[:, prompt - 1:]
    err = float((torch.stack(logits, 1) - want).abs().max())
    limit = F32_TOL * max(1.0, float(want.abs().max()))
    assert err <= limit, (arch, err, limit)
    assert torch.equal(toks, want[:, :STEPS].argmax(-1).to(torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_replay_bit_equal_to_eager(card, arch):
    _, gpu = _pair(arch, "float32", card)
    calls = [_batch(gpu.cfg), _batch(gpu.cfg, s=S + 3), _batch(gpu.cfg)]
    for batch in calls:
        feed = {k: torch.as_tensor(v, device=card) for k, v in batch.items()}
        got = gpu(**batch)["logits"]
        with torch.inference_mode():
            want = gpu.model.forward(gpu.params, feed)[0]
        assert torch.equal(got, want), arch
    summary = gpu.programs
    assert summary["programs"] == 2 and summary["captured"], summary
    assert summary["pool_bytes"] > 0
    # new params: the programs are dropped, and the next call reads them
    gpu.params = get_model(gpu.cfg).init(1, card)
    assert gpu.programs["programs"] == 0
    got = gpu(**calls[0])["logits"]
    with torch.inference_mode():
        want = gpu.model.forward(gpu.params, {
            k: torch.as_tensor(v, device=card)
            for k, v in calls[0].items()})[0]
    assert torch.equal(got, want) and gpu.programs["captured"]
