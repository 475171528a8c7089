"""Slice 11 on the card (needs an NVIDIA GPU): the int8 kernel's
int32-sums mode, a single-device mesh's captured programs, and the serve
decode step's independence of its bucket's row count.

* ``fused_matmul_q8(..., sums=True)`` bit-equal to its plain version at
  VGG19 ``dense_41``'s row shard under ``model=2`` (M=256, K=64, N=128)
  and at M=1, both layouts, and at a split K.
* A ``data=1,model=1`` compile of C-HTWK (exact and int8) is captured,
  as the unsharded one is, and bit-equal to it.
* qwen2.5-14b's SMOKE config at bf16: under ``step_rows`` the head and
  an f32 RMS norm give each row what they give it among the full slots'
  rows, and bucketed serving gives the tokens of fixed-shape serving.

This file imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_dist_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8
from repro_torch.runtime import BucketPolicy
from repro_torch.serve import Request, SchedulerOptions
from repro_torch.table1_models import SUITE

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.mark.parametrize("layout", ["io", "oi"])
@pytest.mark.parametrize("m,k,n", [(256, 64, 128), (1, 64, 128),
                                   (64, 4096, 96), (3, 2048, 40)])
def test_q8_sums_mode_bit_equal_to_plain(card, m, k, n, layout):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(
        -127, 128, (k, n) if layout == "io" else (n, k), dtype=np.int8))
    want = fused_matmul_q8(x, wq, None, x_scale=0.031, w_layout=layout,
                           sums=True)
    before = fused_matmul_q8.launches
    got = fused_matmul_q8(x.to(card), wq.to(card), None, x_scale=0.031,
                          w_layout=layout, sums=True)
    assert fused_matmul_q8.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("precision", ["exact", "int8"])
def test_single_device_mesh_captured_bit_equal(card, precision):
    g = SUITE["C-HTWK"]()
    opts = repro_torch.CompileOptions(target="cuda", precision=precision)
    base = repro_torch.compile(g, opts)
    exe = repro_torch.compile(g, opts.replace(mesh="data=1,model=1"))
    x = np.random.default_rng(0).standard_normal(
        (8,) + tuple(g.inputs["input"].shape)).astype(np.float32)
    want, got = base(input=x), exe(input=x)
    sh = exe.cost_summary()
    assert sh["sharding"]["captured"] and sh["programs"][8]["captured"]
    assert all(torch.equal(got[k], want[k]) for k in want)


def _serve(exe, buckets):
    cfg = exe.cfg
    sched = repro_torch.serve(exe, SchedulerOptions(
        slots=4, max_len=64, fold=False, buckets=buckets))
    rng = np.random.default_rng(0)
    for uid in range(6):
        sched.submit(Request(uid=uid, max_new_tokens=10, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(4, 20))).astype(np.int32)))
    sched.run()
    out = {u: list(t) for u, t in sched.generated.items()}
    sched.shutdown()
    return out


def test_decode_rows_independent_of_the_bucket(card):
    cfg = get_config("qwen2.5-14b", smoke=True)
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision="bf16"), init_seed=0)
    from repro_torch.models.common import lm_logits, rms_norm, step_rows
    head = exe.params["embed"].T if cfg.tie_embeddings else exe.params["head"]
    gamma = exe.params["ln_f"]
    x = torch.randn((4, 1, cfg.d_model), device=card,
                    generator=torch.Generator(card).manual_seed(0))
    with torch.inference_mode(), step_rows(4):
        full = lm_logits(x.to(torch.bfloat16), head)
        norm = rms_norm(x, gamma, cfg.norm_eps)
        for m in (1, 2, 3):
            part = lm_logits(x[:m].to(torch.bfloat16), head)
            assert torch.equal(part, full[:m])
            assert torch.equal(rms_norm(x[:m], gamma, cfg.norm_eps),
                               norm[:m])
    assert _serve(exe, BucketPolicy(batch_buckets=(1, 2, 4))) == \
        _serve(exe, None)
