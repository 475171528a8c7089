"""The ``engine`` target's forward as one program per input signature
(``api/engine_adapter.py::ForwardProgram``), against the reference's
jitted forward, on the CPU.

* the executable's logits equal the reference's ``jax.jit`` of
  ``model.forward`` at f32 (the model tests' 1e-4) for each signature;
  another shape or dtype gets a program of its own, and
  ``compile_time`` grows once per signature, where the reference's
  does;
* replaced ``exe.params`` drop the programs and are honoured;
* ``GraphPool.place`` orders any program kind by its caller's key:
  keys arriving in ascending order lay the pool out again largest
  first, an equal or smaller key joins;
* every SMOKE config's forward issues no data-dependent op and copies
  no host value to the device (``_capture_check``), so a capture takes
  it.

The replay on the card is ``tests/test_torch_models_cuda.py``'s.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

import repro
import repro_torch
from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.configs.base import extra_input_specs
from repro_torch.core import program
from repro_torch.models import common as PC
from repro_torch.models import get_model
from repro_torch.weights import params_from_reference

from _capture_check import fake, host_copies

ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base")
F32_TOL = 1e-4


def _f32(arch):
    return (dataclasses.replace(ref_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def qwen():
    rcfg, pcfg = _f32("qwen2.5-14b")
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    ref = repro.compile(rcfg, repro.CompileOptions(target="engine"),
                        params=rp)
    exe = repro_torch.compile(
        pcfg, target="engine", device="cpu",
        params=params_from_reference(jax.tree.map(np.asarray, rp)))
    return ref, exe


def test_forward_per_signature_matches_reference(qwen):
    """Each new shape builds one program and adds to ``compile_time``
    where the reference's grows; a seen one adds nothing and reuses its
    program.  Another dtype (int64 tokens) is a signature of its own
    too; the reference, under JAX's 32-bit default, sees int32 there."""
    ref, exe = qwen
    vocab = exe.cfg.vocab
    calls = [_tokens(vocab, 2, 12, 0), _tokens(vocab, 2, 5, 1),
             _tokens(vocab, 2, 12, 2), _tokens(vocab, 1, 12, 3),
             _tokens(vocab, 2, 12, 4).astype(np.int64)]
    grew, ref_grew, programs = [], [], []
    for toks in calls:
        before, ref_before = exe.compile_time, ref.compile_time
        got = exe(tokens=toks)["logits"]
        want = np.asarray(ref(tokens=toks)["logits"], np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
        grew.append(exe.compile_time != before)
        ref_grew.append(ref.compile_time != ref_before)
        programs.append(exe.programs["programs"])
    assert grew[:4] == ref_grew[:4] == [True, True, False, True]
    assert grew[4] and not ref_grew[4]
    assert programs == [1, 2, 2, 3, 4]
    assert exe.programs == {"programs": 4, "captured": False,
                            "pool_bytes": 0}
    assert sorted(sig[0][2] for sig in exe._programs) == \
        ["torch.int32"] * 3 + ["torch.int64"]


def test_replaced_params_are_honoured(qwen):
    """The programs read ``exe.params`` where they lie: replacing them
    drops every program, and the next call computes with the new
    params (the reference passes them to its jitted forward)."""
    ref, exe = qwen
    toks = _tokens(exe.cfg.vocab, 2, 12, 5)
    old = exe(tokens=toks)["logits"]
    params, seen = exe.params, exe.compile_time
    rp = ref_model(ref.cfg).init(jax.random.PRNGKey(1))
    exe.params = params_from_reference(jax.tree.map(np.asarray, rp))
    try:
        assert exe.programs["programs"] == 0
        got = exe(tokens=toks)["logits"]
        assert exe.programs["programs"] == 1
        assert exe.compile_time == seen            # a seen signature
        want = get_model(exe.cfg).forward(exe.params, {"tokens": toks})[0]
        assert torch.equal(got, want)
        assert not torch.equal(got, old)
    finally:
        exe.params = params


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_extra_inputs_key_their_own_program(arch):
    """A family with extra inputs: the signature holds them, and the
    logits equal the reference's."""
    rcfg, pcfg = _f32(arch)
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    ref = repro.compile(rcfg, repro.CompileOptions(target="engine"),
                        params=rp)
    exe = repro_torch.compile(
        pcfg, target="engine", device="cpu",
        params=params_from_reference(jax.tree.map(np.asarray, rp)))
    rng = np.random.default_rng(7)
    for s in (10, 13):
        batch = {"tokens": _tokens(pcfg.vocab, 1, s, s)}
        for name, (shape, dt) in extra_input_specs(pcfg).items():
            batch[name] = rng.standard_normal(shape).astype(dt)
        got = exe(**batch)["logits"]
        want = np.asarray(ref(**batch)["logits"], np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    assert exe.programs["programs"] == 2


def test_place_orders_programs_by_the_callers_key(monkeypatch):
    """``GraphPool.place`` with the capture stubbed: a key above every
    held one releases them, takes a fresh pool id, and captures them
    again after itself, largest first; an equal or smaller key joins.
    Forwards of growing input sizes and whole-prompt prefills of growing
    lengths share this rule with the CNN programs' batches."""
    handles, captured = iter(range(100)), []

    class Prog:
        def __init__(self, order):
            self.order, self.graph = order, None
            self.recapture()

        def recapture(self):
            captured.append(self.order)
            self.graph = object()

        def release(self):
            self.graph = None

    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    pool = program.GraphPool(torch.device("cuda"))
    held = []
    for key in (24, 48, 48, 96, 12, 400):
        held.append(pool.place(lambda: Prog(key), key, held))
    assert captured == [24, 48, 24, 48, 96, 48, 48, 24, 12,
                        400, 96, 48, 48, 24, 12]
    assert pool.handle == 3
    assert all(p.graph is not None for p in held)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_body_is_capturable(arch):
    """On fake tensors: no data-dependent op, no host value copied to the
    device, at a prompt length and a batch of two."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)

    def build():
        batch = {"tokens": torch.zeros((2, 9), dtype=torch.int32,
                                       device="meta")}
        for name, (shape, dt) in extra_input_specs(cfg, 2).items():
            batch[name] = torch.empty(shape, dtype=PC.torch_dtype(dt),
                                      device="meta")
        return fake(model.init(0, "meta")), fake(batch)

    assert host_copies(build, lambda p, b: model.forward(p, b)) == []
