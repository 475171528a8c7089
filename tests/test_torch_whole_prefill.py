"""The scheduler's whole-prompt prefill (neither chunks nor length
buckets) as one program per prompt length
(``serve/step.py::WholePrefillProgram``), against the reference's
scheduler, which jits its prefill and retraces it per prompt length, on
the CPU.

* several slots admitted in one step, at equal and at different prompt
  lengths, give the reference's tokens, logits and summary (the shared
  single-row cache is spliced into each slot before the next prefill),
  and ``summary()["engines"]["whole_prefill"]`` counts one program per
  distinct length;
* a program equals ``model.prefill`` on a fresh cache bit for bit, also
  right after a longer prompt left its rows in the shared cache;
* every SMOKE config's prefill issues no data-dependent op and copies no
  host value to the device (``_capture_check``).

The replay on the card is ``tests/test_torch_serve_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import extra_input_specs
from repro_torch.models import common as PC
from repro_torch.models import get_model
from repro_torch.serve.step import WholePrefillProgram

from _capture_check import fake, host_copies
from _serve_parity import Spec, engines_on_cpu, pair, run_both

ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base")
#: Prompt lengths, in submission order: the first three are admitted in
#: one step (two equal, one longer), the rest as slots free up.
LENGTHS = (5, 5, 9, 3, 9, 12)


def _specs(arch, vocab):
    rng = np.random.default_rng(3)
    extras = extra_input_specs(get_config(arch, smoke=True))
    out = []
    for uid, n in enumerate(LENGTHS):
        inputs = {name: rng.standard_normal(shape[1:]).astype(np.float32)
                  for name, (shape, _) in extras.items()} or None
        out.append(Spec(uid, rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=3 + uid % 3, inputs=inputs))
    return out


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "whisper-base"])
def test_admissions_in_one_step_match_reference(arch):
    _, _, pm, _ = pair(arch)
    _, got, rec = run_both(arch, _specs(arch, pm.cfg.vocab), slots=3,
                           max_len=32)
    assert [uid for uid, index in rec.calls[:3]] == [0, 1, 2]
    progs = got.whole_prefill_programs()
    assert [p.length for p in progs] == sorted(set(LENGTHS))
    assert [p.calls for p in progs] == [LENGTHS.count(n)
                                        for n in sorted(set(LENGTHS))]
    assert got.summary()["engines"] == engines_on_cpu(got) == {
        "decode": {"captured": False, "programs": 1},
        "whole_prefill": {"captured": False, "programs": 4}}


def test_program_equals_prefill_on_a_fresh_cache():
    """Bit for bit, and again after a longer prompt wrote more rows of
    the shared cache than the next one does."""
    _, _, model, params = pair("qwen2.5-14b")
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        cache = model.init_cache(1, 32, "cpu")
        progs = {n: WholePrefillProgram(model, params, n, cache, {}, "cpu")
                 for n in (12, 7)}
        for n in (12, 7, 7):
            toks = torch.as_tensor(rng.integers(0, model.cfg.vocab, (1, n)),
                                   dtype=torch.int32)
            logits, got = progs[n]({"tokens": toks})
            assert got is cache
            fresh = model.init_cache(1, 32, "cpu")
            want, fresh = model.prefill(params, {"tokens": toks}, fresh)
            assert logits.shape == (1, 1, model.cfg.vocab)
            assert torch.equal(logits, want[:, -1:])
            for k in fresh:
                assert torch.equal(got[k], fresh[k]), (n, k)
        with pytest.raises(ValueError, match="length 7"):
            progs[7]({"tokens": torch.zeros((1, 8), dtype=torch.int32)})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_body_is_capturable(arch):
    """On fake tensors: no data-dependent op, no host value copied to the
    device, one row of 9 tokens into a 32-row cache."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)

    def build():
        batch = {"tokens": torch.zeros((1, 9), dtype=torch.int32,
                                       device="meta")}
        for name, (shape, dt) in extra_input_specs(cfg).items():
            batch[name] = torch.empty(shape, dtype=PC.torch_dtype(dt),
                                      device="meta")
        return (fake(model.init(0, "meta")), fake(batch),
                fake(model.init_cache(1, 32, "meta")))

    assert host_copies(build, lambda p, b, c: model.prefill(p, b, c)) == []
