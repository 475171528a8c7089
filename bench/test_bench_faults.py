"""The correctness check comes out false when the timed path is broken:
the harness runs at a small size on the CPU (its look for a card
skipped), with a fault planted underneath, and with the control judged
in the program's place."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.api.targets import JitExecutable  # noqa: E402
from repro_torch.serve.prefix import PrefixCache  # noqa: E402
from repro_torch.serve.scheduler import TemperatureSampler  # noqa: E402

from bench import run  # noqa: E402

SPEC = run.load_json(ROOT / "BENCHMARK.json")


def _decoder(layers=2, d=64, vocab=256):
    cfg = run.load_json(run.HERE / "configs" / "minicpm-2b.json")
    cfg["run"] = {"name": "decoder-small", "family": "dense",
                  "num_layers": layers, "d_model": d, "n_heads": 4,
                  "n_kv_heads": 4, "d_ff": 2 * d, "vocab": vocab,
                  "head_dim": d // 4, "rope_theta": 1e4, "mlp_act": "silu",
                  "tie_embeddings": True, "scale_embed": True,
                  "q_chunk": 16, "kv_chunk": 32}
    return cfg


def _chat():
    mix = run.load_json(run.HERE / "traffic" / "chat.json")
    mix.update(rate=40.0, heads=2, head_len=32, drain_cap_s=5.0,
               shared_tail={"dist": "lognormal", "median": 8, "sigma": 0.6,
                            "min": 4, "max": 24},
               unshared={"dist": "lognormal", "median": 16, "sigma": 0.6,
                         "min": 8, "max": 48},
               output={"dist": "lognormal", "median": 8, "sigma": 0.6,
                       "min": 4, "max": 12},
               serve={"slots": 4, "max_len": 128, "prefill_chunk": 16,
                      "prefix_cache": 4, "min_prefix": 16, "admission": "fcfs",
                      "buckets": {"default": [4, 128]}},
               check={"sample_tokens": 120, "sample_requests": 16})
    return mix


def _vgg():
    return dict(run.load_json(run.HERE / "configs" / "vgg19.json"),
                input=[16, 16, 3], blocks=[[4, 1], [8, 1], [8, 1]],
                dense=[32, 32, 10])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the small runs are steps of a few
    milliseconds, which threads fighting over a busy machine's cores
    would stretch past the window."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, config, mix, limits, control=False):
    seconds = 1.0 if cell.startswith("minicpm") else 0.4
    return run.run_cell(SPEC, cell, 2**31 + 17, seconds, False, 0.0,
                        device="cpu", control=control,
                        overrides={"config": config, "mix": mix,
                                   "limits": limits})


SERVE_LIMITS = {"max_gap": 0.05, "compared_tokens": 20,
                "restored_compared": 1}
VGG_LIMITS = {"max_log_error": 1e-3, "compared_images": 2}


def test_sound_runs_are_correct():
    res = _run("minicpm-2b.chat", _decoder(), _chat(), SERVE_LIMITS)
    assert res["correct"], res["check"]
    assert res["check"]["restored_compared"]["limit"] == 1
    mix = run.load_json(run.HERE / "traffic" / "b64.json")
    res = _run("vgg19.b64", _vgg(), dict(mix, batch=4), VGG_LIMITS)
    assert res["correct"], res["check"]


def test_a_token_altered_where_it_is_sampled(monkeypatch):
    sound = TemperatureSampler.__call__

    def altered(self, logits, temperature, *, uid, index):
        if index % 3 == 0:   # every third token, the first one among them
            return int(torch.argmin(logits, dim=-1)[0])
        return sound(self, logits, temperature, uid=uid, index=index)

    monkeypatch.setattr(TemperatureSampler, "__call__", altered)
    res = _run("minicpm-2b.chat", _decoder(), _chat(), SERVE_LIMITS)
    assert not res["correct"]
    assert res["check"]["max_gap"]["value"] > SERVE_LIMITS["max_gap"]


def test_a_head_altered_where_it_is_restored(monkeypatch):
    """A prefix-cache hit hands back a snapshot whose keys and values are
    off by a little: only the requests restored from it read wrong, and
    the sample holds one of them."""
    sound = PrefixCache.take

    def altered(self, prompt):
        hit = sound(self, prompt)
        if hit is None:
            return None
        head, cache = hit
        return head, torch.utils._pytree.tree_map(
            lambda t: t * 1.5 if t.is_floating_point() else t, cache)

    monkeypatch.setattr(PrefixCache, "take", altered)
    res = _run("minicpm-2b.chat", _decoder(), _chat(), SERVE_LIMITS)
    assert not res["correct"]
    assert res["check"]["restored_compared"]["value"] >= 1
    assert res["check"]["max_gap"]["value"] > SERVE_LIMITS["max_gap"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_an_answer_altered_or_half_the_batch_left_out(monkeypatch, fault):
    sound = JitExecutable.__call__

    def broken(self, *pos, **inputs):
        (name, y), = sound(self, *pos, **inputs).items()
        y = y.clone()
        if fault == "answer_altered":
            y[0] = y[0].roll(1)
        else:
            half = y.shape[0] // 2
            y[half:] = y[:y.shape[0] - half]
        return {name: y}

    monkeypatch.setattr(JitExecutable, "__call__", broken)
    mix = run.load_json(run.HERE / "traffic" / "b64.json")
    res = _run("vgg19.b64", _vgg(), dict(mix, batch=4), VGG_LIMITS)
    assert not res["correct"]
    assert res["check"]["max_log_error"]["value"] > VGG_LIMITS["max_log_error"]


def test_the_float8_control_fails_where_the_served_model_passes():
    """The chat cell's own limits, the configuration's weights at 12
    layers of width 64: the run judges the bfloat16 program's served
    tokens correct, and the float8 control, judged in its place on the
    same prompts and tokens, not."""
    limits = run.load_json(run.HERE / "cells" / "minicpm-2b.chat.json")[
        "limits"]
    limits = dict(limits, compared_tokens=SERVE_LIMITS["compared_tokens"])
    res = _run("minicpm-2b.chat", _decoder(layers=12, d=64, vocab=1024),
               _chat(), limits, control=True)
    prog, ctrl = res["program_check"], res["check"]
    assert all(run.holds(c) for c in prog.values()), prog
    assert not res["correct"]
    assert ctrl["max_gap"]["value"] >= 3 * prog["max_gap"]["value"]


@pytest.mark.cuda
def test_the_tf32_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    cfg = dict(_vgg(), input=[32, 32, 3], blocks=[[16, 2], [32, 2]],
               dense=[256, 1000])
    mix = dict(run.load_json(run.HERE / "traffic" / "b64.json"), batch=8)
    res = run.run_cell(SPEC, "vgg19.b64", 5, 1.0, False, 0.0,
                       device="cuda", control=True,
                       overrides={"config": cfg, "mix": mix,
                                  "limits": VGG_LIMITS})
    assert all(run.holds(c) for c in res["program_check"].values())
    assert not res["correct"]
    assert res["check"]["max_log_error"]["value"] > \
        VGG_LIMITS["max_log_error"]
