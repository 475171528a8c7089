"""The benchmark's own arithmetic and files, on the CPU: the generator,
the rates and tails, the counts, the names in ``BENCHMARK.json``, the
JAX guard, and that a cell and a metric are added by files alone."""

import json
import re
import shutil
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import counts, generator, guard, run, stats  # noqa: E402
from bench.systems import serve_llm  # noqa: E402

SPEC = run.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MIX = run.load_json(run.HERE / "traffic" / "chat.json")
LLM = {"run": {"vocab": 122753}}


def _open_loop(mix, seed, seconds):
    return generator.generate(mix, seed, seconds, LLM)


# -- the generator -----------------------------------------------------------
def _sizes(reqs):
    return Counter((q["head"] >= 0, len(q["prompt"]), q["max_new"])
                   for q in reqs)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_same_seed_same_schedule(seed):
    a = _open_loop(MIX, seed, 20.0)
    b = _open_loop(MIX, seed, 20.0)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x["due"] == y["due"] and x["max_new"] == y["max_new"]
        assert (x["prompt"] == y["prompt"]).all()


@pytest.mark.parametrize("by_seed", [False, True])
def test_seeds_offer_the_same_work_with_their_own_tokens(by_seed):
    mix = dict(MIX, order_by_seed=by_seed)
    a = _open_loop(mix, 1, 20.0)
    b = _open_loop(mix, 2, 20.0)
    key = lambda reqs: [(q["due"], len(q["prompt"]), q["max_new"], q["head"])
                        for q in reqs]
    assert [q["due"] for q in a] == [q["due"] for q in b]
    assert _sizes(a) == _sizes(b)
    assert (key(a) != key(b)) == by_seed
    assert not any((x["prompt"] == y["prompt"]).all() for x, y in zip(a, b)
                   if len(x["prompt"]) == len(y["prompt"]))
    assert all(q["due"] < 20.0 for q in a + b)
    mix = run.load_json(run.HERE / "traffic" / "decode.json")
    c, d = (generator.generate(mix, s, 51.0, LLM) for s in (3, 4))
    assert _sizes(c) == _sizes(d) and len(c) == mix["requests"]


def test_shared_heads_are_shared():
    reqs = _open_loop(MIX, 7, 30.0)
    heads = {}
    for q in reqs:
        if q["head"] >= 0:
            head = q["prompt"][:MIX["head_len"]].tobytes()
            assert heads.setdefault(q["head"], head) == head
    assert len(heads) == MIX["heads"]
    share = sum(q["head"] >= 0 for q in reqs) / len(reqs)
    assert 0.45 < share < 0.75
    lens = [len(q["prompt"]) for q in reqs]
    assert min(lens) >= 32 and max(lens) <= 1024 + 640


# -- rates and tails ---------------------------------------------------------
def test_rate_is_all_the_work_over_the_window():
    assert stats.rate(1200, 30.0) == 40.0
    reader = run.load_module(run.HERE / "metrics" / "tokens_per_s.py", "t")
    assert reader.read({"kind": "serve", "tokens": 900, "window_s": 30.0}) \
        == 30.0
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95


def test_tail_counts_every_request_due_unserved_ones_too():
    class R:
        mix = {"kind": "open_loop", "drain_cap_s": 60.0}
        config = {"run": {}}
    w = serve_llm._Window.__new__(serve_llm._Window)
    w.r, w.open_loop, w.refused = R, True, 1
    w.due = {0: 10.0, 1: 11.0, 2: 12.0}
    w.first = {0: 10.5, 1: 11.25}
    w.cap_at = 100.0
    w.t_start, w.t_end = 0.0, 40.0
    w.c0 = w.c1 = {"admitted": 0, "shared_tokens": 0}
    w.decode_flops, w.prompt_admitted, w.tokens, w.steps = 0, 0, 0, []
    w.failed_first = 2
    ctx = w.context({"num_layers": 1, "d_model": 1, "d_ff": 1, "n_heads": 1,
                     "n_kv_heads": 1}, "bf16")
    assert sorted(ctx["ttft_s"]) == [0.25, 0.5, 60.0, 88.0]
    assert ctx["attempted"] == 4 and ctx["failed"] == 2
    reader = run.load_module(run.HERE / "metrics" / "ttft_p95_ms.py", "t")
    assert reader.read(ctx) > 60e3


# -- counts ------------------------------------------------------------------
def test_counts_of_the_configurations():
    vgg = run.load_json(run.HERE / "configs" / "vgg19.json")
    macs = (counts.vgg_conv_flops(vgg) + counts.vgg_dense_flops(vgg)) // 2
    assert macs == 19_632_062_464                      # 19.6 G an image
    assert sum(k * n * 4 for k, n in counts.vgg_denses(vgg)) \
        == 494_534_656                                 # fc6-fc8, f32
    assert counts.vgg_params(vgg) == 143_667_240
    arch = run.load_json(run.HERE / "configs" / "minicpm-2b.json")["run"]
    assert counts.decoder_params(arch) == 2_724_880_896
    assert counts.kv_bytes_per_token(arch) == 368_640
    assert counts.prompt_flops(arch, 0, 3) == sum(
        counts.token_flops(arch, c) for c in (1, 2, 3))


def test_rooflines_reach_100_only_at_their_bound():
    vgg = run.load_json(run.HERE / "configs" / "vgg19.json")
    b1 = run.load_module(run.HERE / "metrics" / "b1_roofline.py", "b1")
    conv = run.load_module(run.HERE / "metrics" / "conv_roofline.py", "cv")
    mfu = run.load_module(run.HERE / "metrics" / "mfu.infer.py", "mfu")
    bound = counts.dense_bytes(vgg, 1) / counts.PEAK_BYTES_PER_S
    ctx = {"trace": {"kernel_s": {"void fm_gemv_kernel<float>": 2 * bound}},
           "slice_latency_s": [1.0, 1.0], "config": vgg, "batch": 1,
           "dense_kernels": ["cuda.fused_matmul"] * 3,
           "peak_flops": counts.PEAK_FLOPS["f32"]}
    assert b1.read(ctx) == pytest.approx(100.0)
    ctx["dense_kernels"][2] = "aten.linear"
    assert b1.read(ctx) is None
    t = counts.vgg_conv_flops(vgg) * 64 / counts.PEAK_FLOPS["f32"]
    ctx.update(batch=64, trace={"kernel_s": {"sm90_xmma_fprop_f32": 4 * t}})
    assert conv.read(ctx) == pytest.approx(50.0)
    per_image = counts.vgg_conv_flops(vgg) + counts.vgg_dense_flops(vgg)
    ctx.update(kind="infer", images=67, window_s=per_image * 67 / 67e12)
    assert mfu.read(ctx) == pytest.approx(100.0)


# -- the files ---------------------------------------------------------------
def test_benchmark_json_keeps_to_its_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert run.load_json(ROOT / c["file"])["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (run.HERE / "cells" / f"{w['name']}.json").is_file()
    layers = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert run.reader_path(m["name"]).is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        layers.add(m["layer"])
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        got = [m["name"] for m in SPEC["end_to_end"]
               if c in m.get("workloads", [c])]
        assert "setup_s" in got and len(got) >= 2
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.serve", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["jax._src.api", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "reprox"], ["flax"]),
])
def test_guard_compares_whole_top_level_names(names, bad):
    assert guard.forbidden_modules(names) == bad


def test_a_cell_a_kind_and_a_metric_are_added_by_files_alone(tmp_path):
    """A throwaway cell (its traffic, of a throwaway arrival process, and
    its limits) and a throwaway metric, added as new files and entries,
    run with no existing file edited."""
    here = tmp_path / "bench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "kinds" / "same_frame.py").write_text(
        "import torch\n\n\n"
        "def generate(mix, seed, seconds, config):\n"
        "    x = torch.ones((mix['batch'],) + tuple(config['input']))\n"
        "    return [x * (seed % 7)] * mix['ring']\n")
    (here / "traffic" / "tiny.json").write_text(json.dumps(
        {"kind": "same_frame", "callers": 1, "batch": 2, "ring": 2}))
    (here / "cells" / "vgg19.tiny.json").write_text(json.dumps(
        {"limits": {"max_log_error": 1e-3, "compared_images": 2}}))
    (here / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx['calls'] / ctx['window_s']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "vgg19.tiny", "config": "vgg19",
                              "traffic": "tiny", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["vgg19.tiny"]})
    cfg = dict(run.load_json(here / "configs" / "vgg19.json"),
               input=[16, 16, 3], blocks=[[4, 1], [8, 1]], dense=[16, 10])
    res = run.run_cell(spec, "vgg19.tiny", 5, 0.2, False, 0.0,
                       device="cpu", here=here, overrides={"config": cfg})
    assert res["correct"] and res["metrics"]["calls_per_s"]["value"] > 0
    assert generator.kind({"kind": "same_frame"}, here).generate(
        {"batch": 2, "ring": 2}, 5, 1.0, cfg)[0].sum() == 5 * 2 * 16 * 16 * 3
    assert set(res["metrics"]) == {"setup_s", "calls_per_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
