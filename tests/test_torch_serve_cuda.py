"""The serve scheduler's captured decode steps on the card (needs an
NVIDIA GPU).

The ``cuda``-marked twins of ``chip_smoke.py``'s serve phase at SMOKE
size (qwen2.5-14b's and recurrentgemma's SMOKE configs at f32, weights
made on the CPU from a seed): a bucket's captured step against
``decode_step`` run eagerly on a clone of the cache, sliced the same
way, bit-equal on the full-slots bucket and on a smaller one; a bucket
captured mid-serve leaves every live row and ``pos`` as they were; the
cache's addresses and ``memory_allocated`` stay put across steady-state
steps; and a scheduler whose smaller buckets are captured in the
background while it serves gives the tokens of one whose buckets were
all captured first, of one at a fixed shape, and of the CPU.  The
prefill programs: the chunk program's replay against ``prefill_chunk``
run eagerly on a clone of the request's cache, bit-equal at two starts;
three interleaved prompts with a shared head served through it give the
CPU's tokens; a length bucket's ``PrefillProgram`` replay equals its
eager call on the same inputs.  This file imports no JAX, so it runs on
a machine without it::

    python -m pytest -m cuda tests/test_torch_serve_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.runtime import Bucket, BucketPolicy
from repro_torch.serve import Request, SchedulerOptions

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 is on; the f32 comparison needs it off")
    return "cuda"


def _exe(arch, device):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = get_model(cfg).init(0, "cpu")
    return repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=device), params=params)


def _sched(arch, device, worker="manual"):
    return repro_torch.serve(
        _exe(arch, device), SchedulerOptions(
            slots=4, max_len=64, fold=False,
            buckets=BucketPolicy(batch_buckets=(1, 2, 4))),
        engine_worker=worker)


def _requests(n, seed=0, new=12):
    rng = np.random.default_rng(seed)
    return [Request(uid=u, prompt=rng.integers(0, 256, int(rng.integers(
        4, 20))).astype(np.int32), max_new_tokens=new) for u in range(n)]


def _snapshot(cache):
    with torch.inference_mode():
        return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "recurrentgemma-9b"])
@pytest.mark.parametrize("batch", [4, 2])
def test_captured_step_bit_equal_to_eager(card, arch, batch):
    sched = _sched(arch, card)
    sched.wait_warm()
    for r in _requests(4):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    step = sched._decode_engine.peek(Bucket(batch))
    sm = sched.slot_manager
    assert step.graph is not None
    with torch.inference_mode():
        clone = _snapshot(sm.cache)
        sched._tokens.copy_(torch.arange(4, dtype=torch.int32)[:, None] + 5)
        want = step.model.decode_step(step.params, sm.rows(batch, clone),
                                      sched._tokens[:batch])[0].clone()
        got = step().clone()
    assert torch.equal(got, want)
    for k, leaf in sm.cache.items():
        assert leaf.stride() == clone[k].stride()
        assert torch.equal(leaf, clone[k]), k
    sched.shutdown()


def test_bucket_captured_mid_serve_leaves_live_rows(card):
    sched = _sched("qwen2.5-14b", card)
    for r in _requests(4):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    assert sched._decode_engine.warm_buckets() == (Bucket(4),)
    before = _snapshot(sched.slot_manager.cache)
    assert sched._decode_engine.drain() == 2     # buckets 1 and 2, now
    torch.cuda.current_stream().synchronize()
    for k, leaf in sched.slot_manager.cache.items():
        assert torch.equal(leaf, before[k]), k
    assert int(sched.slot_manager.cache["pos"].max()) > 0
    sched.run()
    sched.shutdown()


def test_steady_state_keeps_buffers_and_memory(card):
    sched = _sched("qwen2.5-14b", card, worker="sync")
    for r in _requests(4, new=30):
        sched.submit(r)
    sched.step()
    sched.step()
    ptrs = sched.slot_manager.buffer_pointers()
    torch.cuda.current_stream().synchronize()
    allocated = torch.cuda.memory_allocated()
    for _ in range(6):
        sched.step()
        assert sched.slot_manager.buffer_pointers() == ptrs
    torch.cuda.current_stream().synchronize()
    assert torch.cuda.memory_allocated() == allocated
    assert sched.summary()["runtime"]["decode"]["compile_stalls"] == 0
    sched.shutdown()


def test_background_capture_while_serving(card):
    """Buckets 1 and 2 are captured on the worker thread while the main
    thread serves (decoding at the warm full-slots bucket meanwhile):
    the same tokens as a scheduler whose buckets were all captured
    first, as one at a fixed shape (one full-slots step), and as the
    CPU's."""
    tokens = {}
    for name, device, worker in (("background", card, "thread"),
                                 ("warm", card, "manual"),
                                 ("cpu", "cpu", "manual")):
        sched = _sched("qwen2.5-14b", device, worker=worker)
        if worker == "manual":
            sched.wait_warm()
        for r in _requests(6, seed=1):
            sched.submit(r)
        sched.run()
        assert sched.wait_warm(120.0)
        tokens[name] = dict(sched.generated)
        decode = sched.summary()["runtime"]["decode"]
        assert decode["compile_stalls"] == 0
        assert decode["warm_buckets"] == ["b1", "b2", "b4"]
        sched.shutdown()
    fixed = repro_torch.serve(_exe("qwen2.5-14b", card), SchedulerOptions(
        slots=4, max_len=64, fold=False))
    for r in _requests(6, seed=1):
        fixed.submit(r)
    fixed.run()
    assert fixed._decode.graph is not None
    assert tokens["background"] == tokens["warm"] == tokens["cpu"] == \
        fixed.generated


def _chunked(device, arch="qwen2.5-14b"):
    return repro_torch.serve(_exe(arch, device), SchedulerOptions(
        slots=3, max_len=64, fold=False, prefill_chunk=8, prefix_cache=2))


def test_chunk_program_replay_bit_equal_to_eager(card):
    sched = _chunked(card)
    prog = sched._chunk_engine.peek(Bucket(1, 8))
    assert prog.captured and sched.summary()["engines"]["chunk"] == {
        "captured": True, "programs": 1}
    model, params = prog.model, prog.params
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        cache = model.init_cache(1, 64, card)
        for start, n in ((0, 8), (8, 5)):
            tokens = np.zeros((1, 8), np.int32)
            tokens[0, :n] = rng.integers(0, 256, n)
            clone = _snapshot(cache)
            want = model.prefill_chunk(params, torch.as_tensor(
                tokens, device=card), clone, start, n)[0].clone()
            got, back = prog(tokens, cache, start, n)
            assert back is cache and torch.equal(got, want), start
            for k in cache:
                assert torch.equal(cache[k], clone[k]), (start, k)
    assert prog.calls == 2
    sched.shutdown()


def test_interleaved_prompts_with_a_shared_head_give_the_cpu_tokens(card):
    rng = np.random.default_rng(5)
    head = rng.integers(0, 256, 16).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 256, n).astype(
        np.int32)]) for n in (5, 11, 20)]
    tokens = {}
    for device in ("cpu", card):
        sched = _chunked(device)
        for uid, p in enumerate(prompts):
            sched.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
        sched.run()
        summ = sched.summary()
        tokens[device] = dict(sched.generated)
        assert summ["prefix_cache"]["hits"] == 2
        assert summ["engines"]["chunk"]["captured"] == (device == card)
        sched.shutdown()
    assert tokens[card] == tokens["cpu"]


def test_prefill_program_replay_equals_its_eager_call(card):
    sched = repro_torch.serve(_exe("whisper-base", card), SchedulerOptions(
        slots=2, max_len=64, fold=False,
        buckets=BucketPolicy(batch_buckets=(1, 2), len_buckets=(16, 64))),
        engine_worker="manual")
    sched.wait_warm()
    eng = sched._prefill_engine
    assert sched.summary()["engines"]["prefill"] == {"captured": True,
                                                     "programs": 2}
    prog = eng.peek(Bucket(1, 16))
    cfg = prog.model.cfg
    rng = np.random.default_rng(6)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :9] = rng.integers(0, cfg.vocab, 9)
    batch = {"tokens": torch.as_tensor(tokens), "frames": torch.as_tensor(
        rng.standard_normal((1, cfg.n_frames, cfg.d_model)).astype(
            np.float32))}
    with torch.inference_mode():
        got, cache = prog(batch, 9)
        got_cache = _snapshot(cache)
        want = prog.eager().clone()
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(got_cache[k], cache[k]), k
    assert int(cache["pos"][0]) == 9
    sched.shutdown()


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "whisper-base"])
def test_whole_prefill_replays_and_gives_the_cpu_tokens(card, arch):
    """Neither chunks nor length buckets: one captured whole-prompt
    program a prompt length, several slots admitted in one step, the
    CPU's tokens; a replay bit-equal to ``model.prefill`` on a fresh
    cache."""
    lengths = (7, 7, 12, 5, 12)
    tokens = {}
    for device in ("cpu", card):
        sched = repro_torch.serve(_exe(arch, device), SchedulerOptions(
            slots=3, max_len=64, fold=False), engine_worker="manual")
        rng = np.random.default_rng(8)
        for uid, n in enumerate(lengths):
            sched.submit(Request(uid=uid, prompt=rng.integers(
                0, 256, n).astype(np.int32), max_new_tokens=6))
        sched.run()
        tokens[device] = dict(sched.generated)
        assert sched.summary()["engines"]["whole_prefill"] == {
            "captured": device == card, "programs": 3}
        sched.shutdown()
    assert tokens[card] == tokens["cpu"]
    prog = sched.whole_prefill_programs()[1]
    model, cfg = prog.model, prog.model.cfg
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (1, prog.length)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.n_frames, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        got, cache = prog(batch)
        got_cache = _snapshot(cache)
        fresh = model.init_cache(1, 64, card)
        want, fresh = model.prefill(prog.params, {
            k: v.to(card) for k, v in batch.items()}, fresh)
    assert torch.equal(got, want[:, -1:])
    for k in fresh:
        assert torch.equal(got_cache[k], fresh[k]), k
