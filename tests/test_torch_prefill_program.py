"""The scheduler's prefill programs on the CPU, against the JAX package.

``transformer.prefill_chunk`` takes ``start`` and ``length`` as 0-d
tensors on the device, as the reference's compiled chunk program takes
them traced, so one captured program serves every chunk; the serve
scheduler runs it as ``serve/step.py::ChunkProgram`` and its padded
prefill as one ``PrefillProgram`` per length bucket.  On the CPU those
programs run the same functions eagerly, so these cases hold them to the
host-int calls and to the reference:

* ``prefill_chunk`` with tensor ``start``/``length`` equals the host-int
  call bit for bit (logits, every cache row, ``pos``), and over a whole
  prompt equals ``prefill``; it holds to the reference's jitted
  ``prefill_chunk`` (traced ``start``/``length``) within the model
  tests' f32 tolerance;
* ``causal_skip`` with the visible-chunk count equals the unskipped pass
  bit for bit (``chunked_attention`` alone and a whole prompt);
* ``ChunkProgram``, staging a request's cache through its own, leaves
  the cache and gives the logits of the eager chunk on a clone, with
  another request's rows left in its staging cache; a chunk past the
  cache's end raises;
* ``PrefillProgram`` with a device ``length`` equals the scheduler's
  former host-int padded prefill (``prefill_fixup`` with ``pos`` filled
  and the last token sliced on the host), over a dirty shared cache;
* schedulers with chunked prefill and a prefix cache, or with length
  buckets, give the reference scheduler's tokens, logits and summary,
  every program eager on the CPU, no prefix snapshot sharing storage
  with a program's static cache.

SMOKE configs at ``dtype="float32"``; inputs from
``np.random.default_rng(seed)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _serve_parity import Spec, engines_on_cpu, pair, prompts, run_both
from repro_torch.configs.base import extra_input_specs
from repro_torch.models import common as C
from repro_torch.models import get_model
from repro_torch.serve.step import ChunkProgram, PrefillProgram

#: The families with incremental prefill, each with the largest
#: ``max_len`` whose cache is full-context (mixtral's SMOKE window is 16).
CHUNKED = {"qwen2.5-14b": 32, "deepseek-7b": 32, "gemma3-27b": 32,
           "minicpm-2b": 32, "mixtral-8x22b": 16}
CHUNK = 8
F32_TOL = 1e-4          # tests/test_torch_models.py's


def _scalar(v):
    return torch.tensor(v, dtype=torch.int32)


def _chunks(prompt, c=CHUNK):
    """(start, length, (1, c) padded tokens) of each chunk of a prompt."""
    for start in range(0, len(prompt), c):
        n = min(c, len(prompt) - start)
        t = np.zeros((1, c), np.int32)
        t[0, :n] = prompt[start:start + n]
        yield start, n, t


def _prompt(max_len, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, max_len - 3).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(CHUNKED))
def test_device_scalars_equal_host_ints(arch):
    _, _, pm, pp = pair(arch)
    max_len = CHUNKED[arch]
    host, dev = (pm.init_cache(1, max_len, "cpu") for _ in range(2))
    for start, n, t in _chunks(_prompt(max_len, 1)):
        want, _ = pm.prefill_chunk(pp, torch.as_tensor(t), host, start, n)
        got, _ = pm.prefill_chunk(pp, torch.as_tensor(t), dev,
                                  _scalar(start), _scalar(n))
        assert torch.equal(got, want), (start, n)
        for k in host:
            assert torch.equal(dev[k], host[k]), (start, k)
    assert int(dev["pos"][0]) == max_len - 3


@pytest.mark.parametrize("arch", sorted(CHUNKED))
def test_device_scalars_over_a_prompt_equal_prefill(arch):
    _, _, pm, pp = pair(arch)
    max_len = CHUNKED[arch]
    prompt = _prompt(max_len, 2)
    s = len(prompt)
    want_l, want_c = pm.prefill(pp, {"tokens": torch.as_tensor(prompt[None])},
                                pm.init_cache(1, max_len, "cpu"))
    cache = pm.init_cache(1, max_len, "cpu")
    for start, n, t in _chunks(prompt):
        got_l, cache = pm.prefill_chunk(pp, torch.as_tensor(t), cache,
                                        _scalar(start), _scalar(n))
    assert torch.equal(got_l, want_l)
    for k in ("c1", "c2"):
        assert torch.equal(cache[k][:, :, :s], want_c[k][:, :, :s]), k
    assert torch.equal(cache["pos"], want_c["pos"])


@pytest.mark.parametrize("arch", sorted(CHUNKED))
def test_device_scalars_hold_to_the_reference(arch):
    rm, rp, pm, pp = pair(arch)
    max_len = CHUNKED[arch]
    ref_chunk = jax.jit(rm.prefill_chunk)
    rc = rm.init_cache(1, max_len)
    cache = pm.init_cache(1, max_len, "cpu")
    for start, n, t in _chunks(_prompt(max_len, 3)):
        rl, rc = ref_chunk(rp, jnp.asarray(t), rc, jnp.int32(start),
                           jnp.int32(n))
        got, cache = pm.prefill_chunk(pp, torch.as_tensor(t), cache,
                                      _scalar(start), _scalar(n))
        want = np.asarray(rl)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL * max(1.0, np.abs(want).max()))
    for k in ("c1", "c2"):
        want = np.asarray(rc[k])
        np.testing.assert_allclose(cache[k].numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rc["pos"]))


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("offset", [0, 8, 24, 56])
def test_causal_skip_with_visible_count_is_bit_equal(offset, window):
    rng = np.random.default_rng(offset + window)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 8, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    kw = dict(window=window, kv_chunk=16, q_chunk=4)
    want = C.chunked_attention(q, k, v, q_offset=_scalar(offset), **kw)
    visible = (offset + 8 - 1) // 16 + 1
    got = C.chunked_attention(q, k, v, q_offset=_scalar(offset),
                              causal_skip=True, visible_chunks=visible, **kw)
    assert torch.equal(got, want)
    host = C.chunked_attention(q, k, v, q_offset=offset, causal_skip=True,
                               **kw)
    assert torch.equal(host, want)
    with pytest.raises(ValueError, match="visible_chunks"):
        C.chunked_attention(q, k, v, q_offset=_scalar(offset),
                            causal_skip=True, **kw)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-27b"])
def test_causal_skip_prefill_chunk_is_bit_equal(arch):
    """A 64-row cache in kv chunks of 16: each chunk sees 1..4 of them."""
    _, _, pm, pp = pair(arch)
    over = dict(kv_chunk=16, q_chunk=8)
    plain = get_model(dataclasses.replace(pm.cfg, **over))
    skip = get_model(dataclasses.replace(pm.cfg, causal_skip=True, **over))
    max_len = 64
    caches = [m.init_cache(1, max_len, "cpu") for m in (plain, skip)]
    counts = []
    for start, n, t in _chunks(_prompt(max_len, 4)):
        want, _ = plain.prefill_chunk(pp, torch.as_tensor(t), caches[0],
                                      _scalar(start), _scalar(n))
        visible = skip.visible_chunks(caches[1], CHUNK, start)
        counts.append(visible)
        got, _ = skip.prefill_chunk(pp, torch.as_tensor(t), caches[1],
                                    _scalar(start), _scalar(n), visible)
        assert torch.equal(got, want), start
    for k in caches[0]:
        assert torch.equal(caches[1][k], caches[0][k]), k
    assert counts == [1, 1, 2, 2, 3, 3, 4, 4]
    assert plain.visible_chunks(caches[0], CHUNK, 8) is None


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x22b"])
def test_chunk_program_stages_the_request_cache(arch):
    """The program's call against ``prefill_chunk`` on a clone of the
    request's cache, at two starts, after another request's chunks have
    filled the program's staging cache."""
    _, _, pm, pp = pair(arch)
    max_len = CHUNKED[arch]
    prog = ChunkProgram(pm, pp, CHUNK, max_len, "cpu")
    assert not prog.captured and prog.counts() == [None]
    other = pm.init_cache(1, max_len, "cpu")
    for start, n, t in _chunks(_prompt(max_len, 5)):
        prog(t, other, start, n)
    mine = pm.init_cache(1, max_len, "cpu")
    for i, (start, n, t) in enumerate(_chunks(_prompt(max_len, 6)[:13])):
        clone = {k: v.clone() for k, v in mine.items()}
        want, _ = pm.prefill_chunk(pp, torch.as_tensor(t), clone, start, n)
        got, back = prog(t, mine, start, n)
        assert back is mine and torch.equal(got, want), start
        for k in mine:
            assert torch.equal(mine[k], clone[k]), (start, k)
    assert i == 1 and prog.calls == 2 + -(-(max_len - 3) // CHUNK)
    with pytest.raises(ValueError, match="does not fit"):
        prog(t, mine, max_len - CHUNK + 1, 1)


def _pr28_fixup(model, p, batch, cache, length: int):
    """The scheduler's padded prefill before its programs: ``pos`` filled
    and the last real token sliced with host ints."""
    _, cache = model.prefill(p, batch, cache)
    cache["pos"].fill_(length - 1)
    last = batch["tokens"][:, length - 1:length]
    return model.decode_step(p, cache, last)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "whisper-base",
                                  "internvl2-2b"])
def test_prefill_program_equals_the_host_fixup(arch):
    _, _, pm, pp = pair(arch)
    cfg, max_len, bucket = pm.cfg, 32, 16
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        shared = pm.init_cache(1, max_len, "cpu")
        for leaf in shared.values():     # a dirty cache: another request's
            leaf.copy_(torch.as_tensor(rng.integers(
                -3, 4, leaf.shape).astype(np.float32)).to(leaf.dtype))
        extras = {name: torch.zeros(shape, dtype=C.torch_dtype(dt))
                  for name, (shape, dt) in
                  extra_input_specs(cfg).items()}
        prog = PrefillProgram(pm, pp, bucket, shared, extras, "cpu")
        assert not prog.captured
        for length in (cfg.num_image_tokens + 3 if cfg.num_image_tokens
                       else 5, bucket):
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :length] = rng.integers(0, cfg.vocab, length)
            batch = {"tokens": torch.as_tensor(tokens)}
            for name, t in extras.items():
                batch[name] = torch.as_tensor(rng.standard_normal(
                    t.shape).astype(np.float32))
            want_l, want_c = _pr28_fixup(pm, pp, dict(batch),
                                         pm.init_cache(1, max_len, "cpu"),
                                         length)
            got_l, got_c = prog(batch, length)
            assert got_c is shared and torch.equal(got_l, want_l), length
            for k in want_c:
                assert torch.equal(got_c[k], want_c[k]), (length, k)
        with pytest.raises(ValueError, match="length bucket"):
            prog(batch, bucket + 1)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-27b"])
def test_chunked_scheduler_with_prefix_cache_like_the_reference(arch):
    """Three slots interleave the chunks of prompts that share a 16-token
    head; the head's snapshot and every take are copies."""
    head = (np.arange(16, dtype=np.int32) * 7 + 1) % 256
    specs = [Spec(u, p, 4) for u, p in
             enumerate(prompts(6, 3, 12, seed=8, head=head))]
    _, got, _ = run_both(arch, specs, slots=3, max_len=48,
                         prefill_chunk=CHUNK, prefix_cache=2)
    prog = got._chunk_engine.peek(got._chunk_engine.warm_buckets()[0])
    assert isinstance(prog, ChunkProgram)
    assert got.summary()["engines"] == engines_on_cpu(got) == {
        "decode": {"captured": False, "programs": 1},
        "chunk": {"captured": False, "programs": 1}}
    assert got.summary()["prefix_cache"]["hits"] == 2
    static = {t.untyped_storage().data_ptr() for t in prog.cache.values()}
    for _, (_, snap) in got._prefix_cache._entries.items():
        for t in snap.values():
            assert t.untyped_storage().data_ptr() not in static
    assert prog.calls == got.metrics.prefill_chunks


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "whisper-base",
                                  "internvl2-2b"])
def test_length_bucket_scheduler_like_the_reference(arch):
    cfg = pair(arch)[2].cfg
    lo = cfg.num_image_tokens + 1 if cfg.num_image_tokens else 3
    specs = [Spec(u, p, 4) for u, p in
             enumerate(prompts(5, lo, 27, seed=9))]
    rng = np.random.default_rng(10)
    for s in specs[::2]:
        if cfg.family == "audio":
            s.inputs = {"frames": rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm":
            s.inputs = {"patches": rng.standard_normal(
                (cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)}
    _, got, _ = run_both(arch, specs, slots=2, max_len=32, worker="manual",
                         warm=True, buckets=dict(batch_buckets=(1, 2),
                                                 len_buckets=(8, 16, 32)))
    eng = got._prefill_engine
    progs = [eng.peek(b) for b in eng.warm_buckets()]
    assert [p.bucket for p in progs] == [8, 16, 32]
    assert all(isinstance(p, PrefillProgram) and p.cache is progs[0].cache
               for p in progs)
    assert got.summary()["engines"]["prefill"] == {"captured": False,
                                                  "programs": 3}
    assert sum(p.calls for p in progs) == len(specs)
