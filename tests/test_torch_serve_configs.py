"""Every SMOKE config served by the port like the JAX package, on the CPU.

The config sweep of the serve parity tests (the scheduling cases are
``test_torch_serve.py``; the shared pieces ``_serve_parity.py``): each
non-hybrid config runs one trace through ``repro.serve`` and
``repro_torch.serve`` with slots 3, batch and length buckets, chunked
prefill with a prefix cache where the family has it, and requests
arriving mid-run (with ``frames``/``patches`` for whisper and
internvl2): the same tokens, logits within 1e-5 x max(1, max|logits|),
``summary()`` equal key for key.

``recurrentgemma`` is held to the reference's model instead of its
scheduler, whose slot manager splices every leaf along axis 1:
recurrentgemma's ``rec_conv``/``rec_h`` carry the batch on axis 2, so
the reference serves that family with misplaced state.  The oracle is
the reference's ``prefill`` + greedy ``decode_step`` per request.
"""

import numpy as np
import pytest

import jax

from _serve_parity import (Recorder, Spec, close, drive, pair, prompts,
                           run_both)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.runtime import BucketPolicy
from repro_torch.serve import Request, Scheduler, SchedulerOptions


NON_HYBRID = [a for a in ARCH_NAMES if a != "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", NON_HYBRID)
def test_every_config_served_like_the_reference(arch):
    """Slots 3, max_len 32, batch and length buckets, chunked prefill
    with a prefix cache where the family has it; two requests arrive
    mid-run."""
    head = np.arange(8, dtype=np.int32) * 3 % 256
    specs = [Spec(u, p, 4) for u, p in
             enumerate(prompts(5, 3, 8, seed=7, head=head))]
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(11)
    for s in specs[::2]:
        if cfg.family == "audio":
            s.inputs = {"frames": rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm":
            s.inputs = {"patches": rng.standard_normal(
                (cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)}
    _, got, _ = run_both(arch, specs[:3], late={1: specs[3:]}, slots=3,
                         max_len=32, worker="manual",
                         prefill_chunk=8, prefix_cache=2,
                         buckets=dict(batch_buckets=(1, 2, 4),
                                      len_buckets=(16, 32)))
    assert got.summary()["completed"] == len(specs)


def test_hybrid_served_like_the_reference_model():
    """recurrentgemma: each request's tokens and logits are the
    reference model's ``prefill`` then greedy ``decode_step`` at batch 1,
    with requests sharing the batch, one arriving mid-run, and batch
    buckets (every bucket warm), so rows are compacted and decoded at
    buckets below the slot count, each leaf along its own axis."""
    rm, rp, pm, pp = pair("recurrentgemma-9b")
    max_len, new = 32, 5
    ps = prompts(4, 5, 20, seed=9)
    ps[2], ps[3] = ps[2][:len(ps[0])], ps[3][:len(ps[1])]   # 2 lengths
    sched = Scheduler(pm, pp, SchedulerOptions(
        slots=3, max_len=max_len, fold=False,
        buckets=BucketPolicy(batch_buckets=(1, 2, 4))),
        sampler=(rec := Recorder()), engine_worker="manual")
    sched.wait_warm()
    drive(sched, Request, [Spec(u, p, new) for u, p in enumerate(ps[:3])],
          late={2: [Spec(3, ps[3], new)]})
    got = {}
    for (uid, _), a in zip(rec.calls, rec.logits):
        got.setdefault(uid, []).append(a)
    prefill = jax.jit(lambda p, t, c: rm.prefill(p, {"tokens": t}, c))
    decode = jax.jit(rm.decode_step)
    for uid, p in enumerate(ps):
        lg, cache = prefill(rp, p[None], rm.init_cache(1, max_len))
        want, toks = [np.asarray(lg[:, -1])], []
        for _ in range(new - 1):
            toks.append(int(np.argmax(want[-1])))
            lg, cache = decode(rp, cache, np.array([[toks[-1]]], np.int32))
            want.append(np.asarray(lg[:, -1]))
        toks.append(int(np.argmax(want[-1])))
        assert sched.generated[uid] == toks, uid
        for i, (a, b) in enumerate(zip(got[uid], want)):
            ok, err = close(a, b)
            assert ok, f"uid {uid} token {i}: logits off by {err}"
    decode = sched.summary()["runtime"]["decode"]
    assert decode["warm_buckets"] == ["b1", "b2", "b3"]
    assert decode["bucket_hits"] > 0 and sched.metrics.decode_steps > 0
