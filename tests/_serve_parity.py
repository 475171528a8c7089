"""Shared pieces of the serve parity tests (``test_torch_serve*.py``).

The same request trace runs through ``repro.serve`` and
``repro_torch.serve`` over the same weights (the reference's
``init(PRNGKey(0))``, carried across with
``repro_torch.weights.params_from_reference``) at the ``SMOKE`` configs
with ``dtype="float32"``, the same ``TickClock`` and a sampler that
records the logits it is handed; :func:`run_both` asserts the same
tokens, finish reasons and order, sampler calls, logits within
``LOGITS_TOL`` x max(1, max|logits|), ``summary()`` and per-request
metrics key for key.  The port's summary has one key the reference's
lacks, ``engines`` (which serving programs are CUDA graphs): it is held
apart, to the programs the scheduler built, none captured on the CPU.
"""

import dataclasses

import numpy as np
import torch

import jax

import repro
from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.runtime import BucketPolicy
from repro_torch.serve import Request, Scheduler, SchedulerOptions
from repro_torch.weights import params_from_reference

LOGITS_TOL = 1e-5


_PAIRS = {}


def pair(arch, **changes):
    """(reference model, its params, port model, the same params) for the
    f32 SMOKE config of ``arch`` with ``changes``; made once per key."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _PAIRS:
        rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                                   dtype="float32", **changes)
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", **changes)
        rm = ref_model(rcfg)
        # Eager init of an MLA/MoE tree dispatches op by op (12 s for
        # deepseek-v3's SMOKE config); jitted it is one program.
        init = jax.jit(rm.init) if rcfg.mla else rm.init
        rp = init(jax.random.PRNGKey(0))
        _PAIRS[key] = (rm, rp, get_model(cfg),
                       params_from_reference(jax.tree.map(np.asarray, rp)))
    return _PAIRS[key]


class TickClock:
    """Monotone integer clock: one tick per call."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1
        return float(self.t)


class Recorder:
    """Records every logits row it is handed (as f32 numpy) and returns
    ``script[uid][index]`` (1 once a script runs out) or, for a request
    without a script, the argmax."""

    def __init__(self, script=None):
        self.script = script or {}
        self.calls = []
        self.logits = []

    def __call__(self, logits, temperature, *, uid, index):
        if isinstance(logits, torch.Tensor):
            a = logits.detach().float().cpu().numpy()
        else:
            a = np.asarray(logits, np.float32)
        self.calls.append((uid, index))
        self.logits.append(a.copy())
        if uid in self.script:
            seq = self.script[uid]
            return seq[index] if index < len(seq) else 1
        return int(np.argmax(a, axis=-1)[0])


@dataclasses.dataclass
class Spec:
    """One request of a trace, for either package's ``Request``."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 4
    eos_id: int = -1
    slo_ms: float = None
    inputs: dict = None

    def make(self, cls):
        return cls(uid=self.uid, prompt=self.prompt,
                   max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
                   slo_ms=self.slo_ms, inputs=self.inputs)


def drive(sched, cls, specs, late=None):
    """Submit ``specs``, then step until drained; ``late`` maps a step
    index to specs submitted just before that step."""
    late = dict(late or {})
    for s in specs:
        sched.submit(s.make(cls))
    steps = 0
    while (sched.queue_depth() or sched.num_active() or sched._prefilling
           or late):
        for s in late.pop(steps, ()):
            sched.submit(s.make(cls))
        sched.step()
        steps += 1
    return steps


def sides(arch, **changes):
    """The reference's then the port's (Scheduler, SchedulerOptions,
    Request, model, params, BucketPolicy) over the same weights."""
    from repro.serve import Request as RefRequest
    from repro.serve import Scheduler as RefScheduler
    from repro.serve import SchedulerOptions as RefOptions
    rm, rp, pm, pp = pair(arch, **changes)
    return ((RefScheduler, RefOptions, RefRequest, rm, rp,
             repro.BucketPolicy),
            (Scheduler, SchedulerOptions, Request, pm, pp, BucketPolicy))


def run_both(arch, specs, *, late=None, script=None, worker=None,
             warm=False, cfg_changes=None, **opts):
    """The same trace through the reference's scheduler and the port's:
    (reference scheduler, port scheduler, their recorders)."""
    out = []
    for sched_cls, opt_cls, req_cls, model, params, policy in sides(
            arch, **(cfg_changes or {})):
        kw = dict(opts)
        if "buckets" in kw:
            kw["buckets"] = policy(**kw["buckets"])
        rec = Recorder(script)
        extra = {} if worker is None else {"engine_worker": worker}
        sched = sched_cls(model, params, opt_cls(fold=False, **kw),
                          sampler=rec, clock=TickClock(), **extra)
        if warm:
            sched.wait_warm()
        drive(sched, req_cls, specs, late)
        sched.shutdown()
        out.append((sched, rec))
    (ref, ref_rec), (got, got_rec) = out
    assert_same(ref, ref_rec, got, got_rec)
    return ref, got, got_rec


def close(got, want):
    err = float(np.abs(got - want).max())
    return err <= LOGITS_TOL * max(1.0, float(np.abs(want).max())), err


def assert_same(ref, ref_rec, got, got_rec):
    assert got_rec.calls == ref_rec.calls
    for (uid, index), a, b in zip(got_rec.calls, got_rec.logits,
                                  ref_rec.logits):
        ok, err = close(a, b)
        assert ok, f"uid {uid} token {index}: logits off by {err}"
    assert [(c.uid, c.tokens, c.finish_reason) for c in got.done] == \
        [(c.uid, [int(t) for t in c.tokens], c.finish_reason)
         for c in ref.done]
    summ = got.summary()
    assert summ.pop("engines") == engines_on_cpu(got)
    assert summ == ref.summary()
    assert {u: m.to_dict() for u, m in got.request_metrics.items()} == \
        {u: m.to_dict() for u, m in ref.request_metrics.items()}


def engines_on_cpu(sched):
    """``summary()["engines"]`` of a port scheduler on the CPU: every
    program it runs, none captured."""
    want = {"decode": {"captured": False,
                       "programs": len(sched.decode_steps())}}
    for name, eng in (("chunk", sched._chunk_engine),
                      ("prefill", sched._prefill_engine)):
        if eng is not None:
            want[name] = {"captured": False,
                          "programs": len(eng.warm_buckets())}
    if sched._chunk_engine is None and sched._prefill_engine is None:
        want["whole_prefill"] = {
            "captured": False,
            "programs": len(sched.whole_prefill_programs())}
    return want


def prompts(n, lo, hi, seed, vocab=256, head=None):
    """``n`` seeded prompts of ``lo``..``hi`` tokens; with ``head`` every
    odd one starts with it (the shared system prompt)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(
            np.int32)
        if head is not None and i % 2 == 1:
            p = np.concatenate([head, p])
        out.append(p)
    return out
