"""The system under test as a served decoder: ``repro_torch.compile(cfg,
CompileOptions(target="engine"))`` over weights the reference module
makes from the seed, ``repro_torch.serve`` with the mix's scheduler
options, then the mix offered through ``Scheduler.submit`` and
``Scheduler.step``.

The window: requests are submitted when due (the mix's kind says
whether they arrive in an open loop or wait as a backlog); the benchmark
steps the scheduler whenever work is outstanding and stamps, on its own
clock after each step, the first token of each request and every token
that reached the host.  An open loop keeps stepping after the window
until each request due in it has its first token, ``drain_cap_s`` at
most; a request still without one counts as failed, its wait the whole
time to the cap.

``correct``: a sample of the served requests, drawn from the seed with
the longest in it and, where the prefix cache served any, one whose head
was restored from it, is run through the reference (float32) with its
served tokens; the widest gap by which a served token's logit lies
below the reference's best must stay within the cell's limit.  Greedy
sampling, so the served token is the program's own first choice.  A
request counts as restored when the step that admitted it took as many
prefix-cache hits as it admitted requests (or as it admitted requests
with a shared head); a step whose hits cannot be told apart marks none.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, generator
from ..trace import Slice, span, warm_profiler

WARM_UID = 1 << 40


def _options(repro_torch, serve: Dict):
    kw = {k: v for k, v in serve.items() if k != "buckets"}
    if "buckets" in serve:
        kw["buckets"] = repro_torch.BucketPolicy.default(
            *serve["buckets"]["default"])
    return repro_torch.SchedulerOptions(fold=True, **kw)


def _warm(sched, Request, serve: Dict, vocab: int) -> None:
    """Two requests of the cell's shapes (two chunks and one, a few
    decode steps), drained and forgotten: the first replay of each
    program the window uses happens here."""
    rng = np.random.default_rng(0)
    chunk = serve.get("prefill_chunk") or 16
    for i, plen in enumerate((chunk + 1, chunk // 2)):
        sched.submit(Request(uid=WARM_UID + i, max_new_tokens=4,
                             prompt=rng.integers(0, vocab, plen,
                                                 dtype=np.int64)
                             .astype(np.int32)))
    sched.run()
    sched.pop_completions(purge=True)


def _counters(sched) -> Dict[str, float]:
    s = sched.summary()
    m = sched.metrics
    pc = s.get("prefix_cache", {})
    return {"decode_steps": m.decode_steps,
            "decode_slot_steps": m.decode_slot_steps,
            "prefill_chunks": m.prefill_chunks,
            "admitted": m.admitted,
            "shared_tokens": pc.get("shared_tokens", 0),
            "hits": pc.get("hits", 0)}


def _sample(r, reqs: Dict[int, Dict], served: Dict[int, List[int]],
            restored: set) -> List[int]:
    """Served requests for the check, drawn from the seed: the longest
    first, then one restored from the prefix cache (if any was served),
    then others until ``sample_tokens`` served tokens or
    ``sample_requests`` requests."""
    check = r.mix["check"]
    size = lambda u: len(reqs[u]["prompt"]) + len(served[u])
    uids = sorted(served)
    if not uids:
        return []
    longest = max(uids, key=lambda u: (size(u), u))
    rng = np.random.default_rng([int(r.seed) & generator.MASK64, 1])
    rest = [u for u in rng.permutation(uids).tolist() if u != longest]
    first = [longest]
    if longest not in restored:
        first += [u for u in rest if u in restored][:1]
    out, n = [], 0
    for u in first + [u for u in rest if u not in first]:
        if n >= check["sample_tokens"] or \
                len(out) >= check["sample_requests"]:
            break
        out.append(u)
        n += len(served[u])
    return out


def run(r) -> Dict:
    import repro_torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve import Request

    arch, mix = r.config["run"], r.mix
    dev = torch.device(r.device)
    dtype = getattr(torch, r.config["weights_dtype"])
    cuda = dev.type == "cuda"
    init = r.config.get("init", {})
    params = r.reference.make_weights(arch, r.seed, dev, dtype, **init)
    tb = time.perf_counter()
    exe = repro_torch.compile(
        ArchConfig(**arch),
        repro_torch.CompileOptions(device=r.device, **r.config["compile"]),
        params=params)
    del params
    sched = repro_torch.serve(exe, _options(repro_torch, mix["serve"]))
    warm_ok = sched.wait_warm(600.0)
    build_s = time.perf_counter() - tb
    if not warm_ok:
        raise RuntimeError("the serving programs did not all build")
    _warm(sched, Request, mix["serve"], arch["vocab"])
    if r.trace and cuda:
        warm_profiler(r.device)
    reqs = generator.generate(mix, r.seed, r.seconds, r.config, r.here)
    by_uid = {q["uid"]: q for q in reqs}
    setup_s = time.time() - r.t0
    w = _Window(r, sched, Request, reqs)
    w.loop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    reading = w.read_trace()

    served = dict(w.finished)
    if sum(len(t) for t in served.values()) < mix["check"]["sample_tokens"]:
        # not enough finished: the requests still generating, as far
        # as they got
        served.update({u: list(sched.generated[u]) for u in w.live})
    if not w.restored & set(served):
        # none restored has finished: those in flight, as far as they got
        served.update({u: list(sched.generated[u])
                       for u in w.live & w.restored})
    sched.shutdown()
    del sched, exe, w.sched
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    uids = _sample(r, by_uid, served, w.restored)
    sample = [(by_uid[u]["prompt"].tolist(), list(served[u])) for u in uids]
    weights = r.reference.make_weights(arch, r.seed, dev, dtype, **init)
    gaps = r.reference.gaps(arch, weights, sample)
    limits = r.limits
    check = {"max_gap": {"value": max(gaps) if gaps else float("nan"),
                         "limit": limits["max_gap"], "holds": "<="},
             "compared_tokens": {"value": sum(len(t) for _, t in sample),
                                 "limit": limits["compared_tokens"],
                                 "holds": ">="}}
    if "restored_compared" in limits:
        # a run whose prefix cache served a head compares one such request
        check["restored_compared"] = {
            "value": len(w.restored.intersection(uids)),
            "limit": limits["restored_compared"] if w.hits > w.c0["hits"]
            else 0, "holds": ">="}
    out = w.context(arch, r.config["peak"])
    out.update(setup_s=setup_s, build_s=build_s, memory_peak_bytes=peak,
               check=check, trace=reading)
    if r.control:
        ctrl = r.reference.gaps(arch, weights, sample, control=True)
        out["control_check"] = dict(check, max_gap=dict(
            check["max_gap"], value=max(ctrl) if ctrl else float("nan")))
    return out


class _Window:
    """The measured window of one run and what it recorded."""

    def __init__(self, r, sched, Request, reqs: List[Dict]) -> None:
        self.r, self.sched, self.Request, self.reqs = r, sched, Request, reqs
        self.by_uid = {q["uid"]: q for q in reqs}
        self.open_loop = generator.kind(r.mix, r.here).OPEN_LOOP
        self.first: Dict[int, float] = {}
        self.due: Dict[int, float] = {}
        self.waiting: set = set()       # submitted, no first token yet
        self.queued: set = set()        # submitted, not yet admitted
        self.live: set = set()          # first token, not finished
        self.seen: Dict[int, int] = {}  # tokens counted a request
        self.finished: Dict[int, List[int]] = {}
        self.restored: set = set()      # heads restored from the cache
        self.refused = 0
        self.steps: List[tuple] = []    # (s, decode steps, chunks)
        self.tokens = 0                 # reached the host in the window
        self.decode_flops = 0
        self.prompt_admitted = 0
        self.slice = None
        self.slice_open = False

    # -- the loop ---------------------------------------------------------
    def loop(self) -> None:
        r, sched = self.r, self.sched
        m = sched.metrics
        slice_s = float(r.mix.get("trace_slice_s", 3.0))
        cap = float(r.mix.get("drain_cap_s", 60.0))
        reqs, i, n = self.reqs, 0, len(self.reqs)
        self.c0 = _counters(sched)
        self.hits = self.c0["hits"]
        t0 = self.t_start = time.perf_counter()
        t_end = self.t_end = t0 + r.seconds
        self.c1 = None
        while True:
            now = time.perf_counter()
            # every request is due inside the window: one that fell due
            # during the last step is submitted now, even past its close
            while i < n and t0 + reqs[i]["due"] <= now:
                with span("submit", r.trace):
                    self._submit(reqs[i], t0)
                i += 1
            if self.c1 is None and now >= t_end:
                self.c1 = _counters(sched)
                self._stop_slice()
            if self.c1 is not None and (not self.open_loop
                                        or not self.waiting
                                        or now >= t_end + cap):
                break
            if (r.trace and self.slice is None and self.c1 is None
                    and now >= t_end - slice_s and r.device != "cpu"):
                self.slice = Slice(r.out_dir / f"{r.cell}.{r.seed}.json.gz")
                self.slice.__enter__()
                self.slice_open = True
            if not (self.waiting or self.live):
                nxt = t0 + reqs[i]["due"] if i < n else t_end
                time.sleep(max(0.0, min(nxt, t_end) - time.perf_counter()))
                continue
            d0, k0 = m.decode_steps, m.prefill_chunks
            tb = time.perf_counter()
            with span("step", r.trace):
                sched.step()
            ta = time.perf_counter()
            self._after_step(ta)
            if ta <= t_end:
                self.steps.append((ta - tb, m.decode_steps - d0,
                                   m.prefill_chunks - k0))
        self.failed_first = len(self.waiting) + self.refused
        self.cap_at = t_end + cap

    def _submit(self, q: Dict, t0: float) -> None:
        uid = q["uid"]
        try:
            self.sched.submit(self.Request(
                uid=uid, prompt=q["prompt"], max_new_tokens=q["max_new"],
                eos_id=-1, temperature=0.0))
        except (ValueError, RuntimeError):
            self.refused += 1
            return
        self.due[uid] = t0 + q["due"]
        self.waiting.add(uid)
        self.queued.add(uid)

    def _after_step(self, ta: float) -> None:
        sched, arch = self.sched, self.r.config["run"]
        in_window = ta <= self.t_end
        gen = sched.generated
        if self.queued:
            rm = sched.request_metrics
            got = [u for u in self.queued if rm[u].admitted_at is not None]
            for u in got:
                self.queued.discard(u)
                if in_window:
                    self.prompt_admitted += len(self.by_uid[u]["prompt"])
            if got:
                self._restored(got)
        for u in [u for u in self.waiting if u in gen]:
            self.waiting.discard(u)
            self.first[u] = ta
            self.live.add(u)
            self.seen[u] = 0
        head = counts.head_flops(arch)
        for u in list(self.live):
            g = gen[u]
            a, b = self.seen[u], len(g)
            if b > a and in_window:
                self.tokens += b - a
                # the first token comes from prefill; token j >= 1 from a
                # decode step attending plen + j positions
                plen = len(self.by_uid[u]["prompt"])
                j = max(a, 1)
                self.decode_flops += (b - a) * head + counts.prompt_flops(
                    arch, plen + j - 1, plen + b - 1)
            self.seen[u] = b
        for c in sched.pop_completions():
            if c.uid in self.live:
                self.live.discard(c.uid)
                self.finished[c.uid] = list(c.tokens)

    def _restored(self, got: List[int]) -> None:
        """Mark the requests just admitted whose heads came from the
        prefix cache, where the step's hits tell them apart."""
        if not self.r.mix["serve"].get("prefix_cache"):
            return
        hits = _counters(self.sched)["hits"]
        h, self.hits = hits - self.hits, hits
        shared = [u for u in got if self.by_uid[u]["head"] >= 0]
        if h and h == len(got):
            self.restored.update(got)
        elif h and h == len(shared):
            self.restored.update(shared)

    # -- the trace --------------------------------------------------------
    def _stop_slice(self) -> None:
        if self.slice_open:
            self.slice.__exit__(None, None, None)
            self.slice_open = False

    def read_trace(self):
        """The slice's reading (None untraced)."""
        return None if self.slice is None else self.slice.read()

    # -- what the readers get --------------------------------------------
    def context(self, arch: Dict, peak: str) -> Dict:
        c0, c1 = self.c0, self.c1
        delta = {k: c1[k] - c0[k] for k in c0}
        due_in_window = list(self.due)
        ttft = [self.first[u] - self.due[u] if u in self.first
                else self.cap_at - self.due[u] for u in due_in_window]
        ttft += [float(self.r.mix.get("drain_cap_s", 60.0))] * self.refused
        prefill_tokens = max(0, self.prompt_admitted - delta["shared_tokens"])
        flops = (self.decode_flops
                 + 2 * arch["num_layers"] * counts.layer_matmul_params(arch)
                 * prefill_tokens)
        if self.open_loop:
            attempted, failed = len(due_in_window) + self.refused, \
                self.failed_first
        else:
            attempted, failed = delta["admitted"] + self.refused, \
                self.refused
        return {"kind": "serve", "window_s": self.t_end - self.t_start,
                "ttft_s": ttft if self.open_loop else [],
                "tokens": self.tokens, "counters": delta,
                "prompt_admitted": self.prompt_admitted,
                "steps": self.steps, "flops": flops,
                "peak_flops": counts.PEAK_FLOPS[peak],
                "attempted": attempted, "failed": failed}
