"""Find the knee of an open-loop cell: the highest offered rate whose queue
does not grow over the window.  One process builds the cell's program
once, then offers the cell's mix at each rate for ``--seconds``, drains,
and prints one JSON line a rate: requests due, how many had their first
token by the window's end, the requests waiting for one (mean over each
quarter of the window, and at its close), the TTFT median of the
requests due in each quarter, p95, tokens/s and occupancy.

A rate is sustained when the mean waiting over the window's last quarter
is at most 1.5 times that over its second quarter plus one request; the
knee is the highest rate sustained with every lower rate swept.  With
``--orders N`` the process then offers ``share`` of the knee (rounded
down to 0.05) on N schedules, the cell's window and drain each, the
sizes dealt to the arrival times in the order of seeds ``seed + 1`` ...
``seed + N``, and prints each one's TTFT p95 and tokens/s: the spread
the seed's order would put into the cell.

    python3 bench/sweep.py --workload minicpm-2b.chat --seed 1 \\
        --seconds 51 --rates 1.0,1.2,1.4,1.6,1.8 --orders 6

The cell then offers about four fifths of the knee (its mix's ``rate``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as R  # noqa: E402


def _waiting(w, t: float) -> int:
    return sum(1 for u, d in w.due.items()
               if d <= t and w.first.get(u, math.inf) > t)


def _quarters(w):
    """Mean waiting over each quarter of the window, and the TTFT median
    of the requests due in each."""
    from bench.stats import percentile
    span = w.t_end - w.t_start
    out_w, out_t = [], []
    for q in range(4):
        a = w.t_start + q * span / 4
        ts = [a + (k + 0.5) * span / 80 for k in range(20)]
        out_w.append(sum(_waiting(w, t) for t in ts) / len(ts))
        tt = [w.first[u] - d for u, d in w.due.items()
              if a <= d < a + span / 4 and u in w.first]
        out_t.append(round((percentile(tt, 50) or 0) * 1e3, 1))
    return out_w, out_t


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    """``overrides`` maps ``config``/``mix`` to dicts used in place of the
    files (a small rehearsal on the CPU)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--orders", type=int, default=0)
    p.add_argument("--share", type=float, default=0.8)
    args = p.parse_args(argv)
    spec = R.load_json(R.ROOT / "BENCHMARK.json")
    entry = next(w for w in spec["workloads"] if w["name"] == args.workload)
    R.pin_caches(R.ROOT)
    sys.path.insert(0, str(R.ROOT / "src"))
    import torch
    import repro_torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve import Request

    from bench import generator
    from bench.systems import serve_llm as D
    from bench.refs import decoder
    from bench.stats import percentile

    overrides = overrides or {}
    cfg = overrides.get("config") or R.load_json(
        R.HERE / "configs" / f"{entry['config']}.json")
    mix = overrides.get("mix") or R.load_json(
        R.HERE / "traffic" / f"{entry['traffic']}.json")
    ttft = R.load_module(R.reader_path("ttft_p95_ms"), "ttft")
    arch = cfg["run"]
    params = decoder.make_weights(arch, args.seed, torch.device(device),
                                  getattr(torch, cfg["weights_dtype"]),
                                  **cfg.get("init", {}))
    exe = repro_torch.compile(ArchConfig(**arch), repro_torch.CompileOptions(
        device=device, **cfg["compile"]), params=params)
    del params
    sched = repro_torch.serve(exe, D._options(repro_torch, mix["serve"]))
    sched.wait_warm(600.0)
    D._warm(sched, Request, mix["serve"], arch["vocab"])
    offset = [0]

    def window(m, seed):
        reqs = generator.generate(m, seed, args.seconds, cfg)
        offset[0] += 1
        for q in reqs:
            q["uid"] += offset[0] << 32
        r = R.Run(cell=args.workload, config=cfg, mix=m, limits={},
                  reference=decoder, seed=seed, seconds=args.seconds,
                  trace=False, t0=time.time(), out_dir=R.ROOT / "build",
                  device=device)
        w = D._Window(r, sched, Request, reqs)
        w.loop()
        waiting = len(w.waiting)
        ctx = w.context(arch, cfg["peak"])
        sched.run()
        sched.pop_completions(purge=True)
        return reqs, w, waiting, ctx

    knee, ok = None, True
    for rate in (float(x) for x in args.rates.split(",")):
        reqs, w, waiting, ctx = window(dict(mix, rate=rate, drain_cap_s=0.0),
                                       args.seed)
        served = [w.first[u] - w.due[u] for u in w.first]
        quarters, ttft_q = _quarters(w)
        held = quarters[3] <= 1.5 * quarters[1] + 1
        ok = ok and held
        knee = rate if ok else knee
        print(json.dumps({
            "rate": rate, "due": len(reqs), "first_by_close": len(served),
            "waiting_at_close": waiting,
            "waiting_by_quarter": [round(x, 2) for x in quarters],
            "ttft_p50_ms_by_quarter": ttft_q, "sustained": held,
            "ttft_p50_ms": (percentile(served, 50) or 0) * 1e3,
            "ttft_p95_ms": (percentile(served, 95) or 0) * 1e3,
            "tokens_per_s": ctx["tokens"] / ctx["window_s"],
            "occupancy": (ctx["counters"]["decode_slot_steps"]
                          / max(1, ctx["counters"]["decode_steps"]))}),
            flush=True)
    print(json.dumps({"knee": knee}), flush=True)
    if args.orders and knee:
        rate = math.floor(args.share * knee * 20 + 1e-9) / 20
        for k in range(1, args.orders + 1):
            _, w, _, ctx = window(dict(mix, rate=rate, order_by_seed=True),
                                  args.seed + k)
            print(json.dumps({
                "rate": rate, "order_seed": args.seed + k,
                "due": len(w.due), "ttft_p95_ms": ttft.read(ctx),
                "tokens_per_s": ctx["tokens"] / ctx["window_s"],
                "failed": ctx["failed"]}), flush=True)
    sched.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
