"""Serving CLI — a thin command line over ``repro_torch.serve``.

The port of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --smoke --requests 16 --slots 8 --max-new 16

Compiles the model through ``repro_torch.compile(target="engine")`` on
``--device`` (the card by default; ``--device cpu`` runs it without
one), builds the continuous-batching scheduler, drains a synthetic
request queue and prints the scheduler's metrics summary (TTFT, tok/s,
batch occupancy).  It takes the reference's flags.

``--mesh data=2,model=2`` serves over a mesh of ranks, one process a
device, started by ``torch.distributed.run``, whose environment sets up
the (gloo) process group::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch qwen2.5-14b --smoke \
        --device cpu --mesh data=2,model=2

Every rank serves the same queue; only rank 0 prints.  Without a process
group a mesh of more than one device raises ``MeshUnavailableError``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_sharding_rules(text):
    """CLI spelling of ``CompileOptions.sharding_rules``: comma-separated
    ``logical=axis`` pairs, ``+`` joining multiple mesh axes and an
    empty right-hand side deleting the rule (forces replication) —
    e.g. ``"batch=pod+data,kv_seq=model,seq="``."""
    rules = []
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad sharding rule {part!r}; expected logical=axis "
                f"(e.g. 'kv_seq=model,batch=pod+data,seq=')")
        name, axes = part.split("=", 1)
        axes = tuple(a.strip() for a in axes.split("+") if a.strip())
        rules.append((name.strip(), axes or None))
    return tuple(rules)


def main(argv=None) -> int:
    """CLI entry: compile ``--arch`` for the engine target, serve a
    synthetic queue, print (or ``--json``-dump) the metrics summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--admission", default="fcfs",
                    choices=("fcfs", "shortest", "deadline"))
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="first-token SLO (ms) attached to every synthetic "
                         "request; summary() then reports slo_violations")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: prompts advance this many "
                         "tokens per step, interleaved with decodes "
                         "(must divide --max-len)")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="shared prompt-head KV snapshots to keep "
                         "(requires --prefill-chunk); 0 = off")
    ap.add_argument("--precision", default="exact",
                    choices=("exact", "fast", "f32", "bf16"),
                    help="compiled precision; bf16 = weight-only "
                         "storage cast for the engine target (int8/"
                         "mixed are rejected by the engine target) — the "
                         "active precision + decision counts land in "
                         "summary()['precision']")
    ap.add_argument("--calibrate", type=int, default=None, metavar="N",
                    help="calibration batches, forwarded to "
                         "CompileOptions for graph-routed precisions")
    ap.add_argument("--no-fold", action="store_true")
    ap.add_argument("--buckets", action="store_true", default=None,
                    help="shape-polymorphic serving: decode at the best "
                         "warm batch bucket, prefill per length bucket, "
                         "background capture of cold buckets")
    ap.add_argument("--no-buckets", dest="buckets", action="store_false",
                    help="fixed-shape serving (the default)")
    ap.add_argument("--mesh", default=None,
                    help="serve over a device mesh, e.g. 'data=2,model=2': "
                         "batch rows shard over data, the decode KV cache "
                         "over model (the kv_seq rule); one process a "
                         "device (torch.distributed.run); the mesh is a "
                         "compile input (CompileOptions.mesh), so the "
                         "scheduler inherits it from the executable")
    ap.add_argument("--sharding-rules", default=None,
                    help="logical-axis rule overrides, e.g. "
                         "'kv_seq=model,batch=pod+data,seq=' (empty "
                         "right-hand side forces replication)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="print the metrics summary as JSON")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    import repro_torch
    from repro_torch.launch.mesh import init_group
    from repro_torch.configs import get_config
    from repro_torch.serve import Request

    cfg = get_config(args.arch, smoke=args.smoke)

    policy = None
    if args.buckets:
        policy = repro_torch.BucketPolicy.default(max_batch=args.slots,
                                                  max_len=args.max_len)

    # The mesh rides the compile options (one mesh spelling everywhere:
    # CLI -> MeshSpec -> CompileOptions -> SchedulerOptions default).
    mesh = repro_torch.MeshSpec.parse(args.mesh) if args.mesh else None
    rules = (parse_sharding_rules(args.sharding_rules)
             if args.sharding_rules else None)
    device = init_group(args.device) if mesh else args.device
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = sys.stdout if rank == 0 else None

    def say(*a, **kw):
        if out is not None:
            print(*a, **kw)

    t0 = time.perf_counter()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision=args.precision,
        calibrate=args.calibrate, device=device, mesh=mesh,
        sharding_rules=rules))
    sched = repro_torch.serve(exe, repro_torch.SchedulerOptions(
        slots=args.slots, max_len=args.max_len, admission=args.admission,
        fold=not args.no_fold, buckets=policy,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache))
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 17))
        sched.submit(Request(uid=i,
                             prompt=rng.integers(0, cfg.vocab, plen),
                             max_new_tokens=args.max_new,
                             slo_ms=args.slo_ms))
    t_build = time.perf_counter() - t0
    # progress goes to stderr so that --json leaves stdout parseable
    say(f"[serve] scheduler up in {t_build:.2f}s on {exe.device} "
        f"(norm folds: {sched.fold_report['folds']})",
        file=sys.stderr if args.json else sys.stdout, flush=True)

    done = sched.run()
    summary = sched.summary()
    sched.shutdown()
    if dist.is_initialized():
        from repro_torch.dist.collectives import destroy_process_group
        del sched
        destroy_process_group()
    if out is None:
        return 0
    if args.json:
        print(json.dumps(summary, indent=2), flush=True)
    else:
        print(f"[serve] {summary['completed']} completions, "
              f"{summary['total_new_tokens']} tokens "
              f"({(summary['tokens_per_s'] or 0):.1f} tok/s, "
              f"mean TTFT {(summary['mean_ttft'] or 0) * 1e3:.0f}ms, "
              f"occupancy {(summary['mean_batch_occupancy'] or 0):.2f}"
              f"/{args.slots})", flush=True)
        if "precision" in summary:
            pr = summary["precision"]
            print(f"[serve] precision {pr['precision']}"
                  + (f", decisions {pr['decisions']}"
                     if pr.get("decisions") else ""), flush=True)
        if "runtime" in summary:
            rt = summary["runtime"]
            print(f"[serve] buckets: {rt['bucket_hits']} hits, "
                  f"{rt['bucket_misses']} misses, "
                  f"{rt['background_compiles']} background captures, "
                  f"{rt['compile_stalls']} stalls, "
                  f"pad waste {rt['pad_waste_frac']:.1%}", flush=True)
        if "sharding" in summary:
            sh = summary["sharding"]
            per = {a: f"{v['count']}x/{v['bytes'] / 1e3:.1f}KB"
                   for a, v in sh["collectives"]["per_axis"].items()}
            print(f"[serve] mesh {sh['mesh']} ({sh['devices']} devices): "
                  f"collectives {per or 'none'}, "
                  f"faults {len(summary.get('faults', []))}", flush=True)
        for c in sorted(done, key=lambda c: c.uid)[:4]:
            print(f"  uid={c.uid} reason={c.finish_reason} "
                  f"tokens={c.tokens[:8]}...", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
