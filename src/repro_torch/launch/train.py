"""End-to-end training launcher — the port of ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt /tmp/ck

Wires config → model → train step (microbatching, grad compression) →
synthetic data → async checkpointer (resume from the latest step, a
save on SIGTERM) → straggler watchdog → one JSON log line every
``--log-every`` steps.  It takes the reference's flags, plus
``--device`` (the card by default; ``--device cpu`` runs without one).

The step updates the state in place, so SIGTERM only marks the run as
preempted: the step under way finishes, the loop saves the whole state
under that step (blocking) and exits with code 143.  A run resumed with
the same ``--steps`` follows the schedule of one that never stopped.

``--mesh host`` is the reference's 1×N (data, model) mesh over the
ranks of the process group ``torch.distributed.run`` starts (gloo; ranks
may share a card), one device without one, the same as ``none``::

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --smoke \
        --device cpu --mesh host

Every rank holds its part of the train state (the reference's
placement: ``init_state(..., mesh=)``, restored into that part) and runs
the mesh train step on its rows of each batch
(``SyntheticTokens.batch_rows``); rank 0 logs and writes the
checkpoints (the reference's whole layout, every part gathered), the
others wait at its barrier.  A SIGTERM marks only the rank that gets
it: after each step the ranks agree on "preempted" with a collective,
so every rank saves the same step and exits 143.
"""

from __future__ import annotations

import argparse
import json
import signal
import time


def main(argv=None) -> int:
    """CLI entry: run the training loop for ``--arch`` with optional
    microbatching, grad compression and checkpointing."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--deadline-s", type=float, default=300.0,
                    help="straggler watchdog per-step deadline")
    ap.add_argument("--mesh", default="host", choices=["host", "none"],
                    help="'host': 1xN (data, model) over the process "
                         "group's ranks (one device without a group)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_group

    joined = not dist.is_initialized()
    device = init_group(args.device)
    try:
        return _train(args, device)
    finally:
        if joined and dist.is_initialized():
            from repro_torch.dist.collectives import destroy_process_group
            destroy_process_group()


def _train(args, device) -> int:
    """The training loop of one process (one rank of a mesh)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.distributed import StragglerWatchdog
    from repro_torch.launch.mesh import host_mesh_spec
    from repro_torch.models import get_model
    from repro_torch.training import (OptConfig, TrainConfig, init_state,
                                      make_jitted_train_step)
    from repro_torch.training.train import rank_rows

    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    tc = TrainConfig(
        opt=OptConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 20),
                      schedule=cfg.lr_schedule),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads)
    mesh = host_mesh_spec() if args.mesh == "host" else None
    step_fn = make_jitted_train_step(model, tc, mesh=mesh, donate=True,
                                     device=device)
    live = getattr(step_fn, "mesh", None)
    writer = not dist.is_initialized() or dist.get_rank() == 0

    def say(text):
        if writer:
            print(text, flush=True)

    if mesh is not None:
        say(f"[train] mesh host: {mesh.describe()}, " + (
            f"{mesh.size} ranks" if live is not None
            else f"{mesh.size} device, the same as --mesh none"))

    data = SyntheticTokens(DataConfig(
        vocab=model.cfg.vocab, global_batch=args.batch, seq_len=args.seq))
    rows = None if live is None else rank_rows(args.batch, args.microbatches,
                                               live)
    layout = getattr(step_fn, "layout", None)

    ck = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    state = init_state(model, 0, device, mesh=live)
    preempted = []        # SIGTERM's mark; the loop saves between steps
    on_sigterm = signal.getsignal(signal.SIGTERM)
    if ck is not None:
        latest = ck.latest_step()
        if latest is not None:
            state = ck.restore(latest, state, layout=layout)
            start = latest + 1
            say(f"[train] resumed from step {latest}")
        signal.signal(signal.SIGTERM,
                      lambda signum, frame: preempted.append(signum))

    def stop() -> bool:
        """Whether any rank was sent SIGTERM (every rank agrees)."""
        if live is None:
            return bool(preempted)
        flag = torch.tensor([int(bool(preempted))])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def save(i, blocking):
        if layout is not None or writer:
            ck.save(i, state, blocking=blocking, layout=layout)

    wd = StragglerWatchdog(
        args.deadline_s,
        on_timeout=lambda s, el: print(
            f"[watchdog] step {s} exceeded {el:.1f}s", flush=True))

    t_start = time.time()
    try:
        for i in range(start, args.steps):
            host = data.batch(i) if rows is None else data.batch_rows(i, rows)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in host.items()}
            with wd.step(i):
                state, metrics = step_fn(state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                say(json.dumps({
                    "step": i,
                    "loss": round(float(metrics["loss"]), 4),
                    "lr": float(metrics["lr"]),
                    "grad_norm": round(float(metrics["grad_norm"]), 3),
                    "elapsed_s": round(time.time() - t_start, 1),
                }))
            halt = stop()
            periodic = i > 0 and i % args.ckpt_every == 0
            if ck is not None and (halt or periodic):
                save(i, blocking=halt)
            if halt:
                say(f"[train] SIGTERM: saved step {i}, exiting")
                return 143
        if ck is not None:
            save(args.steps - 1, blocking=True)
            ck.wait()
    finally:
        signal.signal(signal.SIGTERM, on_sigterm)
    say("[train] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
