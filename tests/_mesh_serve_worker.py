"""The ranks of the mesh-serving tests (``test_torch_mesh_serve.py``).

One process a rank of a gloo group on the CPU (``torch.multiprocessing``
with a ``file://`` rendezvous, never a TCP port), spawned once per mesh.
Each rank serves every case and writes what it saw to
``<out>/<rank>.json`` (rank 0 also writes the forwards' logits to
``<out>/forward.npz``); the tests read the files.  Imports neither jax
nor the reference, so the children start fast, and the ``cuda``-marked
twins (``test_torch_mesh_serve_cuda.py``) run the same cases on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import torch

ARCH = "qwen2.5-14b"
#: The reference's oracle (``test_sharding.py``): 4 slots, max_len 64,
#: 6 prompts of 4-16 tokens from seed 0, 8 new tokens.
SLOTS, MAX_LEN, N_PROMPTS, MAX_NEW = 4, 64, 6, 8
#: The bucketed case: chunked prefill, a prefix cache, and deadline
#: admission over these first-token SLOs (ms; one tick of the test
#: clocks is one second, so they reorder admissions).
CHUNK, PREFIX = 16, 2
SLO_MS = (6000.0, 1000.0, 5000.0, 2000.0, 4000.0, 3000.0)
#: The staggered case: the bucketed one with these new-token budgets, so
#: requests retire at different steps and compaction moves rows between
#: the ranks that store them.
STAGGERED_NEW = (8, 3, 6, 2, 7, 4)
#: The compacting case: the bucketed one with budgets whose retirements
#: leave holes that compaction fills from the same data shard (3 -> 2
#: and 1 -> 0 on data=2, two slots a rank) and from the other (2 -> 1).
COMPACTING_NEW = (3, 4, 8, 6, 2, 4)
COMPACTING_MOVES = ((3, 2), (2, 1), (1, 0))
CASES = ("fixed", "bucketed", "staggered", "compacting")
#: The sampled case (meshes that split the slots): the compacting one
#: at this temperature, whose draws must not depend on the rank that
#: samples a slot.
TEMPERATURE = 0.8
#: The fault case: the visible devices shrink by one after this many
#: readings of the device source.
FAULT_AFTER = 4
#: The forwards held against their unsharded twins under ``model=2``:
#: (name, arch, config changes).  ``mixtral-tp`` has one expert, which
#: the model axis does not split, so it splits the hidden width (TP).
FORWARDS = (
    ("deepseek-v3", "deepseek-v3-671b", {}),
    ("mixtral-ep", "mixtral-8x22b", {}),
    ("mixtral-tp", "mixtral-8x22b", {"n_experts": 1, "top_k": 1}),
    ("qwen-tp_psum", "qwen2.5-14b", {"tp_psum": True}),
)
FORWARD_SHAPE = (2, 12)


def prompts(vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.integers(4, 17)))
            for _ in range(N_PROMPTS)]


class TickClock:
    """One tick (second) per call, counting up from ``start`` or, with
    ``step=-1``, down from it: a clock that disagrees with rank 0's."""

    def __init__(self, start: float = 0.0, step: float = 1.0):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return float(self.t)


def bucketed_options():
    from repro_torch.runtime import BucketPolicy
    return dict(buckets=BucketPolicy.default(max_batch=SLOTS,
                                             max_len=MAX_LEN),
                prefill_chunk=CHUNK, prefix_cache=PREFIX,
                admission="deadline")


def new_tokens(case: str):
    """Each request's new-token budget in ``case``."""
    return {"staggered": STAGGERED_NEW, "compacting": COMPACTING_NEW,
            "sampled": COMPACTING_NEW}.get(case, (MAX_NEW,) * N_PROMPTS)


def serve(mesh, *, case="fixed", clock=None, device_source=None,
          device="cpu"):
    """The oracle's requests served on ``mesh`` (None: one device) in
    ``case`` (all but "fixed" bucketed): ({uid: tokens}, summary, the
    error raised or None, the compaction moves)."""
    bucketed = case != "fixed"
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.serve import Request
    cfg = get_config(ARCH, smoke=True)
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=device, mesh=mesh), init_seed=0)
    opts = repro_torch.SchedulerOptions(
        slots=SLOTS, max_len=MAX_LEN,
        **(bucketed_options() if bucketed else {}))
    extra = {"clock": clock} if clock is not None else {}
    sched = repro_torch.serve(exe, opts, device_source=device_source,
                              **extra)
    moves, compact = [], sched.slot_manager.compact

    def recorded():
        done = compact()
        moves.extend(done)
        return done
    sched.slot_manager.compact = recorded
    temperature = TEMPERATURE if case == "sampled" else 0.0
    for i, (p, new) in enumerate(zip(prompts(cfg.vocab), new_tokens(case))):
        sched.submit(Request(uid=i, prompt=p, max_new_tokens=new,
                             temperature=temperature,
                             slo_ms=SLO_MS[i] if bucketed else None))
    error = None
    try:
        sched.run()
    except Exception as e:              # the fault case's typed error
        error = {"type": type(e).__name__,
                 "missing_axes": list(getattr(e, "missing_axes", ()))}
    summary = sched.summary()
    sched.shutdown()
    return ({c.uid: list(c.tokens) for c in sched.done}, summary, error,
            moves)


class Shrinking:
    """A device source that shows ``n`` devices, then ``n - 1``."""

    def __init__(self, n: int, after: int):
        self.n, self.after, self.calls = n, after, 0

    def __call__(self):
        self.calls += 1
        return self.n - (self.calls > self.after)


def forward_inputs(vocab: int):
    rng = np.random.default_rng(1)
    return rng.integers(0, vocab, FORWARD_SHAPE).astype(np.int32)


def forward_cfg(arch, changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", **changes)


def forwards(mesh_spec, device="cpu"):
    """Each forward of FORWARDS unsharded and under ``use_mesh`` on the
    live mesh, in this rank: {name: record}, {name: logits}."""
    from repro_torch.dist.collectives import LiveMesh
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import get_model
    mesh = LiveMesh(mesh_spec, torch.device(device))
    out, logits = {}, {}
    for name, arch, changes in FORWARDS:
        cfg = forward_cfg(arch, changes)
        m = get_model(cfg)
        params = m.init(0, device)
        batch = {"tokens": forward_inputs(cfg.vocab)}
        with torch.inference_mode():
            want, wx = m.forward(params, batch)
            with use_mesh(mesh):
                got, gx = m.forward(params, batch)
        scale = max(1.0, float(want.abs().max()))
        out[name] = {"bit_equal": bool(torch.equal(got, want)),
                     "max_abs_err": float((got - want).abs().max()),
                     "scale": scale,
                     "aux_equal": bool(torch.equal(gx["aux_loss"],
                                                   wx["aux_loss"]))}
        logits[name] = got.cpu().numpy()
    return out, logits


def run_group(rank: int, world: int, init_file: str, mesh: str,
              out_dir: str, device: str = "cpu") -> None:
    """One rank: every case on ``mesh``, the results to a JSON file (on
    the card: serving and the forwards, no fault case)."""
    import torch.distributed as dist
    from repro_torch.dist import MeshSpec
    torch.set_num_threads(1)
    # a rank left waiting in a collective its peers never join fails
    # within minutes, not gloo's default half hour
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        # rank 0's clock is the single-device run's; the others run
        # backwards, so their deadlines would order admissions the other
        # way round.
        def clock():
            return TickClock() if rank == 0 else TickClock(1000.0 + rank,
                                                           -1.0)
        for case in CASES:
            tokens, summary, error, moves = serve(
                mesh, case=case, device=device,
                clock=clock() if case != "fixed" else None)
            results[case] = {"tokens": tokens, "error": error,
                             "sharding": summary.get("sharding"),
                             "faults": summary.get("faults"),
                             "moves": moves}
        if "data" in mesh and device == "cpu":
            tokens, _, error, _ = serve(mesh, case="sampled", clock=clock())
            results["sampled"] = {"tokens": tokens, "error": error}
        if mesh == "data=2" and device == "cpu":
            tokens, summary, error, _ = serve(
                mesh, device_source=Shrinking(world, FAULT_AFTER))
            results["fault"] = {"tokens": tokens, "error": error,
                                "faults": summary.get("faults")}
        if mesh == "model=2":
            results["forwards"], logits = forwards(MeshSpec.parse(mesh),
                                                   device)
            if rank == 0:
                np.savez(os.path.join(out_dir, "forward.npz"), **logits)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        from repro_torch.dist.collectives import destroy_process_group
        destroy_process_group()


def spawn_group(mesh: str, world: int, out_dir: str,
                device: str = "cpu") -> None:
    """Run ``world`` ranks of ``mesh`` to their end."""
    import torch.multiprocessing as mp
    init_file = os.path.join(out_dir, "rendezvous")
    mp.spawn(run_group, args=(world, init_file, mesh, out_dir, device),
             nprocs=world, join=True)
