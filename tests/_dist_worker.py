"""The ranks of the live-mesh tests (``test_torch_sharding_live.py``).

One process a rank of a gloo group on the CPU (``torch.multiprocessing``
with a ``file://`` rendezvous, never a TCP port), spawned once per group
and mesh.  Each rank runs every case and writes what it saw to
``<out>/<rank>.json``; the tests read the files.  Imports neither jax
nor the reference, so the children start fast.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

MODELS = ("C-HTWK", "C-BH", "VGG19", "Detector")
PRECISIONS = ("exact", "int8")
BATCHES = (1, 4)
#: The MLP block's second dense is row-parallel under model=2: its bias
#: and relu must apply once, after the reduce.  A bias this large would
#: show a second application far beyond the f32 limit.
MLP_BIAS = 3.0


def mlp_block():
    """Expand (column parallel), contract with a large bias and relu (row
    parallel, closed by a psum), residual."""
    from repro_torch.core import ModelBuilder
    mb = ModelBuilder().seed(7)
    x = mb.input((16,))
    up = mb.dense(x, 32, activation="relu")
    down = mb.dense(up, 16, activation="relu")
    out = mb.add(down, x)
    g = mb.build([out])
    node = [n for n in g.nodes if n.op == "dense"][1]
    g.params[node.params["bias"]] = np.full((16,), MLP_BIAS, np.float32)
    return g


def graphs():
    from repro_torch.table1_models import SUITE
    out = {name: SUITE[name] for name in MODELS}
    out["mlp"] = mlp_block
    return out


def feeds(graph, batch, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s.shape)).astype(
        np.float32) for n, s in graph.inputs.items()}


def _case(repro_torch, graph, mesh, precision, batch):
    opts = repro_torch.CompileOptions(target="cuda", precision=precision,
                                      device="cpu")
    base = repro_torch.compile(graph, opts)
    exe = repro_torch.compile(graph, opts.replace(mesh=mesh))
    x = feeds(graph, batch)
    out = exe(**x)
    want = base(**x)
    k, i, _ = exe._data_split(batch)
    n = batch // k
    rows = base(**{name: v[i * n:(i + 1) * n] for name, v in x.items()})
    summary = exe.cost_summary()["sharding"]
    full = {p: list(np.shape(exe.graph.params[p])) if p in exe.graph.params
            else None for p in summary["sliced_params"]}
    return {
        "err": max(float((want[o] - out[o]).abs().max()) for o in want),
        "scale": max(1.0, max(float(want[o].abs().max()) for o in want)),
        "equal": all(torch.equal(want[o], out[o]) for o in want),
        "rows_split": k,
        "rows_equal": all(torch.equal(rows[o], out[o][i * n:(i + 1) * n])
                          for o in want),
        "sliced": summary["sliced_params"],
        "full": full,
        "collectives": summary["collectives"],
        "captured": summary["captured"],
        "communicates": summary["communicates"],
        "coords": summary["coords"],
    }


def _round_trip(repro_torch, graph, mesh):
    """Serialize on every rank, deserialize (cold cache): the placement
    replayed, not propagated again; outputs bit-equal."""
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(
        target="cuda", precision="int8", device="cpu", mesh=mesh))
    back = repro_torch.deserialize(exe.serialize())
    stats = next(p for p in back.report["passes"]
                 if p["pass"] == "propagate_sharding")
    x = feeds(graph, 4, seed=1)
    a, b = exe(**x), back(**x)
    return {"type": type(back).__name__,
            "reused": back.cost_summary()["sharding"]["reused"],
            "pass_reused": stats.get("reused"),
            "collectives": stats.get("collectives"),
            "dist_equal": json.dumps(back.graph.dist, sort_keys=True)
            == json.dumps(exe.graph.dist, sort_keys=True),
            "nodes_equal": [n.name for n in back.graph.nodes]
            == [n.name for n in exe.graph.nodes],
            "equal": all(torch.equal(a[o], b[o]) for o in a)}


def run_group(rank: int, world: int, init_file: str, mesh: str,
              out_dir: str) -> None:
    """One rank: every case on ``mesh``, the results to a JSON file."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        import repro_torch
        results = {}
        for name, build in graphs().items():
            for precision in PRECISIONS:
                for batch in BATCHES:
                    results[f"{name}/{precision}/{batch}"] = _case(
                        repro_torch, build(), mesh, precision, batch)
        results["round_trip"] = _round_trip(repro_torch, graphs()["C-HTWK"](),
                                            mesh)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        from repro_torch.dist.collectives import destroy_process_group
        destroy_process_group()


def spawn_group(mesh: str, world: int, out_dir: str) -> None:
    """Run ``world`` ranks of ``mesh`` to their end."""
    import torch.multiprocessing as mp
    init_file = os.path.join(out_dir, "rendezvous")
    mp.spawn(run_group, args=(world, init_file, mesh, out_dir),
             nprocs=world, join=True)
