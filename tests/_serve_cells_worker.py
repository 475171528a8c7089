"""The ranks of the partitioned serving program's tests
(``test_torch_serve_cells.py``).

One process a rank of a gloo group on the CPU (``torch.multiprocessing``
with a ``file://`` rendezvous), spawned once per mesh.  Each rank runs
every case of its mesh: ``launch.cells.serve_program``'s prefill of
seeded prompts, then greedy decode steps, from params drawn with
``np.random.default_rng`` (``_train_mesh_worker.draw_params``), against
one device's ``Model.prefill`` and ``Model.decode_step`` on the same
params and prompts, computed in the rank itself.  Given the reference
oracle's files (:data:`ORACLE_SCRIPT`), it also runs the reference's
params, prompts and tokens through the program.  What it saw goes to
``<out>/<rank>.json``.  Imports neither jax nor the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import textwrap

import numpy as np
import torch

import _train_mesh_worker as TW

ARCHS = TW.ARCHS
#: rows, prompt tokens, cache positions, decode steps.
B, PROMPT, MAX_LEN, STEPS = 4, 12, 16, 3
#: qwen2.5-14b SMOKE split unevenly over four ranks: head ranges of 2,
#: 1, 2, 1 over 2 KV heads (each KV head read by two ranks), vocab rows
#: and MLP columns in ranges of unequal size.
UNEVEN = TW.UNEVEN


def _case(mesh, arch, over=None, dtype="float32", max_len=MAX_LEN):
    return (mesh, arch, over or {}, dtype, max_len)


#: name -> (mesh, arch, config overrides, dtype, cache positions).
CASES = {
    **{f"model2/{a}": _case("model=2", a) for a in ARCHS},
    # mixtral-8x22b's router has a near-tie on these weights that the
    # split's rounding flips at bf16 (its f32 cases hold it)
    **{f"model2_bf16/{a}": _case("model=2", a, dtype="bfloat16")
       for a in ARCHS if a != "mixtral-8x22b"},
    "model2_tp/qwen2.5-14b": _case("model=2", "qwen2.5-14b",
                                   {"tp_psum": True}),
    # the new token written only on the rank whose part holds its slot
    "model2_scatter/qwen2.5-14b": _case("model=2", "qwen2.5-14b",
                                        {"cache_update": "scatter"}),
    # 15 positions do not split over model=2: the self cache's heads do
    "model2_heads/whisper-base": _case("model=2", "whisper-base",
                                       max_len=15),
    **{f"data2model2/{a}": _case("data=2,model=2", a) for a in ARCHS},
    "data2model2_tp/qwen2.5-14b": _case("data=2,model=2", "qwen2.5-14b",
                                        {"tp_psum": True}),
    # the KV heads' all-to-all into each rank's part of the positions
    "model4_uneven/qwen2.5-14b": _case("model=4", "qwen2.5-14b", UNEVEN),
    # 18 positions do not split over model=4 (nor do 2 KV heads): the
    # cache is whole on every rank, attended with the rank's own heads
    "model4_uneven_whole/qwen2.5-14b": _case("model=4", "qwen2.5-14b",
                                             UNEVEN, max_len=18),
}
GROUPS = {"model=2": 2, "data=2,model=2": 4, "model=4": 4}


def config(arch, over, dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                               **over)


def prompts(cfg, seed=1):
    """Seeded prompts (B, PROMPT) and the family's extra input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def one_device(model, params, batch, max_len, steps=STEPS, tokens=None,
               parts=1):
    """One device's prefill then ``steps`` decode steps: [logits (B, V) of
    each], the greedy tokens fed (or ``tokens``, one (B,) array a
    step), the cache after.  ``parts``: the rows run as that many equal
    parts, one after another (a MoE on a mesh with ``model`` routes each
    ``batch`` part's rows alone, its capacity theirs, as the reference's
    expert-parallel ``shard_map`` does), the results concatenated."""
    if parts > 1:
        n = batch["tokens"].shape[0] // parts
        runs = [one_device(model, params, {k: v[i * n:(i + 1) * n]
                                           for k, v in batch.items()},
                           max_len, steps,
                           None if tokens is None else
                           [t[i * n:(i + 1) * n] for t in tokens])
                for i in range(parts)]
        rows = {k: ax.index("batch")
                for k, ax in model.cache_axes().items()}
        return ([torch.cat(x) for x in zip(*(r[0] for r in runs))],
                [torch.cat(x) for x in zip(*(r[1] for r in runs))],
                {k: torch.cat([r[2][k] for r in runs], rows[k])
                 for k in rows})
    rows = batch["tokens"].shape[0]
    with torch.no_grad():
        cache = model.init_cache(rows, max_len, "cpu")
        logits, cache = model.prefill(params, _tensors(batch), cache)
        out, fed = [logits[:, -1].float()], []
        for i in range(steps):
            t = out[-1].argmax(-1) if tokens is None else \
                torch.as_tensor(tokens[i])
            fed.append(t)
            logits, cache = model.decode_step(params, cache,
                                              t[:, None].int())
            out.append(logits[:, -1].float())
    return out, fed, cache


def program_run(prog, params, batch, max_len, steps=STEPS, tokens=None):
    """The same through the rank's program: the gathered logits of each
    step, the tokens fed, the gathered cache."""
    cache = prog.init_cache(B, max_len)
    logits, cache = prog.prefill(params, prog.local_batch(_tensors(batch)),
                                 cache)
    out, fed = [prog.gather_logits(logits, B)[:, -1].float()], []
    for i in range(steps):
        t = out[-1].argmax(-1) if tokens is None else \
            torch.as_tensor(tokens[i])
        fed.append(t)
        lo, hi = prog.rows(B)
        logits, cache = prog.decode(params, cache, t[lo:hi, None].int())
        out.append(prog.gather_logits(logits, B)[:, -1].float())
    return out, fed, prog.gather_cache(cache, B, max_len)


def _err(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def placed_param_bytes(prog) -> int:
    """The bytes of a rank's params under the reference's placement."""
    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.cells import placed_bytes
    from repro_torch.models.common import tree_flatten
    whole = prog.model.init(0, "meta")
    specs = dict(tree_flatten(placements(prog.live, prog.model.param_axes(),
                                         whole)))
    return sum(placed_bytes(prog.live, t, specs[p])
               for p, t in tree_flatten(whole))


def _route_parts(cfg, live) -> int:
    """The row parts a MoE routes alone on ``live`` (1 elsewhere)."""
    from repro_torch.distributed.sharding import BATCH_AXES
    if not cfg.n_experts or "model" not in live.spec.names:
        return 1
    return live.split(BATCH_AXES)[0]


def run_case(name, live):
    from repro_torch.launch.cells import serve_program
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves
    _, arch, over, dtype, max_len = CASES[name]
    cfg = config(arch, over, dtype)
    model = get_model(cfg)
    whole = TW.draw_params(model)
    batch = prompts(cfg)
    want, want_tok, want_cache = one_device(model, whole, batch, max_len,
                                            parts=_route_parts(cfg, live))
    prog = serve_program(cfg, live, device="cpu")
    params = prog.shard_params(whole)
    # at bf16 a near-tie of the greedy choice may fall either way on
    # random weights: the program is fed one device's tokens
    fed = None if dtype == "float32" else [t.numpy() for t in want_tok]
    got, got_tok, got_cache = program_run(prog, params, batch, max_len,
                                          tokens=fed)
    return {
        "logits_err": [_err(g, w) for g, w in zip(got, want)],
        "cache_err": {k: _err(got_cache[k], want_cache[k])
                      for k in want_cache},
        "cache_shapes_equal": all(
            tuple(got_cache[k].shape) == tuple(want_cache[k].shape)
            for k in want_cache),
        "tokens_equal": all(torch.equal(g, w)
                            for g, w in zip(got_tok, want_tok)),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(params)),
        "placed_param_bytes": placed_param_bytes(prog),
        "dtype": dtype,
        # the leaves gathered as this rank's range of the ranks' parts
        "spans": sorted(p for p, plan in prog.plans[0].items()
                        if plan.span is not None),
    }


def run_group(rank: int, world: int, init_file: str, mesh: str,
              out_dir: str, names, oracle=None) -> None:
    """One rank: every case of ``names`` on ``mesh`` and, given the
    oracle's files ``{arch: path}``, the reference's runs."""
    import torch.distributed as dist
    from repro_torch.dist import MeshSpec
    from repro_torch.dist.collectives import LiveMesh, destroy_process_group
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        live = LiveMesh(MeshSpec.parse(mesh), torch.device("cpu"))
        results = {name: run_case(name, live) for name in names}
        for arch, path in (oracle or {}).items():
            results[f"oracle/{arch}"] = run_oracle(arch, path, live)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        destroy_process_group()


def spawn_group(mesh: str, world: int, out_dir: str, names,
                oracle=None) -> None:
    """Run ``world`` ranks of ``mesh`` over ``names`` to their end."""
    import torch.multiprocessing as mp
    init_file = os.path.join(out_dir, "rendezvous")
    mp.spawn(run_group, args=(world, init_file, mesh, out_dir, list(names),
                              oracle), nprocs=world, join=True)


#: The reference oracle: the SMOKE configs at f32 whose compiled
#: ``lower_cell`` prefill and decode programs the port's program is held
#: to, on data=2,model=2, with a cache of ORACLE_LEN positions filled by
#: a prompt as long (the decode steps wrap the ring).
ORACLE_ARCHS = ("qwen2.5-14b", "mixtral-8x22b", "whisper-base")
ORACLE_MESH = "data=2,model=2"
ORACLE_LEN = 16

#: The reference's own prefill and decode cells (``repro.launch.cells.
#: lower_cell``), compiled on 4 host devices and run: argv is the output
#: directory then the archs.  The mesh is built with Auto axes, as
#: ``_train_mesh_worker.ORACLE_SCRIPT`` builds it.
ORACLE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    sys.path.insert(0, "src")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import ShapeSpec, get_config
    from repro.configs.base import input_specs
    from repro.launch import cells
    from repro.models import get_model
    from repro.distributed import sharding as shd

    B, S, STEPS = 4, 16, 3
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for arch in sys.argv[2:]:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        m = get_model(cfg)
        pre = cells.lower_cell(cfg, ShapeSpec("t", S, B, "prefill"),
                               mesh).compile()
        dec = cells.lower_cell(cfg, ShapeSpec("t", S, B, "decode"),
                               mesh).compile()
        with shd.use_mesh(mesh):
            params = m.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        batch = {}
        for k, v in input_specs(cfg, ShapeSpec("t", S, B,
                                               "prefill")).items():
            if k == "tokens":
                batch[k] = rng.integers(0, cfg.vocab, v.shape).astype(
                    np.int32)
            else:
                batch[k] = np.asarray(jnp.asarray(rng.standard_normal(
                    v.shape), v.dtype).astype(jnp.float32))
        cache = m.init_cache(B, S)
        args = jax.device_put(
            (params, {k: jnp.asarray(v, s.dtype) for (k, v), s in zip(
                batch.items(), input_specs(cfg, ShapeSpec(
                    "t", S, B, "prefill")).values())}, cache),
            pre.input_shardings[0])
        logits, cache = pre(*args)
        out, fed = [np.asarray(logits[:, -1], np.float32)], []
        for _ in range(STEPS):
            tok = np.argmax(out[-1], -1).astype(np.int32)
            fed.append(tok)
            p, c, t = jax.device_put((params, cache, jnp.asarray(
                tok[:, None])), dec.input_shardings[0])
            logits, cache = dec(p, c, t)
            out.append(np.asarray(logits[:, -1], np.float32))
        flat = {"params/" + "/".join(str(k.key) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        np.savez(os.path.join(sys.argv[1], arch + ".npz"),
                 logits=np.stack(out), tokens=np.stack(fed),
                 **{"batch/" + k: v for k, v in batch.items()}, **flat)
    print("ORACLE_OK")
""")


def reference_oracle(out_dir: str, root: str, archs=ORACLE_ARCHS):
    """Run :data:`ORACLE_SCRIPT` for ``archs`` in a subprocess; {arch: the
    file of its params, prompts, tokens and logits}."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", ORACLE_SCRIPT, out_dir,
                          *archs], capture_output=True, text=True, cwd=root,
                         timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert "ORACLE_OK" in out.stdout, out.stdout + out.stderr[-5000:]
    return {a: os.path.join(out_dir, a + ".npz") for a in archs}


def run_oracle(arch, path, live):
    """The program on the reference's params and prompts, fed the
    reference's tokens: its gathered logits' error against the
    reference's at each step, and one device's."""
    from repro_torch.launch.cells import serve_program
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_unflatten
    from repro_torch.weights import params_from_reference
    with np.load(path) as z:
        keys = [k for k in z.files if k.startswith("params/")]
        whole = params_from_reference(tree_unflatten(
            [k[len("params/"):] for k in keys], [z[k] for k in keys]))
        batch = {k[len("batch/"):]: z[k] for k in z.files
                 if k.startswith("batch/")}
        want, tokens = z["logits"], z["tokens"]
    cfg = config(arch, {}, "float32")
    prog = serve_program(cfg, live, device="cpu")
    got, _, _ = program_run(prog, prog.shard_params(whole), batch,
                            ORACLE_LEN, len(tokens), tokens)
    one, _, _ = one_device(get_model(cfg), whole, batch, ORACLE_LEN,
                           len(tokens), tokens, _route_parts(cfg, live))
    return {"logits_err": [_err(g, torch.as_tensor(w))
                           for g, w in zip(got, want)],
            "one_device_err": [_err(g, torch.as_tensor(w))
                               for g, w in zip(one, want)]}
