"""The reference's placement of the train state on a mesh, in the port's
mesh train step: every param leaf and both its AdamW moments held in
part over ``fsdp`` (``data``) and ``model``, gathered at use, the
gradients reduced and cut to the rank's part.

* **placement**: for each of the ten SMOKE configs on ``data=2``,
  ``model=2`` and ``data=2,model=2``, every state leaf's partition spec
  (``StateLayout.specs``, per dim, per mesh axis) is the one the
  reference's own jitted mesh step gives its output state
  (``out.sharding.spec`` of ``jax.eval_shape`` of
  ``repro.training.make_jitted_train_step`` on an Auto-axes CPU mesh, in
  a subprocess: ``PLACEMENT_SCRIPT``);
* **bytes**: on every rank of those meshes (fake groups,
  ``cells.dry_group``) the bytes of ``init_state(..., mesh=)`` equal,
  as integers, the bytes of the whole state's leaves under
  ``cells.placements``;
* **steps**: gloo groups of 2 and 4 ranks (``tests/_train_mesh_worker.py``,
  ``PLACEMENT_CASES``) run three partitioned steps with
  ``microbatches=2``, ``compress_grads`` (its accumulator and error
  feedback part-sized, of the global gradients), ``cast_params`` and
  ``cast_params`` + ``pregather_params`` on ``data=2``, ``model=2``
  (``tp_psum``) and ``data=2,model=2``, each against the one-device
  computation of the step: loss within 1e-5 x max(1, |loss|), each
  gradient part within 1e-4 x max(1, max|g|), ``grad_norm`` within 1e-5
  relative; the replicas of each part bit-equal and the state gathered
  whole bit-equal to the replicated layout's (AdamW on the whole state
  with the whole reduced gradients).  Where the gradients are rounded
  to bf16 (``cast_params``, ``compress_grads``) on a mesh whose compute
  splits over ``model``, a split sum in another order can round a value
  the other way (one bf16 ulp), so their gradient parts are held, under
  the same limit, to the same mesh's step on the whole (replicated)
  state, which rounds at the same points
  (``_train_mesh_worker.rounds_split_grads``), and to one device's
  within one bf16 ulp at each leaf's largest magnitude
  (``_train_mesh_worker.bf16_ulps``); their loss and ``grad_norm`` to
  one device under the limits above;
* **checkpoint**: a ``data=2,model=2`` save of a partitioned state is
  byte-equal to one device's save of the gathered state, restores
  bit-equal on one device, on each rank, on ``model=2`` (another mesh)
  and in the reference (``repro.checkpoint.Checkpointer``);
* **the reference's steps**: its jitted mesh step on ``data=2,model=2``
  (``_train_mesh_worker.ORACLE_SCRIPT``) with ``compress_grads`` and with
  ``cast_params`` + ``pregather_params``, both at ``microbatches=2``: the
  port's partitioned step from the same params gives its 3 losses
  within the limits of ``test_torch_train_mesh_model.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import _train_mesh_worker as W
from test_torch_train_mesh import (check_against_one_device, check_oracle,
                                   check_replicas_bit_equal)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("data=2", "model=2", "data=2,model=2")
ORACLE_CASES = ("qwen2.5-14b:compress_grads",
                "mixtral-8x22b:cast_params+pregather_params")

#: The reference's state placement: argv is an output file; for each
#: mesh of MESHES and each SMOKE config, the partition spec of every leaf
#: of the output state of its jitted mesh step (an entry per dim: None,
#: an axis, or a list of axes), keyed ``mesh|arch`` then
#: ``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``.
PLACEMENT_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    sys.path.insert(0, "src")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import get_model
    from repro.training import TrainConfig, init_state, \\
        make_jitted_train_step
    from repro.distributed import sharding as shd

    MESHES = {"data=2": ((2,), ("data",)), "model=2": ((2,), ("model",)),
              "data=2,model=2": ((2, 2), ("data", "model"))}
    ARCHS = %r
    out = {}
    for name, (shape, axes) in MESHES.items():
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(axes))
        for arch in ARCHS:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            m = get_model(cfg)
            b, s = 4, 16 + (cfg.num_image_tokens or 0)
            batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
            if cfg.family == "vlm":
                batch["patches"] = jax.ShapeDtypeStruct(
                    (b, cfg.num_image_tokens, cfg.vit_dim), jnp.float32)
            if cfg.family == "audio":
                batch["frames"] = jax.ShapeDtypeStruct(
                    (b, cfg.n_frames, cfg.d_model), jnp.float32)
            with shd.use_mesh(mesh):
                state = jax.eval_shape(
                    lambda: init_state(m, jax.random.PRNGKey(0)))
                step = make_jitted_train_step(m, TrainConfig(), mesh=mesh,
                                              donate=False)
                new, _ = jax.eval_shape(step, state, batch)
            specs = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
                key = "/".join(str(k.key) for k in path)
                spec = list(leaf.sharding.spec)
                spec += [None] * (len(leaf.shape) - len(spec))
                specs[key] = [list(e) if isinstance(e, tuple) else e
                              for e in spec]
            out[f"{name}|{arch}"] = specs
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("PLACEMENT_OK")
""") % (W.ARCHS,)


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("placement") / "specs.json")
    out = subprocess.run([sys.executable, "-c", PLACEMENT_SCRIPT, path],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert "PLACEMENT_OK" in out.stdout, out.stdout + out.stderr
    with open(path) as f:
        return json.load(f)


def _listed(spec):
    """A partition spec as the oracle writes it: an entry per dim, an
    axis tuple as a list (one axis alone as its name)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _model(arch):
    from repro_torch.models import get_model
    return get_model(W.config(arch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", W.ARCHS)
def test_state_placement_is_the_reference_steps(reference_specs, arch,
                                                mesh):
    from repro_torch.launch import cells
    from repro_torch.training.train import StateLayout
    with cells.dry_group(mesh, 0, "cpu") as live:
        layout = StateLayout(_model(arch), live)
    shapes = {p: len(s) for p, s in layout.shapes.items()}
    got = {}
    for path, spec in layout.specs.items():
        head = 1 if path.startswith("params/") else 2
        ndim = shapes.get(path.split("/", head)[-1], 0)
        got[path] = _listed(tuple(spec) + (None,) * (ndim - len(spec)))
    assert got == reference_specs[f"{mesh}|{arch}"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", W.ARCHS)
def test_rank_state_bytes_are_the_placed_bytes(arch, mesh):
    from repro_torch.dist import MeshSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.models.common import tree_flatten, tree_leaves
    from repro_torch.training import init_state, state_axes
    model = _model(arch)
    whole = init_state(model, 0, "meta")
    for rank in range(MeshSpec.parse(mesh).size):
        with cells.dry_group(mesh, rank, "cpu") as live:
            held = sum(t.numel() * t.element_size() for t in tree_leaves(
                init_state(model, 0, "meta", mesh=live)))
            with shd.use_mesh(live):
                axes = state_axes(model)
            specs = dict(tree_flatten(cells.placements(live, axes, whole)))
            placed = sum(cells.placed_bytes(live, t, specs[p])
                         for p, t in tree_flatten(whole))
        whole_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(whole))
        assert held == placed and held < whole_bytes, (rank, held, placed)


NAMES = {m: [n for n, c in W.PLACEMENT_CASES.items() if c[0] == m]
         for m in MESHES}
CASES = [(m, n) for m, names in NAMES.items() for n in names]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return W.reference_oracle("data=2,model=2",
                              str(tmp_path_factory.mktemp("oracle")), ROOT,
                              ORACLE_CASES)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, oracle):
    """Each mesh's ranks over its cases; ``data=2,model=2`` first, its
    partitioned checkpoint then restored on ``model=2``."""
    out, saved = {}, None
    for mesh in ("data=2,model=2", "model=2", "data=2"):
        names = list(NAMES[mesh])
        if mesh == "data=2,model=2":
            names.append("ck_save")
        elif mesh == "model=2":
            names.append(f"ck_restore={saved}")
        d = tmp_path_factory.mktemp(mesh.replace(",", "_").replace("=", ""))
        W.spawn_group(mesh, W.GROUPS[mesh], str(d), names,
                      oracle if mesh == "data=2,model=2" else None)
        out[mesh] = [json.load(open(d / f"{r}.json"))
                     for r in range(W.GROUPS[mesh])]
        saved = saved or out[mesh][0]["ck_save"]["dir"]
    return out


@pytest.mark.parametrize("mesh,name", CASES)
def test_partitioned_step_matches_one_device(groups, mesh, name):
    for res in groups[mesh]:
        check_against_one_device(res[name])


@pytest.mark.parametrize("mesh,name", CASES)
def test_partitioned_replicas_bit_equal(groups, mesh, name):
    check_replicas_bit_equal([res[name] for res in groups[mesh]])


@pytest.mark.parametrize("mesh,name", CASES)
def test_every_rank_holds_a_part(groups, mesh, name):
    """Each rank holds less than the whole of its state: its part of
    every leaf the placement cuts, over each of the mesh's axes."""
    for res in groups[mesh]:
        axes = {a for v in res[name]["cut_axes"].values() for a in v}
        assert res[name]["parts"] and axes == {
            a.split("=")[0] for a in mesh.split(",")}


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_reference_mesh_step_losses(groups, case):
    for res in groups["data=2,model=2"]:
        check_oracle(res[f"oracle/{case}"])


@pytest.mark.parametrize("check", ["byte_equal", "one_device_equal",
                                   "rank_equal", "other_mesh_equal"])
def test_partitioned_checkpoint(groups, check):
    """A ``data=2,model=2`` save of a state held in part: byte-equal to
    one device's save of the gathered state; restored whole on one
    device, in part on each rank, and in part on ``model=2`` (another
    mesh's layout), bit-equal."""
    if check == "other_mesh_equal":
        ranks = [res[k] for res in groups["model=2"] for k in res
                 if k.startswith("ck_restore=")]
        assert len(ranks) == 2 and all(r["rank_equal"] and r["parts"]
                                       for r in ranks)
        return
    ranks = [res["ck_save"] for res in groups["data=2,model=2"]]
    assert all(r["parts"] for r in ranks)
    have = [r[check] for r in ranks if check in r]
    assert have and all(have), (check, have)


def test_reference_restores_partitioned_checkpoint(groups):
    """The reference's checkpointer restores the ``data=2,model=2`` save
    into its own state's structure, every leaf bit-equal to the port's
    one-device restore."""
    import dataclasses
    import jax
    import numpy as np
    from repro.checkpoint import Checkpointer as RefCheckpointer
    from repro.configs import get_config
    from repro.models import get_model
    from repro.training import init_state
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import init_state as port_init
    from repro_torch.weights import state_to_numpy
    path = groups["data=2,model=2"][0]["ck_save"]["dir"]
    cfg = dataclasses.replace(get_config(W.CK_ARCH, smoke=True),
                              dtype="float32")
    like = jax.eval_shape(lambda: init_state(get_model(cfg),
                                             jax.random.PRNGKey(0)))
    ref = jax.tree.leaves(RefCheckpointer(path).restore(W.CK_STEP, like))
    port = tree_leaves(Checkpointer(path).restore(
        W.CK_STEP, port_init(_model(W.CK_ARCH), 0, "cpu")))
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a, b = np.asarray(a), state_to_numpy(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
