"""The dry-run's placement rules and model FLOPs against the reference.

``repro_torch.launch.cells.divisible_placement`` and its kin must give,
leaf for leaf, the partition spec the reference's ``_divisible_sharding``
/ ``_batch_sharding`` / ``_cache_sharding`` give on the two production
meshes (16x16 and 2x16x16), for the params, the AdamW state, the
decode_32k and long_500k caches and the inputs of every shape of the ten
published configs; and ``model_flops`` must equal the reference's
exactly (which holds the two ``active_param_count``s to each other).
The reference runs once, in a subprocess with 512 host devices, on
``jax.eval_shape`` only (nothing compiled).  Also: the fake group's
lifetime.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, get_config, \
    input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.models import get_model
from repro_torch.models.common import tree_flatten
from repro_torch.training.optim import adamw_init, opt_state_axes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ORACLE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    import jax
    from repro.configs import ARCH_NAMES, SHAPES, get_config, input_specs
    from repro.distributed import sharding as shd
    from repro.launch import cells
    from repro.launch.mesh import make_production_mesh
    from repro.models import get_model
    from repro.training.optim import adamw_init, opt_state_axes

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = []
            for k in sorted(tree):
                out += flat(tree[k], prefix + k + "/")
            return out
        return [(prefix[:-1], tree)]

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    out = {"placement": {}, "model_flops": {}}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            model = get_model(cfg)
            rec = {}
            with shd.use_mesh(mesh):
                p_axes = model.param_axes()
                p = cells._specs(jax.eval_shape(
                    lambda: model.init(jax.random.PRNGKey(0))))
                o = cells._specs(jax.eval_shape(lambda: adamw_init(p)))
                axes = dict(flat({"params": p_axes,
                                  "opt": opt_state_axes(p_axes)}))
                for path, leaf in flat({"params": p, "opt": o}):
                    rec[path] = spec(cells._divisible_sharding(
                        mesh, leaf, axes[path]))
                c_axes = model.cache_axes()
                for name in ("decode_32k", "long_500k"):
                    shape = SHAPES[name]
                    c = cells._specs(jax.eval_shape(lambda: model.init_cache(
                        shape.global_batch, shape.seq_len)))
                    for k in c:
                        rec[f"cache_{name}/{k}"] = spec(
                            cells._divisible_sharding(mesh, c[k], c_axes[k]))
                        rec[f"cache_fixed_{name}/{k}"] = spec(
                            cells._cache_sharding(mesh, c[k], c_axes[k]))
                for name, shape in SHAPES.items():
                    for k, v in cells._batch_sharding(
                            mesh, input_specs(cfg, shape)).items():
                        rec[f"inputs_{name}/{k}"] = spec(v)
            out["placement"][f"{kind}|{arch}"] = rec
            for name, shape in SHAPES.items():
                out["model_flops"][f"{arch}|{name}"] = \\
                    cells.model_flops(cfg, shape)
            smoke = get_config(arch, smoke=True)
            for kind_ in ("train", "prefill", "decode"):
                from repro.configs import ShapeSpec
                out["model_flops"][f"{arch}-smoke|{kind_}"] = \\
                    cells.model_flops(smoke, ShapeSpec("t", 64, 8, kind_))
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "oracle.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _ORACLE, str(path)], cwd=ROOT,
                   env=env, check=True, timeout=300)
    return json.loads(path.read_text())


def _listed(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_placements(arch, multi):
    spec = production_mesh_spec(multi_pod=multi)
    cfg = get_config(arch)
    model = get_model(cfg)
    rec = {}
    with shd.use_mesh(spec):
        p_axes = model.param_axes()
        params = model.init(0, "meta")
        axes = dict(tree_flatten({"params": p_axes,
                                  "opt": opt_state_axes(p_axes)}))
        for path, leaf in tree_flatten({"params": params,
                                        "opt": adamw_init(params)}):
            rec[path] = _listed(cells.divisible_placement(
                spec, tuple(leaf.shape), axes[path]))
        c_axes = model.cache_axes()
        for name in ("decode_32k", "long_500k"):
            shape = SHAPES[name]
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     "meta")
            for k, leaf in cache.items():
                rec[f"cache_{name}/{k}"] = _listed(cells.divisible_placement(
                    spec, tuple(leaf.shape), c_axes[k]))
                rec[f"cache_fixed_{name}/{k}"] = _listed(
                    cells.cache_placement(spec, tuple(leaf.shape), c_axes[k]))
        for name, shape in SHAPES.items():
            for k, v in cells.batch_placement(
                    spec, input_specs(cfg, shape)).items():
                rec[f"inputs_{name}/{k}"] = _listed(v)
    return rec


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_divisible_placement_equals_reference(oracle, arch, multi):
    want = oracle["placement"][f"{'multi' if multi else 'single'}|{arch}"]
    got = _port_placements(arch, multi)
    assert set(got) == set(want)
    wrong = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not wrong, wrong


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equals_reference(oracle, arch):
    for name, shape in SHAPES.items():
        assert cells.model_flops(get_config(arch), shape) == \
            oracle["model_flops"][f"{arch}|{name}"], name
    smoke = get_config(arch, smoke=True)
    for kind in ("train", "prefill", "decode"):
        assert cells.model_flops(smoke, ShapeSpec("t", 64, 8, kind)) == \
            oracle["model_flops"][f"{arch}-smoke|{kind}"], kind


def test_divisible_placement_fallback():
    """The reference's ``test_divisible_sharding_fallback``: axes of size
    1 are dropped entirely (no >1 divisor)."""
    from repro_torch.dist import MeshSpec
    mesh = MeshSpec(axes=(("data", 1), ("model", 1)))
    with shd.use_mesh(mesh):
        assert cells.divisible_placement(mesh, (7, 16),
                                         ("vocab", "fsdp")) == (None, None)


def test_divisible_placement_keeps_what_divides():
    """vocab=122753 stays whole on a 16-way axis; a dim divisible by the
    whole (pod, data) tuple takes both; one axis serves one dim."""
    spec = production_mesh_spec(multi_pod=True)
    with shd.use_mesh(spec):
        assert cells.divisible_placement(spec, (122753, 2304),
                                         ("vocab", "fsdp")) == (None, "data")
        assert cells.divisible_placement(spec, (256, 4096),
                                         ("batch", None)) == \
            (("pod", "data"), None)
        assert cells.divisible_placement(spec, (2, 4096),
                                         ("batch", None)) == ("pod", None)
        assert cells.divisible_placement(spec, (64, 64),
                                         ("heads", "kv_heads")) == \
            ("model", None)


def test_dry_group_is_the_only_group():
    """The fake group refuses to sit beside another group, is destroyed
    on exit, and puts this process at the rank asked for."""
    import torch.distributed as dist
    spec = production_mesh_spec(multi_pod=True)
    with cells.dry_group(spec, rank=300, device="cpu") as live:
        assert dist.get_world_size() == 512 and dist.get_rank() == 300
        assert live.coords == {"pod": 1, "data": 2, "model": 12}
        assert not live.stages("cuda")        # the fake group is NCCL's
        with pytest.raises(RuntimeError, match="only one"):
            with cells.dry_group("data=2", device="cpu"):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank"):
        with cells.dry_group("data=2", rank=2, device="cpu"):
            pass
    assert not dist.is_initialized()
