"""The models' logical-axis trees and placements against the reference,
and how the expert-parallel MoE cuts its weights.

``Model.param_axes()`` and ``Model.cache_axes()`` of all ten configs
(SMOKE and published) equal the reference's leaf by leaf, and every axes
tuple has its leaf's rank (the port's param and cache trees on the meta
device).  ``named_sharding(mesh, *axes).spec`` equals the reference's
on ``data=2,model=2`` and ``pod=2,data=2,model=2`` (the reference's on an
``AbstractMesh``, which needs no devices); the MoE's axes follow the
active mesh's ``model`` size (EP or TP) as the reference's do.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.distributed import sharding as ref_shd
from repro.models import get_model as ref_model
from repro.models import moe as ref_moe
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist import MeshSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import common as C
from repro_torch.models import get_model, moe

MESHES = ("data=2,model=2", "pod=2,data=2,model=2")
AXES = (("batch", "seq", "embed"), ("batch", "seq", "heads", None),
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        ("fsdp", "mlp"), ("vocab", "fsdp"), ("experts", "fsdp", None),
        ("batch", "kv_seq"), (None,))


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {"/".join(str(k.key) for k in path): v for path, v in leaves}


def _abstract(spec: MeshSpec):
    return AbstractMesh(spec.shape, spec.names)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_axes_equal_reference_leaf_by_leaf(arch, smoke):
    m = get_model(get_config(arch, smoke=smoke))
    axes = dict(C.tree_flatten(m.param_axes()))
    assert axes == _ref_flat(ref_model(ref_config(arch, smoke=smoke))
                             .param_axes())
    params = dict(C.tree_flatten(m.init(0, "meta")))
    assert set(axes) == set(params)
    assert {k: len(v) for k, v in axes.items()} == \
        {k: t.ndim for k, t in params.items()}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_axes_equal_reference_leaf_by_leaf(arch, smoke):
    m = get_model(get_config(arch, smoke=smoke))
    axes = m.cache_axes()
    assert axes == ref_model(ref_config(arch, smoke=smoke)).cache_axes()
    cache = dict(C.tree_flatten(m.init_cache(2, 64, "meta")))
    assert set(axes) == set(cache)
    assert {k: len(v) for k, v in axes.items()} == \
        {k: t.ndim for k, t in cache.items()}


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("mesh", MESHES)
def test_named_sharding_spec_equals_reference(mesh, axes):
    spec = MeshSpec.parse(mesh)
    got = shd.named_sharding(spec, *axes)
    want = ref_shd.named_sharding(_abstract(spec), *axes).spec
    assert got.mesh is spec
    assert got.spec == tuple(want)


@pytest.mark.parametrize("mesh", ["model=16", "data=2,model=4"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b"])
def test_moe_axes_follow_the_model_axis(monkeypatch, arch, mesh):
    """EP (the model axis divides the experts) shards the expert dim;
    otherwise (mixtral's 8 experts on 16) the hidden width."""
    spec = MeshSpec.parse(mesh)
    monkeypatch.setattr(ref_moe, "current_mesh", lambda: _abstract(spec))
    want = ref_moe.moe_axes(ref_config(arch))
    with shd.use_mesh(spec):
        assert moe.moe_axes(get_config(arch)) == want
    ep = get_config(arch).n_experts % spec.axis_size("model") == 0
    assert want["wi_gate"][0] == ("experts" if ep else None)


def test_logical_is_placement_only_on_a_mesh():
    import torch
    x = torch.ones(4, 4)
    with shd.use_mesh(MeshSpec.parse("data=2,model=2")):
        assert shd.logical(x, "batch", "embed") is x


class _Split:
    """A stand-in for a live mesh's ``split``: ``k`` parts over
    ``model``, this rank's part ``i``, nothing over the batch axes."""

    def __init__(self, k, i):
        self.k, self.i = k, i

    def split(self, axes):
        return (self.k, self.i) if "model" in axes else (1, 0)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("arch,changes,dims", [
    ("mixtral-8x22b", {}, "experts"),             # EP: 4 and 4 experts
    ("mixtral-8x22b", {"n_experts": 1, "top_k": 1}, "mlp"),   # TP
])
def test_local_experts_cut_the_stacked_weights(arch, changes, dims, rank):
    """A rank keeps its experts (EP) or its half of every expert's hidden
    width (TP), from the whole (L, E, ...) leaves or a single layer's; a
    weight already cut is kept as it is."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    ffn = get_model(cfg).init(0, "cpu")["layers"]["ffn"]
    part = moe.local_experts(ffn, cfg, _Split(2, rank))
    e, f = cfg.n_experts, cfg.moe_d_ff
    for name, e_dim, f_dim in (("wi_gate", 1, 3), ("wi_up", 1, 3),
                               ("wo", 1, 2)):
        whole, got = ffn[name], part[name]
        dim, n = (e_dim, e) if dims == "experts" else (f_dim, f)
        assert got.shape[dim] == n // 2
        assert torch.equal(got, whole.narrow(dim, rank * n // 2, n // 2))
    assert part["router"] is ffn["router"]
    again = moe.local_experts(part, cfg, _Split(2, rank))
    assert all(again[n] is part[n] for n in part)
    layer = moe.local_experts({k: v[0] for k, v in ffn.items()}, cfg,
                              _Split(2, rank))
    assert torch.equal(layer["wo"], part["wo"][0])


def test_moe_rejects_a_model_axis_that_fits_neither_mode():
    cfg = get_config("mixtral-8x22b", smoke=True)        # 4 experts
    with pytest.raises(ValueError, match="incompatible with model axis 3"):
        moe.local_experts({}, cfg, _Split(3, 0))
    assert moe.local_experts({"x": 1}, cfg, _Split(1, 0)) == {"x": 1}

