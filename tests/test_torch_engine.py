"""The port's ``engine`` target, configs and load-time helpers against the
JAX package's, on the CPU.

* ``repro_torch.compile`` routes an ``ArchConfig``/``Model`` to
  ``target="engine"`` and raises the reference's ``TypeError`` and
  ``ValueError`` otherwise; the default device needs CUDA;
* ``precision="bf16"``: the reference's ``quant_report`` and
  ``cost_summary()``;
* ``serialize``/``deserialize`` bit-equal, a leaf-count mismatch raises;
* ``fold_norms`` gives the reference's folded leaves and keeps the
  logits, and its per-layer scaling equals the whole-tensor product;
* ``param_count`` of the seven transformer-family configs at their
  published widths (meta device, nothing allocated);
* the SSM, hybrid and audio families (ported after the others) build,
  count and compile (their parity is ``test_torch_families.py``); the
  loss is in (A.15a) and the mesh train step (A.15b) refuses a mesh its
  process group cannot fill with ``MeshUnavailableError``; ``serve()``
  returns a scheduler and the deprecated ``Engine`` delegates to one
  (the scheduler's parity is ``test_torch_serve.py``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
import repro_torch
from repro.configs import get_config as ref_config
from repro.inference import fold_norms as ref_fold_norms
from repro.models import get_model as ref_model
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.inference import Engine, fold_norms
from repro_torch.models import common as PC
from repro_torch.models import get_model
from repro_torch.weights import params_from_reference

ARCHS = ["qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b"]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _engine(cfg, **kw):
    kw.setdefault("device", "cpu")
    return repro_torch.compile(cfg, target="engine", **kw)


@pytest.fixture(scope="module")
def qwen():
    rcfg = ref_config("qwen2.5-14b", smoke=True)
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, rp, params_from_reference(jax.tree.map(np.asarray, rp))


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
def test_configs_copied_field_for_field():
    from repro.configs import ARCH_NAMES as REF_NAMES
    assert ARCH_NAMES == REF_NAMES
    for arch in ARCH_NAMES:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(ref_config(arch, smoke)), (arch, smoke)


def test_shapes_and_input_specs_match_reference():
    from repro.configs import base as rbase
    from repro_torch.configs import base as pbase
    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    assert pbase.LONG_CONTEXT_OK == rbase.LONG_CONTEXT_OK
    for arch in ARCH_NAMES:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert pbase.extra_input_specs(cfg, 3) == \
            rbase.extra_input_specs(rcfg, 3)
        for name, shape in pbase.SHAPES.items():
            assert pbase.cell_supported(cfg, shape) == \
                rbase.cell_supported(rcfg, rbase.SHAPES[name])
            got = pbase.input_specs(cfg, shape)
            want = rbase.input_specs(rcfg, rbase.SHAPES[name])
            assert list(got) == list(want)
            for k in got:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """At the published widths, on the meta device (no allocation):
    qwen2.5-14b is 14,770,033,664 parameters."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    if arch == "qwen2.5-14b":
        assert cfg.param_count() == 14_770_033_664


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Keys, stacked (L, ...) shapes and dtypes leaf for leaf, so
    ``params_from_reference`` fills the tree ``Model.init`` makes."""
    cfg = get_config(arch, smoke=True)
    want = jax.eval_shape(
        lambda: ref_model(ref_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0)))
    got = get_model(cfg).init(device="meta")
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = PC.tree_flatten(got)
    assert [p for p, _ in got_flat] == [
        "/".join(k.key for k in path) for path, _ in want_flat]
    for (_, g), (_, w) in zip(got_flat, want_flat):
        assert tuple(g.shape) == tuple(w.shape)
        assert PC.dtype_name(g.dtype) == str(w.dtype)


def test_init_draws_scaled_normals_from_a_seed():
    cfg = get_config("qwen2.5-14b", smoke=True)
    m = get_model(cfg)
    a, b, c = m.init(0, "cpu"), m.init(0, "cpu"), m.init(1, "cpu")
    for x, y in zip(PC.tree_leaves(a), PC.tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["layers"]["attn"]["wq"]
    assert wq.shape == (cfg.num_layers, cfg.d_model,
                        cfg.n_heads * cfg.head_dim)
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert float(a["layers"]["ln1"].abs().max()) == 0.0
    assert all(l.dtype == torch.float32 for l in PC.tree_leaves(a))


def test_params_from_reference_keeps_bf16_leaves():
    rcfg = ref_config("mixtral-8x22b", smoke=True)
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), rp)
    pp = params_from_reference(rp)
    for (path, r), p in zip(jax.tree_util.tree_flatten_with_path(rp)[0],
                            PC.tree_leaves(pp)):
        assert p.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(p.float().numpy(),
                                      r.astype(np.float32))


# ---------------------------------------------------------------------------
# Compile routing and errors
# ---------------------------------------------------------------------------
def test_engine_target_is_registered():
    assert "engine" in repro_torch.available_targets()


def test_config_requires_explicit_engine_target():
    with pytest.raises(TypeError, match="engine"):
        repro_torch.compile(get_config("qwen2.5-14b", smoke=True),
                            target="jit", device="cpu")


def test_graph_rejects_engine_target():
    from repro_torch.table1_models import SUITE
    with pytest.raises(TypeError, match="engine"):
        repro_torch.compile(SUITE["C-HTWK"](), target="engine", device="cpu")
    with pytest.raises(TypeError, match="params"):
        repro_torch.compile(SUITE["C-HTWK"](), target="jit", device="cpu",
                            params={})


def test_engine_rejects_frontend_args():
    with pytest.raises(TypeError, match="engine"):
        _engine(get_config("qwen2.5-14b", smoke=True), example_inputs={})


@pytest.mark.parametrize("precision", ["int8", "mixed"])
def test_engine_rejects_graph_precisions(precision):
    cfg = get_config("qwen2.5-14b", smoke=True)
    with pytest.raises(ValueError, match="engine") as port:
        _engine(cfg, precision=precision)
    with pytest.raises(ValueError, match="engine") as ref:
        repro.compile(ref_config("qwen2.5-14b", smoke=True),
                      repro.CompileOptions(target="engine",
                                           precision=precision))
    assert str(port.value) == str(ref.value)


def test_engine_default_device_needs_cuda():
    """The default device is the card; without one the compile raises
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default compiles there")
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.compile(get_config("qwen2.5-14b", smoke=True),
                            target="engine")


def test_engine_call_matches_reference(qwen):
    rcfg, rp, pp = qwen
    toks = _tokens(rcfg)
    ref = repro.compile(rcfg, repro.CompileOptions(target="engine"),
                        params=rp)
    exe = _engine(get_config("qwen2.5-14b", smoke=True), params=pp)
    assert exe.compile_time is None
    out = exe(tokens=toks)
    assert list(out) == ["logits"] and out["logits"].device.type == "cpu"
    np.testing.assert_allclose(
        out["logits"].numpy(),
        np.asarray(ref(tokens=toks)["logits"], np.float32),
        rtol=0.05, atol=0.05 * max(1.0, float(out["logits"].abs().max())))
    first = exe.compile_time
    assert first is not None and first > 0
    assert torch.equal(exe(toks)["logits"], out["logits"])   # positional
    assert exe.compile_time == first                          # seen shape
    exe(tokens=_tokens(rcfg, s=5))
    assert exe.compile_time > first                           # a new one
    assert exe.signature.input_names == ref.signature.input_names
    vlm = _engine(get_config("internvl2-2b", smoke=True))
    assert vlm.signature.input_names == ("tokens", "patches")


def test_engine_init_seed_is_deterministic():
    cfg = get_config("gemma3-27b", smoke=True)
    a = _engine(cfg, init_seed=3)
    b = _engine(cfg, init_seed=3)
    toks = _tokens(cfg)
    assert torch.equal(a(tokens=toks)["logits"], b(tokens=toks)["logits"])


def test_bf16_quant_report_and_cost_summary_match_reference(qwen):
    rcfg, rp, pp = qwen
    for precision in ("exact", "bf16"):
        ref = repro.compile(rcfg, repro.CompileOptions(
            target="engine", precision=precision), params=rp)
        exe = _engine(get_config("qwen2.5-14b", smoke=True),
                      precision=precision, params=pp)
        assert exe.cost_summary() == ref.cost_summary()
        assert exe.quant_report == ref.quant_report
    assert all(l.dtype == torch.bfloat16 for l in PC.tree_leaves(exe.params))
    # the caller's f32 params are left as they are
    assert all(l.dtype == torch.float32 for l in PC.tree_leaves(pp))


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision", [("qwen2.5-14b", "exact"),
                                            ("deepseek-v3-671b", "bf16"),
                                            ("internvl2-2b", "bf16")])
def test_serialize_roundtrip_bit_equal(arch, precision):
    cfg = get_config(arch, smoke=True)
    exe = _engine(cfg, precision=precision, init_seed=5)
    blob = exe.serialize()
    assert blob.startswith(b"REPROTORCHEXE1\n")
    back = repro_torch.deserialize(blob)
    assert back.cfg == cfg and back.options == exe.options
    assert back.quant_report == exe.quant_report
    got, want = PC.tree_flatten(back.params), PC.tree_flatten(exe.params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    toks = _tokens(cfg)
    assert torch.equal(back(tokens=toks)["logits"],
                       exe(tokens=toks)["logits"])


def test_deserialize_rejects_a_leaf_count_mismatch():
    import json
    exe = _engine(get_config("minicpm-2b", smoke=True))
    magic, meta, body = exe.serialize().split(b"\n", 2)
    meta = json.loads(meta)
    meta["leaf_dtypes"] = meta["leaf_dtypes"][:-1]
    bad = b"\n".join([magic, json.dumps(meta).encode(), body])
    with pytest.raises(ValueError, match="leaf count"):
        repro_torch.deserialize(bad)
    meta.pop("cfg")
    with pytest.raises(ValueError, match="cfg"):
        repro_torch.deserialize(b"\n".join([magic, json.dumps(meta).encode(),
                                            body]))


# ---------------------------------------------------------------------------
# Norm folding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v3-671b",
                                  "mixtral-8x22b", "gemma3-27b"])
def test_fold_norms_matches_reference(arch):
    rcfg = ref_config(arch, smoke=True)
    rp = ref_model(rcfg).init(jax.random.PRNGKey(0))
    # non-zero gammas, so the fold has something to move
    rng = np.random.default_rng(0)
    rp = jax.tree_util.tree_map_with_path(
        lambda path, t: (t + 0.1 * rng.standard_normal(t.shape).astype(
            np.float32)) if "ln" in str(path[-1]) else t, rp)
    pp = params_from_reference(jax.tree.map(np.asarray, rp))
    r_fold, r_rep = ref_fold_norms(rcfg, rp)
    p_fold, p_rep = fold_norms(get_config(arch, smoke=True), pp)
    assert p_rep == r_rep and p_rep["folds"] > 0
    for (path, r), p in zip(jax.tree_util.tree_flatten_with_path(r_fold)[0],
                            PC.tree_leaves(p_fold)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), str(path))
    assert float(p_fold["layers"]["ln1"].abs().max()) == 0.0
    assert float(pp["layers"]["ln1"].abs().max()) > 0.0   # input untouched
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    m = get_model(cfg)
    toks = {"tokens": torch.as_tensor(_tokens(cfg, s=16))}
    np.testing.assert_allclose(m.forward(p_fold, toks)[0].numpy(),
                               m.forward(pp, toks)[0].numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v3-671b"])
def test_fold_norms_per_layer_equals_whole_tensor_fold(arch, dtype,
                                                       monkeypatch):
    """``_scale_rows`` scales a stacked weight one layer at a time; the
    result is the whole-tensor product's bit for bit, for a dense model
    and a MoE with shared experts (MLA projections too), at f32 and at
    bf16 weights."""
    import importlib
    mod = importlib.import_module("repro_torch.inference.fold_norms")
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    params = PC.tree_map(
        lambda t: (t + torch.as_tensor(0.1 * rng.standard_normal(
            tuple(t.shape)), dtype=t.dtype)).to(dtype),
        get_model(cfg).init(0, "cpu"))
    per_layer, rep = fold_norms(cfg, params)

    def whole(w, scale, axis):
        shape = [1] * w.ndim
        shape[axis] = w.shape[axis]
        if scale.ndim == 2:
            shape[0] = w.shape[0]
        return (w.float() * scale.reshape(shape).float()).to(w.dtype)

    monkeypatch.setattr(mod, "_scale_rows", whole)
    want, want_rep = fold_norms(cfg, params)
    assert rep == want_rep and rep["folds"] > 0
    for (path, a), b in zip(PC.tree_flatten(per_layer),
                            PC.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_fold_norms_skips_other_families():
    cfg = get_config("mamba2-780m", smoke=True)
    params = {"x": torch.zeros(2)}
    out, rep = fold_norms(cfg, params)
    assert out is params and rep["folds"] == 0


# ---------------------------------------------------------------------------
# What waits for later items
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-base"])
def test_unported_families_name_a12b(arch):
    """The families that raised naming ROADMAP A.12b until they were
    ported: ``get_model``, ``param_count`` (the reference's) and an
    engine compile on the CPU each succeed, and the compile answers a
    call with the family's inputs (whisper's ``frames`` too).  They have
    no chunked prefill; their logical axes (A.14b) cover every param and
    cache leaf (``test_torch_model_axes.py`` holds them to the
    reference's), and since A.15a their training loss is a finite
    scalar (``test_torch_training_loss.py`` holds it to the
    reference's)."""
    cfg = get_config(arch, smoke=True)
    m = get_model(cfg)
    assert m.cfg == cfg and not m.supports_chunked_prefill()
    assert set(dict(PC.tree_flatten(m.param_axes()))) == set(
        dict(PC.tree_flatten(m.init(0, "meta"))))
    assert set(m.cache_axes()) == set(m.init_cache(1, 8, "meta"))
    loss_batch = {"tokens": _tokens(cfg), "labels": _tokens(cfg)}
    if cfg.family == "audio":
        loss_batch["frames"] = np.zeros((2, cfg.n_frames, cfg.d_model),
                                        np.float32)
    loss = m.loss(m.init(0, "cpu"), loss_batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert cfg.param_count() == ref_config(arch, smoke=True).param_count()
    exe = _engine(cfg)
    assert exe.cost_summary()["params"] == cfg.param_count()
    batch = {"tokens": _tokens(cfg)}
    if cfg.family == "audio":
        batch["frames"] = np.zeros((2, cfg.n_frames, cfg.d_model),
                                   np.float32)
    assert exe.signature.input_names == tuple(batch)
    logits = exe(**batch)["logits"]
    assert logits.shape == (2, 12, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_later_items_raise_naming_them():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    m = get_model(cfg)
    params = m.init(0, "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.ones((1, 4), dtype=torch.int32)}
    # A.15a is in: the loss with its multi-token-prediction term.  A.15b
    # is in: without a process group a mesh of two devices is refused.
    assert bool(torch.isfinite(m.loss(params, batch)))
    _, extras = m.forward(params, batch)
    from repro_torch.models import transformer
    mtp = transformer.mtp_logits(cfg, params, extras["mtp_hidden"],
                                 batch["tokens"])
    assert mtp.shape == (1, 4, cfg.vocab)
    from repro_torch.dist import MeshUnavailableError
    from repro_torch.training import TrainConfig, make_jitted_train_step
    with pytest.raises(MeshUnavailableError, match="data"):
        make_jitted_train_step(m, TrainConfig(), mesh="data=2",
                               device="cpu")
    # A.14b is in: the logical axes of every param and cache leaf.
    assert set(dict(PC.tree_flatten(m.param_axes()))) == set(
        dict(PC.tree_flatten(params)))
    assert m.cache_axes()["c1"] == ("layers", "batch", "kv_seq", None, None)
    # A.13 is in: serve() returns a scheduler, and the deprecated Engine
    # warns once and delegates to one.
    from repro_torch.serve import Request, Scheduler
    import repro_torch.inference.engine as legacy
    sched = _engine(cfg, params=params).serve(slots=2, max_len=32)
    assert isinstance(sched, Scheduler) and sched.options.slots == 2
    legacy._warned = False
    with pytest.warns(DeprecationWarning, match="deprecated"):
        eng = Engine(m, params, slots=1, max_len=32)
    assert isinstance(eng.scheduler, Scheduler)
    assert eng.cache is eng.scheduler.slot_manager.cache
    eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=3))
    assert [len(c.tokens) for c in eng.run()] == [3]
    assert eng.done == eng.scheduler.done


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.models, "
        "repro_torch.inference, repro_torch.api.engine_adapter\n"
        "import repro_torch.models.ssm, repro_torch.models.rglru, "
        "repro_torch.models.whisper\n"
        "import repro_torch.training, repro_torch.checkpoint, "
        "repro_torch.data, repro_torch.launch.train\n"
        "repro_torch.launch.train.main(['--smoke', '--steps', '1', "
        "'--batch', '1', '--seq', '8', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
