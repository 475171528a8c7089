"""The port's low-precision path against the JAX reference's.

``qmath``, the int8 dense's plain version, the quantize pass and whole
``precision="f32"|"bf16"|"int8"`` compiles, with the same numpy inputs
through both packages on the CPU (``device="cpu"``: every kernel wrapper
runs its plain version, as the reference's Pallas kernels run in
interpret mode here).  Tolerances, each with its reason:

* scales, quantized operands and the int8 dense with a none/relu
  epilogue: bit-equal.  The int8 sum is exact in any order and the
  dequant and epilogue are the same rounded f32 operations.
* the int8 dense with tanh/sigmoid/elu: 1e-6 absolute, an ulp or two of
  libm below 1.
* the calibrated activation scale: rtol 1e-6.  The calibration walk's
  f32 activations come from torch in the port and XLA in the reference,
  and differ in the last bits.
* whole compiles: 1e-5 absolute, the reference's own interpret-versus-jit
  spread (ROADMAP C); f32 against exact bit-equal.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
from benchmarks.table1_models import SUITE as REF_SUITE
from repro.core.passes import run_pipeline as ref_run_pipeline
from repro.kernels import qmath as ref_qmath
from repro.kernels.fused_matmul.ops import fused_matmul_q8 as ref_fused_matmul_q8

import repro_torch
from repro_torch.core.passes import run_pipeline as port_run_pipeline
from repro_torch.kernels import qmath
from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8
from repro_torch.kernels.fused_matmul.kernel import Q8_TILE, plan_q8
from repro_torch.kernels.tiles import (GEMV_MAX_M, Q8_BK, Q8_MAX_KSPLIT,
                                       Q8_TILES, STATIC_SMEM_BYTES,
                                       q8_gemv_smem_bytes, q8_tiled_smem_bytes)
from repro_torch.table1_models import SUITE as PORT_SUITE

ATOL = 1e-5
ACT_ATOL = 1e-6
DENSE_GRAPHS = ["C-HTWK", "C-BH", "VGG19"]


def _inputs(graph, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s.shape)).astype(np.float32)
            for n, s in graph.inputs.items()}


# ---------------------------------------------------------------------------
# qmath
# ---------------------------------------------------------------------------
def test_scales_bit_equal_reference():
    rng = np.random.default_rng(0)
    for absmax in (0.0, 1e-20, 0.3, 1.0, 7.123456, 1e6):
        assert qmath.tensor_scale(absmax) == ref_qmath.tensor_scale(absmax)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    w[..., 2] = 0.0                       # an all-zero channel takes EPS
    for axis in (1, 3, -1):
        np.testing.assert_array_equal(qmath.channel_scales(w, axis),
                                      ref_qmath.channel_scales(w, axis))
    ws = rng.standard_normal(7).astype(np.float32)
    np.testing.assert_array_equal(qmath.dequant_scales(0.0173, ws),
                                  np.asarray(ref_qmath.dequant_scales(0.0173, ws)))


@pytest.mark.parametrize("scale", [0.25, 0.1, 0.0173, 1.0 / 3.0])
def test_quantize_q8_bit_equal_reference_with_ties(scale):
    """Values placed on .5 ties of x / s (half to even), past the clip,
    and random; scales that are and are not powers of two."""
    s = np.float32(scale)
    half = np.arange(-140, 140) + 0.5
    cand = (half * s).astype(np.float32)
    ties = cand[(cand / s) == half]
    rng = np.random.default_rng(1)
    x = np.concatenate([ties, (rng.standard_normal(500) * 60 * s)
                        .astype(np.float32)])
    want = np.asarray(ref_qmath.quantize_q8(jnp.asarray(x), jnp.float32(s)))
    got = qmath.quantize_q8(torch.from_numpy(x), float(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.clip(np.round(x / s), -127, 127))


def test_quantize_q8_per_channel_bit_equal_reference():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    ws = ref_qmath.channel_scales(w, 1)
    want = np.asarray(ref_qmath.quantize_q8(jnp.asarray(w), jnp.asarray(ws)[None, :]))
    got = qmath.quantize_q8(torch.from_numpy(w), ws[None, :])
    np.testing.assert_array_equal(got.numpy(), want)
    # quantize_weight: the same bits in both layouts, and s_x * s_w.
    wq, deq = qmath.quantize_weight(torch.from_numpy(w), 0.02, ws, "io")
    wq_oi, _ = qmath.quantize_weight(torch.from_numpy(w.T.copy()), 0.02, ws, "oi")
    np.testing.assert_array_equal(wq.numpy(), want)
    np.testing.assert_array_equal(wq_oi.numpy(), want.T)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(ref_qmath.dequant_scales(0.02, ws)))


def test_bf16_and_int8_convs_match_reference():
    """conv2d_bf16 (operands rounded, f32 sum) and conv2d_q8 (exact sum in
    float64) against the reference's lax forms, NHWC, "same" padding."""
    from repro.core.ops_common import lax_padding
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 5, 6)) * 0.2).astype(np.float32)
    ws = ref_qmath.channel_scales(k, 3)
    pad = lax_padding("same")
    want_b = np.asarray(ref_qmath.conv2d_bf16(jnp.asarray(x), jnp.asarray(k),
                                              strides=(2, 1), padding=pad))
    want_q = np.asarray(ref_qmath.conv2d_q8(jnp.asarray(x), jnp.asarray(k),
                                            0.031, ws, strides=(2, 1),
                                            padding=pad))
    k_oihw = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    got_b = qmath.conv2d_bf16(torch.from_numpy(x), k_oihw, strides=(2, 1),
                              padding="same")
    got_q = qmath.conv2d_q8(torch.from_numpy(x), k_oihw, 0.031, ws,
                            strides=(2, 1), padding="same")
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_q.numpy(), want_q)


# ---------------------------------------------------------------------------
# the int8 dense (fused_matmul_q8), plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", [None, "relu", "tanh", "sigmoid", "elu"])
@pytest.mark.parametrize("w_layout", ["io", "oi"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_matmul_q8_matches_reference(fn, w_layout, use_pallas,
                                           with_bias):
    """Bit-equal for none/relu, except against the reference's Pallas
    kernel with a bias: XLA contracts its ``acc * deq + bias`` into one
    FMA there, which moves the result by an ulp of the product (the
    reference's own lax path and the port round twice; ROADMAP C)."""
    rng = np.random.default_rng(4)
    m, k, n = 10, 40, 24
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_io = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    w = w_io if w_layout == "io" else np.ascontiguousarray(w_io.T)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    xs = ref_qmath.tensor_scale(float(np.abs(x).max()) * 0.7)
    ws = ref_qmath.channel_scales(w_io, 1)
    want = np.asarray(ref_fused_matmul_q8(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        x_scale=xs, w_scales=ws, fn=fn, w_layout=w_layout,
        use_pallas=use_pallas))
    wq, deq = qmath.quantize_weight(torch.from_numpy(w), xs, ws, w_layout)
    got = fused_matmul_q8(torch.from_numpy(x), wq, deq,
                          None if b is None else torch.from_numpy(b),
                          x_scale=xs, fn=fn, w_layout=w_layout).numpy()
    if fn in (None, "relu") and not (use_pallas and with_bias):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ACT_ATOL)


def test_fused_matmul_q8_affine_and_higher_rank_bit_equal_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b, s, o = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    ws = ref_qmath.channel_scales(w, 1)
    want = np.asarray(ref_fused_matmul_q8(
        jnp.asarray(x), jnp.asarray(w), b, s, o, x_scale=0.02, w_scales=ws,
        fn="leaky_relu", attrs={"alpha": 0.2}))
    wq, deq = qmath.quantize_weight(torch.from_numpy(w), 0.02, ws)
    got = fused_matmul_q8(torch.from_numpy(x), wq, deq, *map(torch.from_numpy, (b, s, o)),
                          x_scale=0.02, fn="leaky_relu", attrs={"alpha": 0.2})
    assert got.shape == (2, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_matmul_q8_wrapper_rejects_what_the_kernel_does_not_take():
    x, wq = torch.zeros(4, 8), torch.zeros(3, 8, dtype=torch.int8)
    deq = torch.ones(3)
    with pytest.raises(ValueError):
        fused_matmul_q8(x, wq, deq, x_scale=0.1, w_layout="ko")
    with pytest.raises(ValueError):
        fused_matmul_q8(x, torch.zeros(5, 3, dtype=torch.int8), deq, x_scale=0.1)
    with pytest.raises(NotImplementedError):
        fused_matmul_q8(x, wq, deq, x_scale=0.1, fn="gelu", w_layout="oi")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_matmul_q8(x.to("meta"), wq.to("meta"), deq.to("meta"),
                        x_scale=0.1, w_layout="oi")
    assert fused_matmul_q8.launches == 0


def test_q8_tile_fits_shared_memory():
    """Every tile the int8 kernel is compiled for, and its GEMV path at
    the most rows, fit a block's static shared memory; the plan's tile
    is one of them, and its K stages are the s8 mma's depth."""
    assert Q8_TILE in Q8_TILES
    for bm, bn in Q8_TILES:
        assert q8_tiled_smem_bytes(bm, bn) <= STATIC_SMEM_BYTES
        assert bm % 16 == 0 and bn % 8 == 0   # m16n8 tiles over 4 warps
    for layout in ("io", "oi"):
        assert q8_gemv_smem_bytes(GEMV_MAX_M, layout) <= STATIC_SMEM_BYTES
    assert Q8_BK == 32 and Q8_MAX_KSPLIT % Q8_BK == 0
    p = plan_q8(256, 256, 128, w_layout="oi")
    assert p.smem_bytes == q8_tiled_smem_bytes(*Q8_TILE)
    assert p.ksplit <= Q8_MAX_KSPLIT


# ---------------------------------------------------------------------------
# the quantize pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("name", sorted(REF_SUITE))
def test_quantize_pass_annotates_as_the_reference(name, mode):
    ref_g, port_g = REF_SUITE[name](), PORT_SUITE[name]()
    ref_g.quant = {"mode": mode, "calibrate": 4}
    port_g.quant = {"mode": mode, "calibrate": 4}
    ref_out, ref_rep = ref_run_pipeline(ref_g)
    port_out, port_rep = port_run_pipeline(port_g)
    assert port_out.quant == ref_out.quant
    assert [n.name for n in port_out.nodes] == [n.name for n in ref_out.nodes]
    for rn, pn in zip(ref_out.nodes, port_out.nodes):
        rq = {k: v for k, v in rn.attrs.items() if k.startswith("quant.")}
        pq = {k: v for k, v in pn.attrs.items() if k.startswith("quant.")}
        assert pq.keys() == rq.keys(), rn.name
        for key in rq:
            if key == "quant.x_scale":
                np.testing.assert_allclose(pq[key], rq[key], rtol=1e-6)
            else:
                assert pq[key] == rq[key], (rn.name, key)
    stats = [{k: v for k, v in p.items() if k in ("sites", "mode", "f32",
                                                   "bf16", "int8")}
             for rep in (port_rep, ref_rep) for p in rep["passes"]
             if p["pass"] == "quantize"]
    assert stats[0] == stats[1]


def test_quantize_pass_mixed_raises_naming_autotune(tmp_path):
    """The pass runs ``mode="mixed"`` (no longer refused): on a tactic
    cache seeded with one winner per site it annotates each site with its
    winner, measuring nothing."""
    from repro_torch.autotune.cache import (TacticCache,
                                            environment_fingerprint, tactic_key)
    quantize = sys.modules["repro_torch.core.passes.quantize"]
    g = PORT_SUITE["C-HTWK"]()
    pre, _ = port_run_pipeline(g, PRE_QUANTIZE)
    sites = [n for n in pre.nodes if n.op in quantize.QUANT_OPS]
    fp = environment_fingerprint("cpu")
    cache = TacticCache(str(tmp_path / "tactics"))
    winners = {}
    for i, node in enumerate(sites):
        winners[node.name] = ("bf16", "int8")[i % 2] if node.op == "dense" \
            else ("bf16", "f32")[i % 2]
        cache.store(tactic_key(quantize.site_desc(
            node, pre, quantize.DEFAULT_PRECISION_BUDGET, "absmax", "cpu"),
            fp), {"winner": winners[node.name], "fingerprint": fp})
    g.quant = {"mode": "mixed", "measure": False, "cache_dir": str(tmp_path)}
    out, rep = port_run_pipeline(g)
    stats = next(p for p in rep["passes"] if p["pass"] == "quantize")
    assert stats["mixed"]["entries"] == len(sites)
    assert {s["source"] for s in stats["mixed"]["sites"].values()} == {"cached"}
    modes = {n.name: n.attrs.get("quant.mode", "f32") for n in out.nodes
             if n.name in winners}
    assert modes == winners
    assert out.quant == {"mode": "mixed", "decisions": {
        m: sum(w == m for w in winners.values())
        for m in ("f32", "bf16", "int8")}}


# ---------------------------------------------------------------------------
# mixed: per-site measured precision, against the reference
# ---------------------------------------------------------------------------
#: The default pipeline up to the quantize pass.
PRE_QUANTIZE = ("canonicalize", "fold_constants", "fuse_pad",
                "fuse_activation", "fold_batchnorm", "fuse_activation.post_bn")


def _descs(monkeypatch, tmp_path, ref_g, port_g):
    """The mixed-precision descriptors each package keys its sites by, in
    site order: both compiled with ``autotune="cached"`` on empty caches
    (nothing measured), their ``tactic_key`` watched."""
    import repro.autotune.cache as ref_cache
    import repro_torch.autotune.cache as port_cache

    seen = {"ref": [], "port": []}

    def spy(store, real):
        def key(desc, *a, **kw):
            if desc.get("kind") == "precision":
                store.append(dict(desc))
            return real(desc, *a, **kw)
        return key

    monkeypatch.setattr(ref_cache, "tactic_key",
                        spy(seen["ref"], ref_cache.tactic_key))
    monkeypatch.setattr(port_cache, "tactic_key",
                        spy(seen["port"], port_cache.tactic_key))
    repro.compile(ref_g, repro.CompileOptions(
        target="jit", precision="mixed", autotune="cached",
        cache_dir=str(tmp_path / "probe_ref")))
    repro_torch.compile(port_g, target="jit", precision="mixed",
                        autotune="cached", device="cpu",
                        cache_dir=str(tmp_path / "probe_port"))
    monkeypatch.undo()
    return seen["ref"], seen["port"]


def _seed(tmp_path, ref_descs, port_descs, winners):
    """Each package's own tactic cache, holding the same winner per site
    under each package's own key."""
    import repro.autotune.cache as ref_cache
    import repro_torch.autotune.cache as port_cache

    ref_fp = ref_cache.environment_fingerprint()
    port_fp = port_cache.environment_fingerprint("cpu")
    ref_tc = ref_cache.TacticCache(str(tmp_path / "ref" / "tactics"))
    port_tc = port_cache.TacticCache(str(tmp_path / "port" / "tactics"))
    for rd, pd, w in zip(ref_descs, port_descs, winners):
        ref_tc.store(ref_cache.tactic_key(rd, ref_fp),
                     {"winner": w, "fingerprint": ref_fp})
        port_tc.store(port_cache.tactic_key(pd, port_fp),
                      {"winner": w, "fingerprint": port_fp})


def _quant_attrs(graph):
    return {n.name: {k: v for k, v in n.attrs.items() if k.startswith("quant.")}
            for n in graph.nodes}


@pytest.mark.parametrize("pattern", ["cycle", "int8", "f32"])
@pytest.mark.parametrize("name", DENSE_GRAPHS)
def test_mixed_seeded_winners_match_reference(monkeypatch, tmp_path, name,
                                              pattern):
    """The same per-site winners in both packages' caches give the same
    ``quant.*`` annotations under ``autotune="cached"``.  Outputs: against
    the reference compiled with the port's annotations (as
    test_compile_matches_reference does) within 1e-5; a program whose
    sites all won int8 (conv sites stay f32) is bit-equal to the int8
    program, one whose sites all won f32 to the f32 program."""
    ref_g, port_g = REF_SUITE[name](), PORT_SUITE[name]()
    ref_descs, port_descs = _descs(monkeypatch, tmp_path, ref_g, port_g)
    assert len(port_descs) == len(ref_descs) > 0
    for rd, pd in zip(ref_descs, port_descs):
        assert rd.pop("tpu") is False and pd.pop("device") == "cpu"
        assert pd == rd
    winners = []
    for i, d in enumerate(port_descs):
        if pattern == "f32":
            winners.append("f32")
        elif pattern == "int8":
            winners.append("int8" if d["op"] == "dense" else "f32")
        else:
            winners.append(("int8", "bf16", "f32")[i % 3] if d["op"] == "dense"
                           else ("bf16", "f32")[i % 2])
    _, port_descs = _descs(monkeypatch, tmp_path, ref_g, port_g)
    ref_descs, _ = _descs(monkeypatch, tmp_path, ref_g, port_g)
    _seed(tmp_path, ref_descs, port_descs, winners)

    feeds = _inputs(ref_g)
    ref_exe = repro.compile(ref_g, repro.CompileOptions(
        target="jit", precision="mixed", autotune="cached",
        cache_dir=str(tmp_path / "ref")))
    port = {t: repro_torch.compile(port_g, target=t, precision="mixed",
                                   autotune="cached", device="cpu",
                                   cache_dir=str(tmp_path / "port"))
            for t in ("jit", "cuda")}
    ref_q, port_q = _quant_attrs(ref_exe.graph), _quant_attrs(port["jit"].graph)
    assert port_q.keys() == ref_q.keys()
    for node, rq in ref_q.items():
        pq = port_q[node]
        assert pq.keys() == rq.keys(), node
        for key in rq:
            if key == "quant.x_scale":
                np.testing.assert_allclose(pq[key], rq[key], rtol=1e-6)
            else:
                assert pq[key] == rq[key], (node, key)
    assert port["jit"].graph.quant == ref_exe.graph.quant
    assert _quant_attrs(port["cuda"].graph) == port_q

    annotated = _quant_attrs(port["jit"].graph)
    for node in ref_g.nodes:
        node.attrs.update(annotated.get(node.name, {}))
    want = repro.compile(ref_g, repro.CompileOptions(target="jit"))(**feeds)
    for exe in port.values():
        got = exe(**feeds)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=ATOL)
    if pattern != "cycle":
        for t, exe in port.items():
            same = repro_torch.compile(port_g, target=t, precision=pattern,
                                       device="cpu")(**feeds)
            got = exe(**feeds)
            for k in got:
                assert torch.equal(got[k], same[k]), (t, k)


@pytest.mark.parametrize("name", DENSE_GRAPHS)
def test_mixed_site_errors_match_reference(name):
    """Each site's candidates through both packages' ``_site_runner`` on
    the reference's first calibration batch: int8 outputs bit-equal, f32
    and bf16 within 1e-5 times the site output's magnitude where that
    exceeds 1 (VGG19's convolutions reach ~40, where torch's and XLA's
    f32 sums, in another order, part by a few ulps), and so each
    candidate's error against f32."""
    from repro.core.passes import run_pipeline as ref_pipeline
    ref_q = sys.modules["repro.core.passes.quantize"]
    port_q = sys.modules["repro_torch.core.passes.quantize"]
    ref_g, _ = ref_pipeline(REF_SUITE[name](), PRE_QUANTIZE)
    port_g, _ = port_run_pipeline(PORT_SUITE[name](), PRE_QUANTIZE)
    sites = [n for n in ref_g.nodes
             if n.op in ref_q.QUANT_OPS and "kernel" in n.params]
    ranges, first_inputs, _ = ref_q._calibrate(ref_g, 4, sites)
    port_nodes = {n.name: n for n in port_g.nodes}
    for node in sites:
        x = first_inputs[node.name]
        cands = ["f32"] + [c for c in ("bf16", "int8")
                           if ref_q._static_site_mode(node, c, False) == c]
        assert cands == ["f32"] + [
            c for c in ("bf16", "int8")
            if port_q._static_site_mode(port_nodes[node.name], c) == c]
        outs = {}
        for cand in cands:
            run, args = ref_q._site_runner(node, ref_g, cand, x, ranges,
                                           "absmax")
            want = np.asarray(run(*args))
            run, args = port_q._site_runner(port_nodes[node.name], port_g,
                                            cand, x, ranges, "absmax", "cpu")
            got = run(*args).float().numpy()
            atol = ATOL * max(1.0, float(np.abs(want).max()))
            if cand == "int8":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=atol)
            outs[cand] = (got, want, atol)
        for cand, (got, want, atol) in outs.items():
            err_port = float(np.abs(got - outs["f32"][0]).max())
            err_ref = float(np.abs(want - outs["f32"][1]).max())
            assert abs(err_port - err_ref) <= 2 * atol, (node.name, cand)


def test_mixed_tight_budget_is_f32(tmp_path):
    """``precision_budget=1e-9`` leaves every narrow candidate over
    budget: every site stays f32, bit-equal to ``precision="f32"``."""
    g = PORT_SUITE["C-HTWK"]()
    feeds = _inputs(g)
    exe = repro_torch.compile(g, target="cuda", precision="mixed",
                              precision_budget=1e-9, device="cpu",
                              cache_dir=str(tmp_path),
                              autotune_budget_ms=120_000)
    assert exe.graph.quant["decisions"]["bf16"] == 0
    assert exe.graph.quant["decisions"]["int8"] == 0
    stats = next(p for p in exe.report["passes"] if p["pass"] == "quantize")
    assert {s["source"] for s in stats["mixed"]["sites"].values()} == \
        {"measured"}
    f32 = repro_torch.compile(g, target="cuda", precision="f32",
                              device="cpu")(**feeds)
    got = exe(**feeds)
    for k in got:
        assert torch.equal(got[k], f32[k])


def test_mixed_measures_on_the_compiles_device_unless_cached(tmp_path):
    """``full``/``off`` measure (and store); ``cached`` and the
    ``interpret`` target never do: a site without an entry stays f32."""
    g = PORT_SUITE["C-BH"]()
    for kw in (dict(target="interpret"), dict(target="cuda",
                                              autotune="cached")):
        exe = repro_torch.compile(g, precision="mixed", device="cpu",
                                  cache_dir=str(tmp_path), **kw)
        assert exe.cost_summary()["quant"]["decisions"]["f32"] == \
            sum(exe.cost_summary()["quant"]["decisions"].values())
    assert not os.path.exists(tmp_path / "tactics") or \
        not os.listdir(tmp_path / "tactics")
    exe = repro_torch.compile(g, target="cuda", precision="mixed",
                              device="cpu", cache_dir=str(tmp_path),
                              autotune_budget_ms=120_000)
    stats = next(p for p in exe.report["passes"] if p["pass"] == "quantize")
    assert stats["mixed"]["device"] == "cpu"
    assert {s["source"] for s in stats["mixed"]["sites"].values()} == \
        {"measured"}
    stored = sorted(os.listdir(tmp_path / "tactics"))
    assert len(stored) == stats["mixed"]["entries"]
    # The interpret target still measures nothing (its sites, unfused,
    # key other descriptors), and stores nothing.
    repro_torch.compile(g, target="interpret", precision="mixed",
                        device="cpu", cache_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path / "tactics")) == stored


# ---------------------------------------------------------------------------
# whole compiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ref_target,port_target", [
    ("interpret", "interpret"), ("jit", "jit"), ("pallas", "cuda")])
@pytest.mark.parametrize("name", DENSE_GRAPHS)
def test_compile_matches_reference(name, ref_target, port_target, precision):
    """Under int8 the reference runs with the port's calibrated scales:
    the two calibration walks agree to rtol 1e-6 (see the pass's test),
    and a scale one ulp apart can move an activation across a rounding
    tie, which is one int8 step (~2e-4 in VGG19's logits).  So the
    reference compiles the source graph annotated with the port's
    ``quant.*`` attrs, which every one of its targets reads, and the
    arithmetic is compared alone."""
    ref_g, port_g = REF_SUITE[name](), PORT_SUITE[name]()
    feeds = _inputs(ref_g)
    exe = repro_torch.compile(port_g, repro_torch.CompileOptions(
        target=port_target, precision=precision, calibrate=4, device="cpu"))
    got = exe(**feeds)
    ref_precision = precision
    if precision == "int8":
        annotated = {n.name: n.attrs for n in repro_torch.compile(
            port_g, target="jit", precision="int8", calibrate=4,
            device="cpu").graph.nodes}
        for node in ref_g.nodes:
            node.attrs.update({k: v for k, v in annotated.get(node.name, {}).items()
                               if k.startswith("quant.")})
        ref_precision = "exact"
    want = repro.compile(ref_g, repro.CompileOptions(
        target=ref_target, precision=ref_precision, calibrate=4))(**feeds)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("ref_target,port_target", [
    ("interpret", "interpret"), ("jit", "jit")])
def test_cost_summary_reports_the_quantization(ref_target, port_target,
                                               precision):
    ref_g, port_g = REF_SUITE["C-BH"](), PORT_SUITE["C-BH"]()
    want = repro.compile(ref_g, repro.CompileOptions(
        target=ref_target, precision=precision)).cost_summary()["quant"]
    got = repro_torch.compile(port_g, target=port_target, precision=precision,
                              device="cpu").cost_summary()["quant"]
    assert got == want


@pytest.mark.parametrize("target", ["interpret", "jit", "cuda"])
def test_f32_is_bit_equal_to_exact(target):
    g = PORT_SUITE["VGG19"]()
    feeds = _inputs(g)
    a = repro_torch.compile(g, target=target, precision="f32", device="cpu")(**feeds)
    b = repro_torch.compile(g, target=target, precision="exact", device="cpu")(**feeds)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("target,q8,fm", [("jit", 0, 0), ("cuda", 3, 0)])
def test_int8_dense_nodes_reach_the_q8_wrapper(monkeypatch, target, q8, fm):
    """VGG19 has three dense nodes: under int8 on ``cuda`` each calls the
    fused_matmul_q8 wrapper and none the f32 one; ``jit`` calls neither."""
    from repro_torch.core import lowering

    calls = {"q8": 0, "fm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(lowering, "fused_matmul_q8",
                        counted("q8", lowering.fused_matmul_q8))
    monkeypatch.setattr(lowering, "fused_matmul",
                        counted("fm", lowering.fused_matmul))
    g = PORT_SUITE["VGG19"]()
    exe = repro_torch.compile(g, target=target, precision="int8", device="cpu")
    exe(**_inputs(g))
    assert calls == {"q8": q8, "fm": fm}
    if target == "cuda":
        sel = exe.cost_summary()["kernel_selection"][2]
        dense = [c for c in sel if c["op"] == "dense"]
        assert [c["kernel"] for c in dense] == ["cuda.fused_matmul_q8"] * 3
        for c in dense:   # the reason names the plan the kernel runs
            m, k, n = (int(v) for v in re.match(
                r"M=(\d+) K=(\d+) N=(\d+) oi: ", c["reason"]).groups())
            p = plan_q8(m, k, n, w_layout="oi")
            assert m == 2 and p.path == "gemv"
            assert (f"oi: {p.describe()}, {p.smem_bytes / 1024:.1f} KiB SMEM, "
                    f"int32 sums in registers, "
                    f"{p.pad_waste(m, k, n):.1f}x pad waste") in c["reason"]
            assert tuple(c["block"]) == (p.block[0], p.ksplit, p.block[1])


@pytest.mark.parametrize("target,fm", [("jit", 0), ("cuda", 3)])
def test_bf16_dense_nodes_reach_the_f32_wrapper_with_bf16_operands(
        monkeypatch, target, fm):
    from repro_torch.core import lowering

    dtypes = []

    def counted(x, w, *a, **kw):
        dtypes.append((x.dtype, w.dtype))
        return fused(x, w, *a, **kw)

    fused = lowering.fused_matmul
    monkeypatch.setattr(lowering, "fused_matmul", counted)
    g = PORT_SUITE["VGG19"]()
    repro_torch.compile(g, target=target, precision="bf16",
                        device="cpu")(**_inputs(g))
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * fm
