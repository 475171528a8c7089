"""The port's frontends (``repro_torch.frontends``, ``repro_torch.trace``)
against the reference's.

The first part mirrors ``tests/test_frontends.py`` test by test on the
port, with ``cuda`` on ``device="cpu"`` where the reference runs
``pallas`` (every kernel wrapper runs its plain version, as the Pallas
kernels run in interpret mode here).  The second part traces the same
Python function with both packages over the same numpy weights and
holds the graphs identical (``structure_hash()``, node names, signature,
params bit for bit) and the compiled outputs within 1e-5 (f32) or bit
for bit (int8, exact int32 sums); it also holds the deprecated
``CompiledModel`` to the reference's.
"""

import io
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
from repro.frontends import ops as RF

import repro_torch
from repro_torch.core import Graph, ModelBuilder, Signature, TensorSpec
from repro_torch.frontends import (Frontend, available_frontends, ops as F,
                                   register_frontend)
from repro_torch.frontends.container import load_model, save_model
from repro_torch.frontends.trace import TraceError

TARGETS = ("interpret", "jit", "cuda")
ATOL = 1e-5


def _compile(model, **kw):
    kw.setdefault("device", "cpu")
    return repro_torch.compile(model, **kw)


def _builder_cnn():
    """Reference model built through ModelBuilder; returns (graph, params)."""
    mb = ModelBuilder().seed(3)
    x = mb.input((8, 8, 3), name="image")
    h = mb.conv2d(x, 8, (3, 3), activation="relu")    # conv2d_1, act_relu_2
    h = mb.batchnorm(h)                               # bn_3
    h = mb.maxpool(h)
    h = mb.global_avg_pool(h)
    out = mb.dense(h, 4, activation="tanh")           # dense_6, act_tanh_7
    return mb.build([out]), mb.graph.params, out


def _cnn_fn(F, params):
    """The same model as a plain function over the same weight arrays,
    in the ops namespace ``F`` of either package."""

    def fn(image):
        h = F.conv2d(image, params["conv2d_1/kernel"],
                     params["conv2d_1/bias"], activation="relu")
        h = F.batchnorm(h, params["bn_3/gamma"], params["bn_3/beta"],
                        params["bn_3/mean"], params["bn_3/var"])
        h = F.maxpool(h)
        h = F.global_avg_pool(h)
        return F.dense(h, params["dense_6/kernel"], params["dense_6/bias"],
                       activation="tanh")

    return fn


def _traced_cnn(params):
    return repro_torch.trace(_cnn_fn(F, params), (8, 8, 3))


# ---------------------------------------------------------------- tracing
def test_trace_matches_builder_bit_identical_on_every_target(rng):
    """trace(fn) and the identical ModelBuilder model give bit-identical
    outputs on interpret, jit and cuda."""
    g1, params, out = _builder_cnn()
    g2 = _traced_cnn(params)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for target in TARGETS:
        want = _compile(g1, target=target)(image=x)[out]
        got = _compile(g2, target=target)(image=x)["output"]
        assert torch.equal(got, want), target


def test_trace_signature_from_function():
    g = _traced_cnn(_builder_cnn()[1])
    sig = g.signature()
    assert isinstance(sig, Signature)
    assert sig.input_names == ("image",)          # from the fn's parameter
    assert sig.outputs == (("output", TensorSpec((4,))),)


def test_trace_operators_and_constants(rng):
    w = rng.standard_normal((6, 3)).astype(np.float32)

    def fn(a, b):
        h = (a + b) * 2.0 + np.float32(1.0)       # tensor+tensor, scalar lift
        return h @ w                              # matmul -> dense

    g = repro_torch.trace(fn, (6,), (6,))
    assert g.signature().input_names == ("a", "b")
    a = rng.standard_normal((3, 6)).astype(np.float32)
    b = rng.standard_normal((3, 6)).astype(np.float32)
    got = _compile(g, target="interpret")(a=a, b=b)["output"].numpy()
    np.testing.assert_allclose(got, ((a + b) * 2.0 + 1.0) @ w, rtol=1e-5)


def test_trace_shared_weight_interned_once(rng):
    w = rng.standard_normal((4, 4)).astype(np.float32)

    def fn(x):
        return F.dense(F.dense(x, w), w)          # weight tying

    g = repro_torch.trace(fn, (4,))
    assert sum(1 for p in g.params if p.endswith("/kernel")) == 1


def test_trace_numpy_left_operand(rng):
    """ndarray * TracedTensor must defer to the tracer (one mul node),
    not let numpy broadcast elementwise over the abstract tensor."""
    w = rng.standard_normal(4).astype(np.float32)

    def fn(x):
        return w * x + w                          # numpy on the LEFT

    g = repro_torch.trace(fn, (4,))
    assert [n.op for n in g.nodes] == ["constant", "mul", "constant", "add"]
    x = rng.standard_normal((2, 4)).astype(np.float32)
    got = _compile(g, target="interpret")(x)["output"].numpy()
    np.testing.assert_allclose(got, w * x + w, rtol=1e-6)


def test_trace_distinct_temporary_weights_not_aliased(rng):
    """Two distinct weight *temporaries* must intern as two params even
    if CPython recycles the first one's id() after it is copied+freed
    (the id-keyed weight-tying memo must keep its keys alive)."""

    def fn(x):
        # float64 -> both arrays are copied to float32 inside the
        # tracer and the originals become collectable temporaries
        h = F.dense(x, np.ones((4, 4)))
        return F.dense(h, np.zeros((4, 4)))

    g = repro_torch.trace(fn, (4,))
    kernels = [p for p in g.params if p.endswith("/kernel")]
    assert len(kernels) == 2
    x = np.ones((1, 4), np.float32)
    got = _compile(g, target="interpret")(x)["output"].numpy()
    np.testing.assert_array_equal(got, np.zeros((1, 4), np.float32))


def test_trace_rejects_data_dependent_control_flow():
    def fn(x):
        if x:                                      # truth value of abstract
            return x
        return x

    with pytest.raises(TraceError, match="branch"):
        repro_torch.trace(fn, (4,))


def test_trace_rejects_foreign_and_non_tensor_outputs():
    with pytest.raises(TraceError, match="return"):
        repro_torch.trace(lambda x: 3.0, (4,))
    leaked = None

    def capture(x):
        nonlocal leaked
        leaked = x
        return F.relu(x)

    repro_torch.trace(capture, (4,))
    with pytest.raises(TraceError, match="different trace"):
        repro_torch.trace(lambda x: x + leaked, (4,))


# --------------------------------------------------- multi-output end to end
def _two_head_fn(F, rng):
    k = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    w1 = rng.standard_normal((8, 4)).astype(np.float32)
    w2 = rng.standard_normal((8, 2)).astype(np.float32)

    def fn(image):
        h = F.global_avg_pool(F.conv2d(image, k, activation="relu"))
        return {"probs": F.softmax(F.dense(h, w1)),
                "embed": F.dense(h, w2)}

    return fn


def _two_head(rng):
    return repro_torch.trace(_two_head_fn(F, rng), (8, 8, 3))


def test_two_head_goldens_across_targets(rng):
    g = _two_head(rng)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    ref = _compile(g, target="interpret")(x)
    assert list(ref) == ["probs", "embed"]        # user names, user order
    for target in ("jit", "cuda"):
        got = _compile(g, target=target)(x)
        assert list(got) == ["probs", "embed"]
        for name in ref:
            np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"{target}:{name}")


def test_two_head_serialize_round_trip_preserves_signature(rng):
    """A two-output traced model round-trips through serialize /
    deserialize with its Signature intact."""
    g = _two_head(rng)
    exe = _compile(g, target="jit")
    assert exe.signature.output_names == ("probs", "embed")
    exe2 = repro_torch.deserialize(exe.serialize())
    assert exe2.signature == exe.signature
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    a, b = exe(x), exe2(x)
    assert list(a) == list(b) == ["probs", "embed"]
    for name in a:
        assert torch.equal(a[name], b[name])


def test_container_round_trip_preserves_output_names(rng, tmp_path):
    g = _two_head(rng)
    path = str(tmp_path / "two_head.npz")
    save_model(g, path)
    g2 = load_model(path)
    assert g2.output_names == ["probs", "embed"]
    assert g2.outputs == g.outputs
    assert g2.signature() == g.signature()


def test_signature_in_cache_key(rng):
    """Renaming outputs must change the persistent-cache key: the
    public contract is part of what is cached."""
    g = _two_head(rng)
    g2 = g.copy()
    g2.set_outputs(dict(zip(["p2", "e2"], g.outputs)))
    k1 = _compile(g, target="jit")._program_key(1, {})
    k2 = _compile(g2, target="jit")._program_key(1, {})
    assert k1 != k2


def test_positional_or_keyword_binding(rng):
    w = rng.standard_normal((3, 2)).astype(np.float32)
    g = repro_torch.trace(lambda a, b: (a + b) @ w, (3,), (3,))
    exe = _compile(g, target="jit")
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((2, 3)).astype(np.float32)
    want = exe(a=a, b=b)["output"]
    assert torch.equal(exe(a, b)["output"], want)
    assert torch.equal(exe(a, b=b)["output"], want)
    with pytest.raises(TypeError, match="multiple values"):
        exe(a, a=a, b=b)
    with pytest.raises(TypeError, match="positional"):
        exe(a, b, a)
    with pytest.raises(ValueError, match="missing inputs"):
        exe(a)
    with pytest.raises(TypeError, match="unexpected inputs"):
        exe(a, b, c=a)


# ------------------------------------------------------------ the registry
def test_compile_bare_callable_with_example_inputs(rng):
    w = rng.standard_normal((4, 2)).astype(np.float32)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    exe = _compile(lambda v: F.relu(v @ w), example_inputs=(x,),
                   target="jit")
    np.testing.assert_allclose(exe(x)["output"].numpy(),
                               np.maximum(x @ w, 0), rtol=1e-5)
    with pytest.raises(TypeError, match="example_inputs"):
        _compile(lambda v: v)                     # no shapes to trace with


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_example_inputs_may_be_torch_tensors(dtype):
    """A torch tensor's dtype prints as "torch.float32", which is no IR
    dtype: the trace frontend maps it to the IR's name."""
    x = torch.zeros((3, 5), dtype=dtype)
    g = repro_torch.frontends.resolve(lambda v: F.flatten(v),
                                      example_inputs={"v": x})
    assert g.inputs["v"] == TensorSpec((5,), str(dtype).split(".")[1])
    assert g.signature().input_names == ("v",)


def test_compile_unknown_model_lists_frontends():
    with pytest.raises(TypeError) as ei:
        _compile(42)
    msg = str(ei.value)
    for name in available_frontends():
        assert name in msg
    assert "target='engine'" in msg               # LLM configs go there


def test_compile_llm_config_names_the_roadmap():
    """An LLM config compiles with target='engine' only (the reference's
    TypeError otherwise); an SSM config, which named ROADMAP A.12b until
    its family was ported, compiles there."""
    class Config:
        family, name = "dense", "qwen2.5-14b"

    with pytest.raises(TypeError, match="engine"):
        _compile(Config())

    from repro_torch.configs import get_config
    ssm = get_config("mamba2-780m", smoke=True)
    with pytest.raises(TypeError, match="engine"):
        _compile(ssm)
    exe = _compile(ssm, target="engine")
    assert exe.cost_summary()["family"] == "ssm"


def test_compile_builder_and_container_frontends(rng, tmp_path):
    mb = ModelBuilder().seed(0)
    out = mb.dense(mb.input((4,)), 2)
    with pytest.raises(TypeError, match="outputs"):
        _compile(mb)                              # outputs not set yet
    exe = _compile(mb, outputs=[out], target="jit")
    x = rng.standard_normal((2, 4)).astype(np.float32)
    want = exe(x)[out]

    path = str(tmp_path / "m.npz")
    save_model(mb.graph, path)
    exe2 = _compile(path, target="jit")           # container frontend
    assert torch.equal(exe2(x)[out], want)

    # frontend options that the chosen frontend does not consume are
    # rejected, not silently ignored
    with pytest.raises(TypeError, match="example_inputs"):
        _compile(path, example_inputs=(x,))


def test_register_custom_frontend(rng):
    """Third-party model formats plug in exactly like targets/passes."""

    class LinearSpec(dict):
        pass

    @register_frontend("linear-spec")
    class LinearFrontend(Frontend):
        def accepts(self, model):
            return isinstance(model, LinearSpec)

        def to_graph(self, model, **kw):
            return repro_torch.trace(lambda x: x @ model["w"],
                                     model["in_shape"])

    try:
        assert "linear-spec" in available_frontends()
        w = rng.standard_normal((3, 2)).astype(np.float32)
        exe = _compile(LinearSpec(w=w, in_shape=(3,)), target="jit")
        x = rng.standard_normal((2, 3)).astype(np.float32)
        np.testing.assert_allclose(exe(x)["output"].numpy(), x @ w,
                                   rtol=1e-5)
    finally:
        from repro_torch import frontends
        frontends._FRONTENDS.pop("linear-spec", None)


def test_keras_like_shims_warn_once():
    import repro_torch.core.keras_like as kl
    g = repro_torch.trace(lambda x: F.relu(x), (4,))
    kl._warned = False
    buf = io.BytesIO()
    with pytest.warns(DeprecationWarning, match="frontends.container"):
        kl.save_model(g, buf)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        buf.seek(0)
        kl.load_model(buf)
    assert not any(issubclass(w.category, DeprecationWarning)
                   for w in caught)


# ------------------------------------------------ incremental construction
def test_builder_construction_is_incremental(monkeypatch):
    """Building N layers runs shape inference O(N) times total, not
    O(N) times per layer."""
    calls = {"n": 0}
    orig = Graph._infer_node

    def counting(self, node, specs):
        calls["n"] += 1
        return orig(self, node, specs)

    monkeypatch.setattr(Graph, "_infer_node", counting)
    layers = 30
    mb = ModelBuilder().seed(0)
    h = mb.input((16,))
    for _ in range(layers):
        h = mb.dense(h, 16, activation="relu")
    mb.build([h])
    assert calls["n"] <= 2 * layers + 5


def test_spec_cache_invalidated_on_mutation():
    mb = ModelBuilder().seed(0)
    h = mb.dense(mb.input((4,)), 6)
    g = mb.build([h])
    assert g.spec(h).shape == (6,)
    # out-of-band mutation: widen the kernel, then rebuild_index —
    # the cache must not serve the stale (6,) spec
    g.params["dense_1/kernel"] = np.zeros((4, 8), np.float32)
    g.params["dense_1/bias"] = np.zeros(8, np.float32)
    g.rebuild_index()
    assert g.spec(h).shape == (8,)
    assert g.infer_shapes()[h].shape == (8,)


def test_builder_named_multi_outputs(rng):
    mb = ModelBuilder().seed(1)
    x = mb.input((6,))
    a = mb.dense(x, 3)
    b = mb.dense(x, 2)
    g = mb.build({"left": a, "right": b})
    assert g.output_names == ["left", "right"]
    exe = _compile(g, target="interpret")
    out = exe(rng.standard_normal((1, 6)).astype(np.float32))
    assert list(out) == ["left", "right"]
    assert out["left"].shape == (1, 3) and out["right"].shape == (1, 2)


# ---------------------------------------------------------------------------
# Parity with the reference: the same function traced by both packages
# ---------------------------------------------------------------------------
def _ops_fn(F, rng):
    w = rng.standard_normal((6, 3)).astype(np.float32)
    c = rng.standard_normal(6).astype(np.float32)

    def fn(a, b):
        h = c * (a + b) + np.float32(1.0)         # numpy left, scalar lift
        return F.sigmoid(h @ w)

    return fn


def _tied_fn(F, rng):
    w = rng.standard_normal((4, 4)).astype(np.float32)

    def fn(x):
        return F.leaky_relu(F.dense(F.dense(x, w), w), alpha=0.1)

    return fn


def _pool_fn(F, rng):
    k = rng.standard_normal((3, 3, 4, 2)).astype(np.float32)
    dw = rng.standard_normal((3, 3, 4, 1)).astype(np.float32)

    def fn(image):
        h = F.zero_pad(image, ((1, 1), (1, 1)))
        h = F.depthwise_conv2d(h, dw, strides=(2, 2), activation="relu6")
        a = F.avgpool(F.upsample(h, 2))
        b = F.conv2d(a, k, padding="valid", activation="elu")
        return F.softmax(F.flatten(F.concat([b, F.hard_sigmoid(b)])))

    return fn


def _decode_fn(F, rng):
    def fn(q, k, v, lengths):
        return {"attn": F.decode_attention(q, k, v, lengths, scale=0.25)}

    return fn


def _mlp_fn(F, rng):
    w1 = rng.standard_normal((16, 32)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((32, 8)).astype(np.float32) * 0.3
    b1 = rng.standard_normal(32).astype(np.float32)

    def fn(x):
        return F.dense(F.dense(x, w1, b1, activation="relu"), w2)

    return fn


#: name -> (function factory, specs of both packages' TensorSpec kind).
PARITY = {
    "cnn": (lambda F, rng: _cnn_fn(F, _builder_cnn()[1]), [(8, 8, 3)]),
    "two_head": (_two_head_fn, [(8, 8, 3)]),
    "ops": (_ops_fn, [(6,), (6,)]),
    "tied": (_tied_fn, [(4,)]),
    "pools": (_pool_fn, [(8, 8, 4)]),
    "decode": (_decode_fn, [(4, 8), (16, 2, 8), (16, 2, 8), ((), "int32")]),
    "mlp": (_mlp_fn, [(16,)]),
}


def _trace_both(name):
    make, specs = PARITY[name]

    def spec(pkg, s):
        if isinstance(s[-1], str):
            return pkg.core.TensorSpec(*s)
        return s

    ref = repro.trace(make(RF, np.random.default_rng(7)),
                      *[spec(repro, s) for s in specs])
    port = repro_torch.trace(make(F, np.random.default_rng(7)),
                             *[spec(repro_torch, s) for s in specs])
    return ref, port


def _feeds(graph, batch=3, seed=5):
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in graph.inputs.items():
        if s.dtype == "int32":
            out[n] = rng.integers(1, 17, size=(batch,)).astype(np.int32)
        else:
            out[n] = rng.standard_normal(
                (batch,) + tuple(s.shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(PARITY))
def test_traced_graphs_equal_the_references(name):
    ref, port = _trace_both(name)
    assert port.structure_hash() == ref.structure_hash()
    assert [n.name for n in port.nodes] == [n.name for n in ref.nodes]
    assert [n.op for n in port.nodes] == [n.op for n in ref.nodes]
    assert port.signature().to_dict() == ref.signature().to_dict()
    assert sorted(port.params) == sorted(ref.params)
    for k, v in ref.params.items():
        assert port.params[k].dtype == v.dtype
        np.testing.assert_array_equal(port.params[k], v)


@pytest.mark.parametrize("ref_target,port_target", [
    ("jit", "jit"), ("pallas", "cuda")])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_traced_compiles_match_the_references(name, ref_target, port_target):
    ref, port = _trace_both(name)
    feeds = _feeds(ref)
    want = repro.compile(ref, target=ref_target)(**feeds)
    got = _compile(port, target=port_target)(**feeds)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("port_target", ["jit", "cuda"])
@pytest.mark.parametrize("name", ["mlp", "tied"])
def test_traced_int8_is_bit_equal_to_the_reference(name, port_target):
    """At int8 the sums are exact: the port's traced graph, compiled
    with int8, gives the reference's bits on the reference's lax path.
    The graphs hold dense nodes only: a convolution before an int8 site
    sums f32 in another order in each package (~1e-7).
    The reference reads the port's calibrated ``quant.*`` attrs (its own
    calibration walk agrees to rtol 1e-6, and one ulp of a scale can move
    a value across a rounding tie: see ``test_torch_quantize.py``)."""
    ref, port = _trace_both(name)
    feeds = _feeds(ref)
    exe = _compile(port, target=port_target, precision="int8", calibrate=4)
    annotated = {n.name: n.attrs for n in exe.graph.nodes}
    assert any("quant.x_scale" in a for a in annotated.values())
    for node in ref.nodes:
        node.attrs.update({k: v for k, v in annotated.get(node.name, {}).items()
                           if k.startswith("quant.")})
    want = repro.compile(ref, target="jit")(**feeds)
    got = exe(**feeds)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_container_written_by_the_port_loads_in_the_reference(tmp_path):
    ref, port = _trace_both("two_head")
    path = str(tmp_path / "port.npz")
    save_model(port, path)
    from repro.frontends.container import load_model as ref_load
    back = ref_load(path)
    assert back.structure_hash() == ref.structure_hash()
    exe = repro_torch.compile(path, target="jit", device="cpu")
    assert exe.source.structure_hash() == ref.structure_hash()


def test_compiled_model_shim_matches_the_reference_and_warns_once():
    import repro.core.compiler as ref_compiler
    from repro_torch.core import CompiledModel, compiler
    g_ref, g_port = _trace_both("mlp")
    feeds = _feeds(g_ref)
    ref_compiler._warned = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_compiler.CompiledModel(g_ref, use_pallas=True).apply(**feeds)
    compiler._warned = False
    with pytest.warns(DeprecationWarning, match="repro_torch.compile"):
        model = CompiledModel(g_port, use_pallas=True, device="cpu")
    assert model.executable.options.target == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again = CompiledModel(g_port, device="cpu")
    assert not any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
    assert again.executable.options.target == "jit"
    got = model.apply(**feeds)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)
    assert callable(model.compile(2))
    assert model.graph is model.executable.graph
    assert model.compile_time is not None and model.report["passes"]


def test_compiled_model_defaults_to_the_card():
    from repro_torch.core import CompiledModel
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device compiles")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CompiledModel(_trace_both("mlp")[1])
