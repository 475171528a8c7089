"""repro_torch.compile against repro.compile on the Table-1 graphs.

Same graph, same weights, same numpy inputs through both packages at
batch 2, on the CPU (``device="cpu"``: every kernel wrapper runs its
plain version, as the reference's Pallas kernels run in interpret mode
here).  Tolerance 1e-5 absolute: the reference's own targets disagree by
up to ~2.4e-7 (ROADMAP C), and these outputs stay below ~10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
from benchmarks.table1_models import SUITE as REF_SUITE

import repro_torch
from repro_torch.table1_models import SUITE as PORT_SUITE

ATOL = 1e-5
DENSE_GRAPHS = ["C-HTWK", "C-BH", "VGG19"]


def _inputs(graph, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s.shape)).astype(np.float32)
            for n, s in graph.inputs.items()}


def _compare(name, ref_target, port_target, precision="exact"):
    ref_g, port_g = REF_SUITE[name](), PORT_SUITE[name]()
    feeds = _inputs(ref_g)
    want = repro.compile(ref_g, repro.CompileOptions(
        target=ref_target, precision=precision))(**feeds)
    exe = repro_torch.compile(port_g, repro_torch.CompileOptions(
        target=port_target, precision=precision, device="cpu"))
    got = exe(**feeds)
    assert list(got) == list(want)
    for k in want:
        g = got[k].numpy()
        assert g.shape == tuple(want[k].shape)
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0, atol=ATOL)
    return exe


@pytest.mark.parametrize("name", sorted(REF_SUITE))
def test_interpret_matches_reference_interpret(name):
    _compare(name, "interpret", "interpret")


@pytest.mark.parametrize("name", sorted(REF_SUITE))
def test_jit_matches_reference_jit(name):
    _compare(name, "jit", "jit")


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name", DENSE_GRAPHS)
def test_cuda_target_matches_reference_pallas(name, precision):
    exe = _compare(name, "pallas", "cuda", precision)
    sel = exe.cost_summary()["kernel_selection"][2]
    dense = [c for c in sel if c["op"] == "dense"]
    assert dense and all(c["kernel"] == "cuda.fused_matmul" for c in dense)
    # The reference's reason form: M/K/N, tile, on-chip bytes, waste; the
    # tile is the plan the kernel runs (M=2: the GEMV path).
    assert all(c["reason"].startswith("M=2 K=") and "GEMV over" in c["reason"]
               and "KiB SMEM" in c["reason"]
               and "x pad waste" in c["reason"] for c in dense)


def _op_graph(builder):
    """Every op and activation the Table-1 graphs leave out: stride-2
    "same" convs on odd sizes (asymmetric pads), depthwise, "same"
    pools, concat, an unfolded batchnorm, a standalone activation,
    upsample, a zero_pad the passes fuse into a conv, the rest of the
    epilogue activations."""
    mb = builder().seed(9)
    x = mb.input((9, 11, 3))
    a = mb.conv2d(x, 6, (3, 3), strides=(2, 2), activation="elu")
    a = mb.avgpool(a, (3, 3), strides=(2, 2), padding="same")
    b = mb.depthwise_conv2d(x, (3, 3), strides=(2, 2), mult=2,
                            activation="tanh")
    b = mb.maxpool(b, (3, 3), strides=(2, 2), padding="same")
    h = mb.batchnorm(mb.concat([a, b]))
    h = mb.activation(h, "leaky_relu", alpha=0.2)
    h = mb.zero_pad(mb.upsample(h, 2), ((1, 0), (0, 2)))
    h = mb.conv2d(h, 4, (3, 3), padding="valid", activation="sigmoid")
    h = mb.dense(mb.flatten(h), 8, activation="hard_sigmoid")
    h = mb.dense(h, 5, activation="relu6")
    return mb.build([mb.softmax(h)])


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("ref_target,port_target", [
    ("interpret", "interpret"), ("jit", "jit"), ("pallas", "cuda")])
def test_op_coverage_matches_reference(ref_target, port_target, precision):
    from repro.core import ModelBuilder as RefBuilder
    from repro_torch.core import ModelBuilder as PortBuilder

    ref_g, port_g = _op_graph(RefBuilder), _op_graph(PortBuilder)
    feeds = _inputs(ref_g, batch=3)
    want = repro.compile(ref_g, repro.CompileOptions(
        target=ref_target, precision=precision))(**feeds)
    got = repro_torch.compile(port_g, repro_torch.CompileOptions(
        target=port_target, precision=precision, device="cpu"))(**feeds)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("target,fused,fast", [("jit", 0, 0), ("cuda", 2, 1)])
def test_cuda_target_sends_every_dense_and_fast_act_to_the_wrappers(
        monkeypatch, target, fused, fast):
    """C-HTWK has two dense nodes and one softmax: on ``cuda`` each dense
    node calls the fused_matmul wrapper and the fast softmax's exp calls
    the fast_act wrapper; ``jit`` calls neither."""
    from repro_torch.core import lowering
    from repro_torch.kernels.fast_act import ops as fa_ops

    calls = {"fused_matmul": 0, "fast_act": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(lowering, "fused_matmul",
                        counted("fused_matmul", lowering.fused_matmul))
    monkeypatch.setattr(fa_ops, "fast_act", counted("fast_act", fa_ops.fast_act))
    g = PORT_SUITE["C-HTWK"]()
    repro_torch.compile(g, target=target, precision="fast",
                        device="cpu")(**_inputs(g))
    assert calls == {"fused_matmul": fused, "fast_act": fast}


def test_cuda_target_refuses_a_card_other_than_hopper(monkeypatch):
    from repro_torch.core.selection import check_kernel_device

    check_kernel_device("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    check_kernel_device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0))
    with pytest.raises(RuntimeError, match="sm_90a"):
        check_kernel_device("cuda")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without")
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.compile(PORT_SUITE["C-HTWK"](), target="cuda")


@pytest.mark.parametrize("field,value,item", [
    ("precision", "mixed", "A.8"),
    ("autotune", "cached", "A.8"),
    ("autotune", "full", "A.8"),
    ("mesh", "data=4", "A.14"),
    ("sharding_rules", (("batch", "data"),), "A.14"),
    ("batch_buckets", (8,), "A.11"),
    ("buckets", "policy", "A.11"),
    ("capture", "bundle", "A.10"),
    ("cache_dir", "cache", "A.7"),
])
def test_unported_options_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.CompileOptions(**{field: value}, device="cpu")


def test_simplenn_runs_on_the_card_unless_asked_for_the_cpu():
    g = PORT_SUITE["C-HTWK"]()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.SimpleNN(g)
    out = repro_torch.SimpleNN(g, device="cpu")(**_inputs(g))
    want = repro.compile(REF_SUITE["C-HTWK"](),
                         repro.CompileOptions(target="interpret"))(**_inputs(g))
    for k, v in out.items():
        assert v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)


def test_compile_rejects_a_reference_graph():
    with pytest.raises(TypeError, match="from_reference"):
        repro_torch.compile(REF_SUITE["C-HTWK"](), device="cpu")
