"""The port's IR, passes and model carriers against the JAX reference.

The graph-level contract is identity: the same builders give
``structure_hash``-identical graphs with equal weights, and the port's
default pipeline gives the reference's optimized graph exactly (names,
hash, params, memory plan).  Containers and ``from_reference`` carry a
graph across in both directions.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import table1_models as ref_models
from repro.core import ModelBuilder as RefBuilder
from repro.core.passes import DEFAULT_PIPELINE as REF_PIPELINE
from repro.core.passes import run_pipeline as ref_run_pipeline
from repro.frontends.container import load_model as ref_load
from repro.frontends.container import save_model as ref_save

from repro_torch import table1_models as port_models
from repro_torch.core import ModelBuilder as PortBuilder
from repro_torch.core.passes import DEFAULT_PIPELINE as PORT_PIPELINE
from repro_torch.core.passes import run_pipeline as port_run_pipeline
from repro_torch.frontends.container import load_model as port_load
from repro_torch.frontends.container import save_model as port_save
from repro_torch.weights import from_reference

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _mlp(builder):
    mb = builder().seed(7)
    x = mb.input((20,))
    h = mb.dense(x, 64, activation="tanh")
    h = mb.dense(h, 48, activation="relu")
    h = mb.dense(h, 32, activation="tanh")
    return mb.build([mb.dense(h, 9)])


def _cnn(builder):
    mb = builder().seed(1)
    x = mb.input((16, 16, 3))
    h = mb.zero_pad(x, ((1, 1), (1, 1)))
    h = mb.conv2d(h, 8, (3, 3), padding="valid")
    h = mb.batchnorm(h)
    h = mb.activation(h, "relu")
    h = mb.conv2d(h, 8, (3, 3), activation="tanh")
    h = mb.batchnorm(h)
    h = mb.maxpool(h)
    skip = h
    h = mb.conv2d(h, 8, (3, 3))
    h = mb.add(h, skip)
    h = mb.global_avg_pool(h)
    h = mb.dense(h, 10)
    return mb.build([mb.softmax(h)])


GRAPHS = {name: (ref_models.SUITE[name], port_models.SUITE[name])
          for name in ref_models.SUITE}
GRAPHS["mlp"] = (lambda: _mlp(RefBuilder), lambda: _mlp(PortBuilder))
GRAPHS["cnn"] = (lambda: _cnn(RefBuilder), lambda: _cnn(PortBuilder))


def _assert_same_graph(ref_g, port_g):
    assert port_g.structure_hash() == ref_g.structure_hash()
    assert sorted(port_g.params) == sorted(ref_g.params)
    for k, v in ref_g.params.items():
        np.testing.assert_array_equal(port_g.params[k], np.asarray(v))
    assert port_g.output_names == ref_g.output_names


def test_default_pipeline_names_match():
    assert PORT_PIPELINE == REF_PIPELINE


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_builders_match_reference(name):
    """The port's builders (Table-1 copy, ModelBuilder) give the
    reference's graph: same structure hash, bit-equal weights."""
    make_ref, make_port = GRAPHS[name]
    _assert_same_graph(make_ref(), make_port())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pipeline_matches_reference(name):
    make_ref, make_port = GRAPHS[name]
    ref_g, ref_report = ref_run_pipeline(make_ref())
    port_g, port_report = port_run_pipeline(make_port())
    assert port_report["pipeline"] == ref_report["pipeline"]
    _assert_same_graph(ref_g, port_g)
    assert port_report["memory_plan"] == ref_report["memory_plan"]
    for rp, pp in zip(ref_report["passes"], port_report["passes"]):
        strip = lambda d: {k: v for k, v in d.items() if k != "time_ms"}
        assert strip(pp) == strip(rp)


@pytest.mark.parametrize("name", ["C-HTWK", "MobileNetV2", "cnn"])
@pytest.mark.parametrize("optimized", [False, True])
def test_container_round_trips_both_ways(name, optimized):
    make_ref, make_port = GRAPHS[name]
    ref_g, port_g = make_ref(), make_port()
    if optimized:
        ref_g, _ = ref_run_pipeline(ref_g)
        port_g, _ = port_run_pipeline(port_g)
    buf = io.BytesIO()
    ref_save(ref_g, buf)
    buf.seek(0)
    _assert_same_graph(ref_g, port_load(buf))
    buf = io.BytesIO()
    port_save(port_g, buf)
    buf.seek(0)
    _assert_same_graph(ref_load(buf), port_g)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_from_reference_carries_graph_and_weights(name):
    make_ref, _ = GRAPHS[name]
    ref_g = make_ref()
    port_g = from_reference(ref_g)
    _assert_same_graph(ref_g, port_g)
    # Optimized reference graphs (oi layouts, folded affines) carry too.
    ref_opt, _ = ref_run_pipeline(ref_g)
    _assert_same_graph(ref_opt, from_reference(ref_opt))


def test_from_reference_with_named_outputs():
    mb = RefBuilder().seed(3)
    x = mb.input((6,))
    a = mb.dense(x, 4)
    b = mb.dense(x, 2)
    ref_g = mb.build({"logits": a, "aux": b})
    port_g = from_reference(ref_g)
    _assert_same_graph(ref_g, port_g)
    assert port_g.output_names == ["logits", "aux"]


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch imports without jax or the reference:
    the frontends, the capture bundles and the replay CLI among them."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.frontends.trace', 'repro_torch.frontends.builder',\n"
        "          'repro_torch.api.capture', 'repro_torch.replay',\n"
        "          'repro_torch.replay.__main__', 'repro_torch.core.compiler',\n"
        "          'repro_torch.dist.executable', 'repro_torch.distributed.fault'):\n"
        "    assert m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25
