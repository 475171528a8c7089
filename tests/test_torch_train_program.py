"""The one-device train step as CUDA graphs
(``training/train.py::CapturedTrainStep``, what
``make_jitted_train_step`` returns), against the reference's jitted
step, on the CPU.

* ``make_jitted_train_step`` equals ``jax.jit`` of the reference's step
  over two steps (``microbatches=2``, with ``compress_grads``, and
  ``cast_params``), within ``test_torch_training.py``'s limits;
* ``donate=False`` leaves its input state untouched; a state restored
  from a checkpoint is the one the next step reads;
* the capture's control flow, with a CUDA graph emulated on the host (a
  recording that runs nothing, a replay that runs the recorded step):
  a donated first call is the real step and the capture adds none,
  every later call one replay, bit-equal to the eager steps; another
  state's tensors (a restore) capture again; an undonated first call is
  a replay and never writes the given state; a larger batch lays the
  pool out again;
* every SMOKE config's step body issues no data-dependent op and copies
  no host value to the device (``_capture_check``).

The graphs on the card are ``tests/test_torch_training_cuda.py``'s.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map as pytree_map

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro.training import OptConfig as RefOptConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training import init_state as ref_init_state
from repro.training import make_jitted_train_step as ref_jitted_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import extra_input_specs
from repro_torch.models import common as PC
from repro_torch.models import get_model
from repro_torch.models.common import tree_flatten, tree_leaves, tree_map
from repro_torch.training import (CapturedTrainStep, OptConfig, TrainConfig,
                                  init_state, make_jitted_train_step)
from repro_torch.training import train as T
from repro_torch.training.train import make_train_step
from repro_torch.weights import params_from_reference

from _capture_check import fake, host_copies

ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
         "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base")
#: test_torch_training.py's limits: metrics, params (rtol, atol), and
#: under compress_grads the entries whose bf16 accumulator rounds the
#: other way from the reference's and how far each may move.
STEP_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
STRADDLE_MAX, STRADDLE_TOL = 4, 1e-4
MODES = {"microbatches": dict(microbatches=2),
         "compress_grads": dict(microbatches=2, compress_grads=True),
         "cast_params": dict(cast_params=True)}
OPT = dict(lr=1e-3, eps=1e-6, total_steps=10, warmup_steps=0)


def _batches(cfg, n=2, b=4, s=16):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_jitted_step_matches_reference(mode):
    """Two donated steps of each side's jitted step from the same
    start, every metric and param leaf held to the limits."""
    rcfg = dataclasses.replace(ref_config("deepseek-7b", smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(get_config("deepseek-7b", smoke=True),
                               dtype="float32")
    rm, pm = ref_model(rcfg), get_model(pcfg)
    start = jax.tree.map(np.asarray,
                         ref_init_state(rm, jax.random.PRNGKey(0)))
    r_step = ref_jitted_step(rm, RefTrainConfig(opt=RefOptConfig(**OPT),
                                                **MODES[mode]))
    p_step = make_jitted_train_step(pm, TrainConfig(opt=OptConfig(**OPT),
                                                    **MODES[mode]))
    assert isinstance(p_step, CapturedTrainStep) and p_step.donate
    r_state = jax.tree.map(jnp.asarray, start)
    p_state = params_from_reference(start)
    for batch in _batches(pcfg):
        r_state, r_met = r_step(r_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        out, p_met = p_step(p_state, batch)
        assert out is p_state
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(p_met[name]) - float(r_met[name])) \
                <= STEP_TOL, name
    assert int(p_state["opt"]["step"]) == 2
    paths = [p for p, _ in tree_flatten(p_state["params"])]
    for path, a, b in zip(paths, tree_leaves(p_state["params"]),
                          jax.tree.leaves(r_state["params"])):
        a, b = _np(a), _np(b)
        off = ~np.isclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        limit = STRADDLE_MAX if mode == "compress_grads" else 0
        assert int(off.sum()) <= limit, (path, int(off.sum()))
        assert float(np.abs(a - b).max()) <= STRADDLE_TOL, path


def test_undonated_step_leaves_its_state_and_a_restore_is_read(tmp_path):
    cfg = get_config("minicpm-2b", smoke=True)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(**OPT))
    batches = _batches(cfg, 3)
    state = init_state(model, 0, "cpu")
    before = tree_map(torch.clone, state)
    new, _ = make_jitted_train_step(model, tc, donate=False)(state,
                                                              batches[0])
    for a, b, c in zip(tree_leaves(state), tree_leaves(before),
                       tree_leaves(new)):
        assert torch.equal(a, b) and a.data_ptr() != c.data_ptr()
    # a restored state (other tensors than the step has seen) is read
    step = make_jitted_train_step(model, tc)
    ck = Checkpointer(str(tmp_path))
    step(new, batches[1])
    ck.save(1, new, blocking=True)
    want = [step(new, b)[1]["loss"] for b in batches[2:]]
    restored = ck.restore(1, new)
    got = [step(restored, b)[1]["loss"] for b in batches[2:]]
    assert got == want


class _Graph:
    """A CUDA graph emulated on the host: ``replay`` runs the recorded
    function and copies its outputs into the recording's."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        self.replays += 1
        for dst, src in zip(_tensors(self.out), _tensors(self.fn())):
            dst.copy_(src)

    def reset(self):
        self.fn = None


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


class _Recording(TorchDispatchMode):
    """Under ``mode``, every real tensor an op takes becomes its fake
    twin, so a recording computes shapes and writes nothing real (a
    ``FakeTensorMode`` alone runs an op whose inputs are all real).  A
    tensor made from a host value (``lift_fresh``) stays the mode's
    constant."""

    LIFTS = (torch.ops.aten.lift_fresh.default,
             torch.ops.aten.lift_fresh_copy.default)

    def __init__(self, mode):
        super().__init__()
        self.mode = mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.LIFTS:
            args, kwargs = pytree_map(
                lambda t: self.mode.from_tensor(t)
                if isinstance(t, torch.Tensor)
                and not isinstance(t, FakeTensor) else t,
                (args, kwargs or {}))
        return func(*args, **(kwargs or {}))


class _Pool:
    """``GraphPool``'s ordering (:meth:`GraphPool.place`) on the host."""

    def __init__(self, device):
        self.device, self.bytes, self.done = device, 0, None
        self.lock = threading.Lock()

    place = T.GraphPool.place


@pytest.fixture
def host_capture(monkeypatch):
    """CapturedTrainStep's capture on CPU states: a recording runs the
    step on fake twins of its tensors (:class:`_Recording`: nothing real
    is written) for its outputs' shapes; a replay runs the step.
    Returns the log of events."""
    log = []

    def capture(fn, device, pool, warmup=None, inference=True):
        assert not inference
        (fn if warmup is None else warmup)()
        log.append("capture")
        with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                _Recording(mode):
            shapes = fn()
        out = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                       shapes) if isinstance(shapes, dict) else (
            tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     shapes[0]),
            tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     shapes[1]))
        return _Graph(fn, out), out, 0

    def replay(pool, graph, device, copy_in, copy_out):
        log.append("replay")
        copy_in()
        graph.replay()
        return copy_out()

    class Stream:
        def synchronize(self):
            pass

    monkeypatch.setattr(T, "CAPTURE_DEVICE", "cpu")
    monkeypatch.setattr(T, "capture", capture)
    monkeypatch.setattr(T, "replay", replay)
    monkeypatch.setattr(T, "GraphPool", _Pool)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    return log


def test_donated_capture_runs_each_step_once(host_capture):
    cfg = get_config("minicpm-2b", smoke=True)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(**OPT))
    batches = _batches(cfg, 4, b=2, s=8)
    state = init_state(model, 0, "cpu")
    eager_state = tree_map(torch.clone, state)
    step, eager = CapturedTrainStep(model, tc), make_train_step(
        model, tc, donate=True)
    for i, batch in enumerate(batches[:2]):
        out, met = step(state, batch)
        _, want = eager(eager_state, batch)
        assert out is state and torch.equal(met["loss"], want["loss"])
        assert int(state["opt"]["step"]) == i + 1
    assert host_capture == ["capture", "replay"]
    assert step.captured and step.warm_ms is not None
    for a, b in zip(tree_leaves(state), tree_leaves(eager_state)):
        assert torch.equal(a, b)
    # other tensors (a restore): the graphs are dropped and the first
    # call on them is the real step again
    other = tree_map(torch.clone, state)
    for batch in batches[2:]:
        out, met = step(other, batch)
        _, want = eager(eager_state, batch)
        assert out is other and torch.equal(met["loss"], want["loss"])
    assert int(state["opt"]["step"]) == 2       # left as it was
    assert host_capture[2:] == ["capture", "replay"]
    for a, b in zip(tree_leaves(other), tree_leaves(eager_state)):
        assert torch.equal(a, b)


def test_undonated_capture_is_a_replay_that_writes_nothing(host_capture):
    cfg = get_config("minicpm-2b", smoke=True)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(**OPT))
    batches = _batches(cfg, 2, b=2, s=8) + _batches(cfg, 1, b=4, s=8)
    start = init_state(model, 0, "cpu")
    keep = tree_map(torch.clone, start)
    step, eager = CapturedTrainStep(model, tc, donate=False), \
        make_train_step(model, tc)
    state, want = start, start
    for batch in batches:
        state, met = step(state, batch)
        want, want_met = eager(want, batch)
        assert torch.equal(met["loss"], want_met["loss"])
        for a, b in zip(tree_leaves(state), tree_leaves(want)):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(start), tree_leaves(keep)):
        assert torch.equal(a, b)
    # the batch of 4 rows lays the pool out again: it is captured, then
    # the batch of 2 again; each call a replay
    assert host_capture == ["capture", "replay", "replay",
                            "capture", "capture", "replay"]
    assert len(step.graphs) == 2


@pytest.mark.parametrize("arch,tc", [
    (arch, TrainConfig()) for arch in ARCHS] + [
    ("deepseek-v3-671b", TrainConfig(microbatches=2, compress_grads=True,
                                     cast_params=True))],
    ids=list(ARCHS) + ["deepseek-v3-671b-microbatched"])
def test_step_body_is_capturable(arch, tc):
    """On fake tensors: no data-dependent op, no host value copied to the
    device; once more through two microbatches, compress_grads and
    cast_params."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)

    def build():
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32,
                                       device="meta"),
                 "labels": torch.zeros((2, 8), dtype=torch.int32,
                                       device="meta")}
        for name, (shape, dt) in extra_input_specs(cfg, 2).items():
            batch[name] = torch.empty(shape, dtype=PC.torch_dtype(dt),
                                      device="meta")
        return fake(init_state(model, 0, "meta")), fake(batch)

    assert host_copies(build, make_train_step(model, tc, donate=True)) == []
