"""The port's checkpointer: the reference's seven checkpoint cases
(``tests/test_checkpoint.py``: round trip, async save, keep-N, stale tmp
dirs, shape mismatch, placement on restore, a launcher-level resume), and
the layout shared with the JAX package: a checkpoint the port writes
restores bit-equal in the reference and the reverse, bf16 leaves
included, with the same files and manifest."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.checkpoint import Checkpointer, install_sigterm_hook
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.weights import params_from_reference, state_to_numpy


@pytest.fixture()
def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _equal(t1, t2):
    for a, b in zip(tree_leaves(t1), tree_leaves(t2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree, blocking=True)
    out = ck.restore(3, tree)
    _equal(tree, out)
    assert tree_leaves(out)[0].dtype == torch.float32


def test_async_save_then_wait(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    ck.wait()
    assert ck.all_steps() == [1]


def test_async_save_snapshots_before_in_place_writes(tmp_path, tree):
    """The host copy is taken before save returns: a train step that
    updates the state in place right after cannot reach the file."""
    ck = Checkpointer(str(tmp_path))
    want = {k: v for k, v in tree.items()}
    want["a"] = tree["a"].clone()
    ck.save(2, tree)
    tree["a"].add_(100.0)
    ck.wait()
    _equal(ck.restore(2, want), want)


def test_keep_n_gc(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4]


def test_tmp_dirs_ignored_and_cleaned(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    # a crashed save: tmp dir without manifest
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert ck.all_steps() == []
    ck.save(10, tree, blocking=True)
    assert ck.latest_step() == 10
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_restore_shape_mismatch_raises(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, tree, blocking=True)
    bad = dict(tree)
    bad["a"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        ck.restore(0, bad)


def test_restore_places_on_device(tmp_path, tree):
    """The port's analogue of the reference's elastic restore with
    shardings: each leaf goes to ``device`` when given, else to the
    device of its ``like`` leaf; a leaf stored in another dtype takes
    ``like``'s."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree, blocking=True)
    out = ck.restore(5, tree, device="cpu")
    _equal(tree, out)
    assert all(x.device == torch.device("cpu") for x in tree_leaves(out))
    like = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
            "b": tree["b"]}
    out = ck.restore(5, like)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"].to(torch.bfloat16))


def test_sigterm_hook_saves_then_exits(tmp_path, tree):
    import signal
    ck = Checkpointer(str(tmp_path))
    before = signal.getsignal(signal.SIGTERM)
    try:
        install_sigterm_hook(lambda: ck.save(4, tree, blocking=True))
        with pytest.raises(SystemExit) as e:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, before)
    _equal(ck.restore(4, tree), tree)


def test_train_resume_continues_step_count(tmp_path):
    """Full launcher-level resume: run 6 steps, stop, resume to 10."""
    from repro_torch.launch.train import main
    ck = str(tmp_path / "ck")
    args = ["--arch", "minicpm-2b", "--smoke", "--batch", "2",
            "--seq", "16", "--ckpt", ck, "--ckpt-every", "3",
            "--log-every", "100", "--device", "cpu"]
    assert main(args + ["--steps", "6"]) == 0
    assert main(args + ["--steps", "10"]) == 0
    steps = Checkpointer(ck).all_steps()
    assert 9 in steps


# ---------------------------------------------------------------------------
# One layout for both packages
# ---------------------------------------------------------------------------
def _ref_tree():
    rng = np.random.default_rng(3)
    return {
        "params": {
            "w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
            "h": jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16),
            "layers": {"b": jnp.asarray(rng.standard_normal((3,)),
                                        jnp.float32)}},
        "opt": {"step": jnp.int32(12),
                "m": {"w": jnp.asarray(rng.standard_normal((4, 3)),
                                       jnp.float32)}},
    }


def _ref_equal(ref, port):
    want, got = jax.tree.leaves(ref), tree_leaves(port)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        b = state_to_numpy(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


def test_port_checkpoint_restores_bit_equal_in_reference(tmp_path):
    ref = _ref_tree()
    port = params_from_reference(jax.tree.map(np.asarray, ref))
    Checkpointer(str(tmp_path)).save(12, port, blocking=True)
    out = RefCheckpointer(str(tmp_path)).restore(12, ref)
    _ref_equal(out, port)
    assert out["params"]["h"].dtype == jnp.bfloat16


def test_reference_checkpoint_restores_bit_equal_in_port(tmp_path):
    ref = _ref_tree()
    like = params_from_reference(jax.tree.map(np.asarray, ref))
    like = tree_map(torch.zeros_like, like)
    RefCheckpointer(str(tmp_path)).save(12, ref, blocking=True)
    out = Checkpointer(str(tmp_path)).restore(12, like)
    _ref_equal(ref, out)
    assert out["params"]["h"].dtype == torch.bfloat16


def test_same_files_and_manifest_as_reference(tmp_path):
    ref = _ref_tree()
    port = params_from_reference(jax.tree.map(np.asarray, ref))
    RefCheckpointer(str(tmp_path / "ref")).save(7, ref, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(7, port, blocking=True)
    a, b = (tmp_path / d / "step_000000007" for d in ("ref", "port"))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names[-1] == "manifest.json" and len(names) == 6
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names, (mismatch, errors)
    with open(b / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == 5 and manifest["step"] == 7
