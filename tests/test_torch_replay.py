"""Capture bundles + ``python -m repro_torch.replay`` (``repro_torch.api.
capture``, ``repro_torch.replay``), against the reference's.

The contract under test, as ``tests/test_replay.py`` pins it for the
reference: a compile with ``CompileOptions(capture=...)`` writes a
self-contained bundle, and ``python -m repro_torch.replay <bundle>`` in a
*fresh process* reproduces the recorded selections (kernel, plan facts,
tactic) and outputs bit for bit (exit 0); any tampering fails the
manifest check (exit 2); a forced selection change is a divergence
(exit 1).  Three replays run in a fresh process (clean, tampered,
``--json``); the other exit codes come from the CLI's ``main`` in this
process.  The parity cases hold the bundle's layout, its seeded inputs
and its graph to the reference's, and the reference bundle's record to
the port's outputs.

Only the parity cases import the JAX package (inside the test), so the
``cuda``-marked test runs on a machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_replay.py
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch import CompileOptions
from repro_torch.api.capture import (MANIFEST, resolve_capture_dir,
                                     seeded_inputs, sha256)
from repro_torch.core import ModelBuilder
from repro_torch.frontends.container import load_model
from repro_torch.replay import (BundleError, load_manifest, replay_bundle,
                                verify_bundle)
from repro_torch.replay.__main__ import main as replay_main
from repro_torch.runtime import BucketPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(builder=ModelBuilder):
    """Wide enough that B1's grid offers several tactics per node."""
    mb = builder().seed(0)
    x = mb.input((256,))
    h = mb.dense(x, 128, activation="relu")
    out = mb.dense(h, 8)
    return mb.build([out])


def _capture(tmp_path, *, autotune="full", batches=(1,), device="cpu",
             **kw):
    bundle = os.path.join(str(tmp_path), "bundle")
    exe = repro_torch.compile(_mlp(), CompileOptions(
        target="cuda", autotune=autotune, autotune_budget_ms=20_000,
        cache_dir=os.path.join(str(tmp_path), "cache"), capture=bundle,
        device=device, **kw))
    for b in batches:
        exe.ensure_compiled(b)
    return bundle, exe


def _run_replay(bundle, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.replay", bundle, *extra],
        capture_output=True, text=True, env=env, timeout=300)


def _reseal(bundle):
    """Rewrite the manifest's hashes: a stale but valid bundle."""
    mpath = os.path.join(bundle, MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    for rel in manifest["files"]:
        manifest["files"][rel] = sha256(os.path.join(bundle, rel))
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def _files(bundle):
    return sorted(os.path.relpath(os.path.join(root, n), bundle)
                  for root, _, names in os.walk(bundle) for n in names)


# ---------------------------------------------------------------------------
# bundle contents
# ---------------------------------------------------------------------------
def test_bundle_is_self_contained(tmp_path):
    bundle, exe = _capture(tmp_path, batches=(1, 4))
    for rel in (MANIFEST, "graph.npz", "options.json", "report.json",
                "batches/1/selection.json", "batches/1/io.npz",
                "batches/1/autotune.json",
                "batches/4/selection.json", "batches/4/io.npz"):
        assert os.path.exists(os.path.join(bundle, rel)), rel
    assert os.listdir(os.path.join(bundle, "ir"))      # per-pass dumps
    assert os.listdir(os.path.join(bundle, "tactics"))  # harvested entries
    manifest = load_manifest(bundle)
    verify_bundle(bundle, manifest)
    assert sorted(manifest["batches"]) == [1, 4]
    with open(os.path.join(bundle, "report.json")) as f:
        report = json.load(f)
    assert report["graph_decisions"]["sites"]
    assert "entries" not in report["graph_decisions"]
    assert exe.capture_path == bundle
    assert set(exe._capture.seconds) == {1, 4}
    # The recorded outputs are the program's on the seeded inputs.
    io = np.load(os.path.join(bundle, "batches", "4", "io.npz"))
    got = exe(**{n: io[f"in::{n}"] for n in exe.graph.inputs})
    (name,) = exe.graph.outputs
    np.testing.assert_array_equal(got[exe.source.output_names[0]].numpy(),
                                  io[f"out::{name}"])


def test_capture_off_by_default(tmp_path):
    exe = repro_torch.compile(_mlp(), CompileOptions(target="cuda",
                                                     device="cpu"))
    exe.ensure_compiled(1)
    assert exe.capture_path is None


def test_capture_env_root_creates_subdir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CAPTURE_DIR", str(tmp_path))
    g = _mlp()
    path = resolve_capture_dir(None, g, "cuda")
    assert path == os.path.join(
        str(tmp_path), f"{g.structure_hash()[:12]}-cuda")
    exe = repro_torch.compile(g, CompileOptions(target="cuda", device="cpu"))
    exe.ensure_compiled(1)
    assert os.path.exists(os.path.join(path, MANIFEST))


def test_seeded_inputs_are_deterministic():
    g = _mlp()
    a, b = seeded_inputs(g, 2), seeded_inputs(g, 2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_capture_runs_the_pipeline_despite_a_graph_entry(tmp_path):
    """Under capture the executable cache's graph entry is not read (the
    bundle needs the pipeline's IR dumps and report); it is stored."""
    cache = os.path.join(str(tmp_path), "cache")
    first = repro_torch.compile(_mlp(), target="cuda", device="cpu",
                                cache_dir=cache)
    assert first.cache_info()["graph"] == "miss"
    again = repro_torch.compile(_mlp(), target="cuda", device="cpu",
                                cache_dir=cache)
    assert again.cache_info()["graph"] == "hit"
    bundle = os.path.join(str(tmp_path), "bundle")
    exe = repro_torch.compile(_mlp(), target="cuda", device="cpu",
                              cache_dir=cache, capture=bundle)
    assert exe.cache_info()["graph"] == "miss"
    assert len(os.listdir(os.path.join(bundle, "ir"))) == len(
        exe.report["passes"]) + 1
    with open(os.path.join(bundle, "report.json")) as f:
        assert json.load(f)["pipeline"] == list(exe.report["pipeline"])


def test_capture_under_buckets_records_each_bucket(tmp_path):
    bundle = os.path.join(str(tmp_path), "bundle")
    exe = repro_torch.compile(_mlp(), target="cuda", device="cpu",
                              buckets=BucketPolicy(batch_buckets=(1, 4)),
                              capture=bundle)
    try:
        exe.warm_up(block=True)
        x = np.ones((3, 256), np.float32)
        want = exe(x)
    finally:
        exe.shutdown()
    assert sorted(load_manifest(bundle)["batches"]) == [1, 4]
    assert replay_bundle(bundle, verbose=False)["divergences"] == []
    assert list(want) == list(exe.signature.output_names)


def test_deserialize_drops_the_capture_directory(tmp_path):
    """Serialized bytes may be untrusted: a capture directory in them is
    not written to, as the reference's deserialize drops it."""
    bundle, exe = _capture(tmp_path, autotune="off")
    shutil.rmtree(bundle)
    again = repro_torch.deserialize(exe.serialize())
    again.ensure_compiled(1)
    assert again.options.capture is None and again.capture_path is None
    assert not os.path.exists(bundle)


# ---------------------------------------------------------------------------
# replay: clean, tampered, diverged
# ---------------------------------------------------------------------------
def test_replay_clean_bundle_in_fresh_process(tmp_path):
    bundle, _ = _capture(tmp_path)
    r = _run_replay(bundle)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "replay OK" in r.stdout


def test_replay_reproduces_selections_bit_identically(tmp_path):
    bundle, exe = _capture(tmp_path, batches=(4, 1))
    result = replay_bundle(bundle, verbose=False)
    assert result["divergences"] == []
    assert result["fingerprint_match"]
    assert result["device"] == "cpu"
    assert result["batches"] == [4, 1]


def test_replay_heuristic_bundle(tmp_path, capsys):
    """autotune="off" compiles capture and replay too — no tactics, all
    heuristic, still bit-exact."""
    bundle, _ = _capture(tmp_path, autotune="off")
    assert not os.listdir(os.path.join(bundle, "tactics"))
    assert replay_main([bundle]) == 0
    assert "replay OK" in capsys.readouterr().out


def test_replay_tampered_file_exits_2(tmp_path):
    bundle, _ = _capture(tmp_path)
    sel = os.path.join(bundle, "batches", "1", "selection.json")
    with open(sel) as f:
        data = json.load(f)
    next(iter(data.values()))["kernel"] = "cuda.fused_matmul_q8"
    with open(sel, "w") as f:
        json.dump(data, f)
    r = _run_replay(bundle)
    assert r.returncode == 2
    assert "tampered" in r.stderr


def test_replay_missing_file_exits_2(tmp_path, capsys):
    bundle, _ = _capture(tmp_path)
    os.remove(os.path.join(bundle, "batches", "1", "io.npz"))
    assert replay_main([bundle]) == 2
    assert "missing" in capsys.readouterr().err


def test_replay_not_a_bundle_exits_2(tmp_path):
    assert replay_main([str(tmp_path)]) == 2


def test_replay_detects_selection_divergence(tmp_path, capsys):
    """A recorded selection that can't be reproduced (its tactic entries
    flipped to the slowest candidate, so replay resolves to another
    plan) exits 1 — the manifest is resealed so this isn't a tamper,
    it's a divergence."""
    bundle, _ = _capture(tmp_path)
    tactics = os.path.join(bundle, "tactics")
    flipped = 0
    for name in os.listdir(tactics):
        with open(os.path.join(tactics, name)) as f:
            entry = json.load(f)
        us = entry.get("measured_us") or {}
        if "winner_label" not in entry or len(us) < 2:
            continue                               # a decision, or one tactic
        loser = max(us, key=us.get)
        params = loser[loser.index("[") + 1:-1]
        tactic = (None if params == "heuristic"
                  else [int(p) for p in params.split("x")])
        if tactic == entry["tactic"]:
            continue
        entry.update(winner_label=loser, tactic=tactic)
        with open(os.path.join(tactics, name), "w") as f:
            json.dump(entry, f)
        flipped += 1
    assert flipped
    _reseal(bundle)
    assert replay_main([bundle]) == 1
    assert "DIVERGENCE" in capsys.readouterr().out


def test_replay_json_output(tmp_path):
    bundle, _ = _capture(tmp_path)
    r = _run_replay(bundle, "--json")
    assert r.returncode == 0, r.stderr
    result = json.loads(r.stdout)
    assert result["divergences"] == []
    assert result["batches"] == [1]
    assert result["device"] == "cpu"


def test_replay_never_moves_a_cuda_bundle_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bundle would replay on it")
    bundle, _ = _capture(tmp_path, autotune="off")
    opts = os.path.join(bundle, "options.json")
    with open(opts) as f:
        d = json.load(f)
    d["device"] = "cuda"
    with open(opts, "w") as f:
        json.dump(d, f)
    _reseal(bundle)
    with pytest.raises(BundleError, match="never on the CPU"):
        replay_bundle(bundle, verbose=False)


# ---------------------------------------------------------------------------
# parity with the reference's bundles
# ---------------------------------------------------------------------------
def test_bundle_file_names_equal_the_references(tmp_path):
    import repro
    from repro.core import ModelBuilder as RefBuilder
    ref_bundle = os.path.join(str(tmp_path), "ref")
    ref = repro.compile(_mlp(RefBuilder), repro.CompileOptions(
        target="pallas", capture=ref_bundle))
    port_bundle, exe = _capture(tmp_path, autotune="off", batches=(1, 4))
    for b in (1, 4):
        ref.ensure_compiled(b)
    assert _files(port_bundle) == _files(ref_bundle)
    # Each package's replay refuses the other's bundle.
    with pytest.raises(BundleError, match="format"):
        load_manifest(ref_bundle)
    from repro.replay import BundleError as RefBundleError
    from repro.replay import load_manifest as ref_load_manifest
    with pytest.raises(RefBundleError, match="format"):
        ref_load_manifest(port_bundle)


def test_seeded_inputs_equal_the_references():
    from repro.api.capture import seeded_inputs as ref_seeded
    from repro.core import ModelBuilder as RefBuilder
    rb, pb = RefBuilder(), ModelBuilder()
    for m in (rb, pb):
        m.input((5, 3), name="x")
        m.input((), name="lengths", dtype="int32")
    for batch in (1, 3):
        want = ref_seeded(rb.graph, batch)
        got = seeded_inputs(pb.graph, batch)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


def test_reference_bundle_runs_through_the_port(tmp_path):
    """The reference bundle's recorded inputs, through the port's
    compile of the bundle's graph, give its recorded outputs."""
    import repro
    from repro.core import ModelBuilder as RefBuilder
    bundle = os.path.join(str(tmp_path), "ref")
    ref = repro.compile(_mlp(RefBuilder), repro.CompileOptions(
        target="pallas", capture=bundle))
    for b in (1, 4):
        ref.ensure_compiled(b)
    exe = repro_torch.compile(load_model(os.path.join(bundle, "graph.npz")),
                              target="cuda", device="cpu")
    for b in (1, 4):
        io = np.load(os.path.join(bundle, "batches", str(b), "io.npz"))
        prog = exe.ensure_compiled(b)
        out = prog({n: torch.as_tensor(io[f"in::{n}"])
                    for n in exe.graph.inputs})
        outs = [k for k in io.files if k.startswith("out::")]
        assert outs
        for k in outs:
            np.testing.assert_allclose(out[k[len("out::"):]].numpy(), io[k],
                                       rtol=0, atol=1e-5)


def test_port_bundle_graph_loads_in_the_reference(tmp_path):
    from repro.frontends.container import load_model as ref_load
    bundle, exe = _capture(tmp_path, autotune="off")
    ref_g = ref_load(os.path.join(bundle, "graph.npz"))
    assert ref_g.structure_hash() == exe.source.structure_hash()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_record_and_replay_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bundle is recorded and "
                    "replayed on the card (chip_smoke.py's replay phase "
                    "does the same at the Table-1 models' widths)")
    bundle, exe = _capture(tmp_path, batches=(4, 1), device="cuda")
    assert exe.cost_summary()["programs"][4]["captured"]
    result = replay_bundle(bundle, verbose=False)
    assert result["divergences"] == []
    assert result["device"] == "cuda" and result["fingerprint_match"]
    shutil.rmtree(bundle)
