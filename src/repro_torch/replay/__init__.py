"""repro_torch.replay — re-run a capture bundle and diff it against the record.

The port of ``repro.replay``.  A capture bundle
(``repro_torch.api.capture``) is one directory holding everything a
compile decided: the input graph, the options, per-pass IR, every
tactic-cache entry it used, the resolved kernel selections, and recorded
input/output arrays.  This module is the other half of the contract::

    python -m repro_torch.replay <bundle>

re-runs the full pipeline from the bundle in the current process — a
fresh temp cache seeded with the bundle's tactic entries, autotune
downgraded ``full`` → ``cached`` so nothing is re-measured — on the
device the bundle was recorded on, and diffs

* the pass pipeline actually run,
* every graph-level decision winner (fusion / layout / pipeline),
* the resolved kernel selection per recorded batch: kernel, plan facts
  and tactic (the plan the program launches),
* the outputs on the recorded inputs (exact by default, ``--tol`` for
  an allclose bound),

against what the bundle recorded.  Exit codes: **0** bundle reproduces,
**1** any divergence, **2** the bundle cannot be replayed: unreadable,
tampered with (manifest hash mismatch), or recorded on a CUDA device
where there is none (a replay never falls back to the CPU).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.capture import (BUNDLE_FORMAT, CAPTURE_FORMAT_VERSION, MANIFEST,
                           sha256)


class BundleError(Exception):
    """The bundle is unreadable, unsupported, fails hash verification,
    or needs a device this machine lacks — replay exit code 2."""


def load_manifest(bundle: str) -> dict:
    """Read and structurally validate MANIFEST.json."""
    path = os.path.join(bundle, MANIFEST)
    if not os.path.isdir(bundle) or not os.path.exists(path):
        raise BundleError(f"{bundle!r} is not a capture bundle "
                          f"(no {MANIFEST})")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise BundleError(f"unreadable {MANIFEST}: {e}") from e
    if manifest.get("format") != BUNDLE_FORMAT:
        raise BundleError(f"not a repro_torch capture bundle: "
                          f"format={manifest.get('format')!r}")
    if manifest.get("version", 0) > CAPTURE_FORMAT_VERSION:
        raise BundleError(f"bundle version {manifest['version']} is newer "
                          f"than this repro_torch ({CAPTURE_FORMAT_VERSION})")
    return manifest


def verify_bundle(bundle: str, manifest: dict) -> None:
    """Check every file named by the manifest exists and hashes to its
    recorded sha256 — the tamper seal.  Raises :class:`BundleError`."""
    for rel, want in sorted(manifest.get("files", {}).items()):
        path = os.path.join(bundle, rel)
        if not os.path.exists(path):
            raise BundleError(f"bundle file missing: {rel}")
        got = sha256(path)
        if got != want:
            raise BundleError(
                f"bundle file tampered: {rel} (sha256 {got[:12]}… != "
                f"recorded {want[:12]}…)")


def _selection_identity(sel: Dict[str, dict]) -> Dict[str, tuple]:
    """The comparable identity of a kernel selection: per node the op,
    the kernel, its plan's facts and the tactic the program launches
    (reasons, sources and µs tables are presentation, not identity)."""
    out = {}
    for name, c in sel.items():
        block, tactic = c.get("block"), c.get("tactic")
        out[name] = (c.get("op"), c.get("kernel"),
                     tuple(block) if block else None,
                     tuple(tactic) if tactic else None)
    return out


def _decision_identity(report: Optional[dict]) -> List[tuple]:
    """Comparable identity of the graph-decision report: per site, the
    kind/node/digest and the winning choice (source — cached vs measured
    — is expected to differ between capture and replay)."""
    if not report:
        return []
    return sorted(
        (row.get("kind"), row.get("node"), row.get("digest"),
         row.get("winner"))
        for row in report.get("sites", []))


def _check_device(options) -> None:
    """A bundle recorded on a CUDA device replays there or not at all."""
    if (torch.device(options.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise BundleError(
            f"the bundle was recorded on device {options.device!r}, but "
            f"torch.cuda.is_available() is False here; a replay runs on "
            f"the recorded device and never on the CPU")


def replay_bundle(bundle: str, *, tol: float = 0.0,
                  verbose: bool = True) -> dict:
    """Re-run the compile recorded in ``bundle`` and diff it.

    Returns a result dict with ``divergences`` (list of human-readable
    strings; empty = clean) plus per-section detail.  Raises
    :class:`BundleError` for an invalid/tampered bundle, or one recorded
    on a CUDA device when this machine has none.
    """
    from .. import api
    from ..api.options import CompileOptions
    from ..autotune.cache import TACTICS_SUBDIR, environment_fingerprint
    from ..frontends.container import load_model

    manifest = load_manifest(bundle)
    verify_bundle(bundle, manifest)

    def say(msg: str) -> None:
        if verbose:
            print(msg)

    try:
        graph = load_model(os.path.join(bundle, "graph.npz"))
        with open(os.path.join(bundle, "options.json")) as f:
            options = CompileOptions.from_dict(json.load(f))
        with open(os.path.join(bundle, "report.json")) as f:
            recorded = json.load(f)
    except (OSError, KeyError, TypeError, ValueError) as e:
        raise BundleError(f"unreadable bundle: {e}") from e
    _check_device(options)

    divergences: List[str] = []
    fp = environment_fingerprint(options.device)
    if manifest.get("fingerprint") != fp:
        # Not fatal: the tactic cache will reject the seeded entries and
        # the pipeline falls back to heuristics — almost certainly a
        # divergence, but the diff below says exactly where.
        say("warning: environment fingerprint differs from the capture "
            "(torch version / device / kernels changed); seeded tactics "
            "will be ignored")

    with tempfile.TemporaryDirectory(prefix="repro-torch-replay-") as td:
        # Seed a fresh cache root with the bundle's tactic entries; with
        # autotune="cached" the compile resolves every decision from
        # them, deterministically, measuring nothing.
        tactics_src = os.path.join(bundle, "tactics")
        tactics_dst = os.path.join(td, TACTICS_SUBDIR)
        os.makedirs(tactics_dst, exist_ok=True)
        if os.path.isdir(tactics_src):
            for name in os.listdir(tactics_src):
                shutil.copy(os.path.join(tactics_src, name),
                            os.path.join(tactics_dst, name))
        options = options.replace(
            cache_dir=td,
            autotune="cached" if options.autotune == "full"
                     else options.autotune,
            capture=None, dump_ir=None, buckets=None, batch_buckets=())
        exe = api.compile(graph, options)

        # -- pipeline + graph decisions --------------------------------
        got_pipeline = list(exe.report.get("pipeline", ()))
        want_pipeline = list(recorded.get("pipeline", got_pipeline))
        if got_pipeline != want_pipeline:
            divergences.append(
                f"pass pipeline: recorded {want_pipeline}, "
                f"replayed {got_pipeline}")
        want_dec = _decision_identity(recorded.get("graph_decisions"))
        got_dec = _decision_identity(
            getattr(exe, "_decisions_report", None))
        if want_dec != got_dec:
            divergences.append(
                f"graph decisions: recorded {want_dec}, replayed {got_dec}")
        say(f"pipeline: {len(got_pipeline)} passes, "
            f"{len(got_dec)} graph decisions")

        # -- per-batch selection + outputs -----------------------------
        batches = manifest.get("batches", [])
        for batch in batches:
            rel = os.path.join(bundle, "batches", str(batch))
            prog = exe.ensure_compiled(batch)
            with open(os.path.join(rel, "selection.json")) as f:
                want_sel = _selection_identity(json.load(f))
            got_sel = _selection_identity({
                name: c.to_dict() for name, c in
                exe._selections.get(batch, {}).items()})
            if want_sel != got_sel:
                only_want = {k: v for k, v in want_sel.items()
                             if got_sel.get(k) != v}
                only_got = {k: v for k, v in got_sel.items()
                            if want_sel.get(k) != v}
                divergences.append(
                    f"batch {batch} kernel selection: recorded "
                    f"{only_want}, replayed {only_got}")
            io = np.load(os.path.join(rel, "io.npz"))
            # The program takes tensors by input name: on the card a
            # captured program copies host inputs into its static ones.
            env = {n: torch.as_tensor(
                       io[f"in::{n}"],
                       device=None if exe.captures else exe.device)
                   for n in exe.graph.inputs}
            with torch.inference_mode():
                out = prog(env)
            for k in io.files:
                if not k.startswith("out::"):
                    continue
                name = k[len("out::"):]
                want = io[k]
                if name not in out:
                    divergences.append(
                        f"batch {batch} output {name!r}: not produced")
                    continue
                got = out[name].cpu().numpy()
                if tol > 0:
                    ok = (got.shape == want.shape
                          and np.allclose(got, want, rtol=tol, atol=tol))
                else:
                    ok = (got.shape == want.shape
                          and np.array_equal(got, want))
                if not ok:
                    err = (float(np.max(np.abs(got.astype(np.float64)
                                               - want.astype(np.float64))))
                           if got.shape == want.shape else float("inf"))
                    divergences.append(
                        f"batch {batch} output {name!r}: max abs diff "
                        f"{err:.3e}"
                        + ("" if tol == 0 else f" (tol {tol})"))
            say(f"batch {batch}: {len(got_sel)} kernel choices, "
                f"{sum(1 for k in io.files if k.startswith('out::'))} "
                f"outputs compared")

    return {
        "bundle": bundle,
        "device": str(exe.device),
        "fingerprint_match": manifest.get("fingerprint") == fp,
        "batches": manifest.get("batches", []),
        "divergences": divergences,
    }


__all__ = ["BundleError", "load_manifest", "replay_bundle", "verify_bundle"]
