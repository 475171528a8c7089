"""Capture bundles — one directory that reproduces one compile.

The port of ``repro.api.capture``.  ``CompileOptions(capture=<dir>)``
(or ``$REPRO_TORCH_CAPTURE_DIR``, a root that gets one subdirectory per
compile) makes :class:`~repro_torch.api.targets.JitExecutable` record
everything ``python -m repro_torch.replay <bundle>`` needs to re-run the
compile in a fresh process and diff it against the record:

.. code-block:: text

    <bundle>/
      MANIFEST.json      format version, env fingerprint, sha256 of
                         every other file (tamper detection)
      graph.npz          the *input* graph (pre-pass), container format
      options.json       CompileOptions.to_dict()
      report.json        pass pipeline report + graph-decision report
      ir/NN-<pass>.txt   per-pass IR dumps (teed from dump_ir)
      tactics/<key>.json every tactic-cache entry the compile used —
                         kernel tactics and graph decisions — so replay
                         seeds a fresh cache and resolves identically
                         with autotune="cached"
      batches/<B>/
        selection.json   resolved kernel selection for batch B
        autotune.json    the tactic tuner's report (when tuned)
        io.npz           seeded synthetic inputs + recorded outputs

The bundle is self-contained (weights included via ``graph.npz``, which
the reference's container loader reads too) and incremental: the
manifest is rewritten after every record, so a bundle from a crashed
process is still replayable up to the last record.

"Capture" names two things in this port.  A :class:`CaptureSession`
records a *compile* into a bundle directory, as the reference's does.
A :class:`~repro_torch.core.program.CapturedProgram` is one batch size's
program captured as a *CUDA graph* (``core/program.py``).  A bundle
records the outputs of that captured program's replay on its device.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

from ..core.graph import Graph
from ..frontends.container import save_model

#: Bundle layout version; replay refuses newer bundles.
CAPTURE_FORMAT_VERSION = 1

MANIFEST = "MANIFEST.json"

#: The manifest's ``format``: the reference's replay refuses a bundle of
#: the port, and the port's replay a bundle of the reference.
BUNDLE_FORMAT = "repro_torch-capture"

#: Environment variable naming a capture *root*: every compile writes a
#: bundle into a fresh ``<structhash12>-<target>`` subdirectory of it.
CAPTURE_DIR_ENV = "REPRO_TORCH_CAPTURE_DIR"


def resolve_capture_dir(explicit: Optional[str], graph: Graph,
                        target: str) -> Optional[str]:
    """The bundle directory for one compile: an explicit
    ``CompileOptions.capture`` *is* the bundle dir;
    ``$REPRO_TORCH_CAPTURE_DIR`` is a root that gets a per-compile
    subdirectory (so a sweep run under the env var captures every
    config separately)."""
    if explicit:
        return explicit
    root = os.environ.get(CAPTURE_DIR_ENV)
    if not root:
        return None
    sub = f"{graph.structure_hash()[:12]}-{target}"
    return os.path.join(root, sub)


def seeded_inputs(graph: Graph, batch_size: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic inputs for one batch specialization, from
    ``default_rng(0)`` as in the reference: the same bytes in both
    packages, so capture and replay agree without shipping real
    traffic."""
    rng = np.random.default_rng(0)
    out: Dict[str, np.ndarray] = {}
    for name, spec in graph.inputs.items():
        a = rng.standard_normal((batch_size,) + spec.shape)
        out[name] = a.astype(spec.dtype)
    return out


def sha256(path: str) -> str:
    """Hex sha256 of one file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CaptureSession:
    """Incrementally records one compile into a bundle directory.

    Not to be confused with :class:`~repro_torch.core.program.
    CapturedProgram`, a CUDA graph (see the module's note).  Created by
    :class:`~repro_torch.api.targets.JitExecutable` when capture is
    enabled; every ``record_*`` call writes its files and refreshes the
    manifest, so the bundle is valid after each step.  ``seconds`` holds,
    by batch size, what recording it took (the executable's record: the
    seeded call, the host copy of its outputs, the writes and the
    manifest)."""

    def __init__(self, bundle_dir: str, graph: Graph, options,
                 *, lowering_target: str, device) -> None:
        from ..autotune.cache import environment_fingerprint

        self.dir = bundle_dir
        self.ir_dir = os.path.join(bundle_dir, "ir")
        os.makedirs(self.ir_dir, exist_ok=True)
        os.makedirs(os.path.join(bundle_dir, "tactics"), exist_ok=True)
        self._fingerprint = environment_fingerprint(device)
        self._report: dict = {}
        self.seconds: Dict[int, float] = {}
        with open(os.path.join(bundle_dir, "graph.npz"), "wb") as f:
            save_model(graph, f)
        self._write_json("options.json", options.to_dict())
        self._write_json("report.json", self._report)
        self._meta = {"lowering_target": lowering_target, "batches": []}
        self.refresh_manifest()

    # -- recording -----------------------------------------------------
    def _write_json(self, rel: str, obj) -> None:
        path = os.path.join(self.dir, rel)
        os.makedirs(os.path.dirname(path) or self.dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=2, sort_keys=True, default=str)

    def _store_tactics(self, entries: Optional[Dict[str, dict]]) -> None:
        """Persist raw tactic-cache entries (kernel or graph-decision)
        under ``tactics/<key>.json`` — exactly the on-disk format of
        :class:`~repro_torch.autotune.cache.TacticCache`, so replay can
        copy them into a fresh cache directory verbatim."""
        for key, entry in (entries or {}).items():
            self._write_json(os.path.join("tactics", f"{key}.json"), entry)

    def record_pipeline(self, pass_report: dict,
                        decisions_report: Optional[dict]) -> None:
        """Record the pass pipeline outcome and the graph-decision
        report (winners + per-candidate µs), harvesting decision cache
        entries into ``tactics/``."""
        self._report["pipeline"] = list(pass_report.get("pipeline", ()))
        self._report["passes"] = [dict(row) for row in
                                  pass_report.get("passes", [])]
        if decisions_report is not None:
            pub = {k: v for k, v in decisions_report.items()
                   if k != "entries"}
            self._report["graph_decisions"] = pub
            self._store_tactics(decisions_report.get("entries"))
        self._write_json("report.json", self._report)
        self.refresh_manifest()

    def record_batch(self, batch_size: int, selection,
                     autotune_report: Optional[dict],
                     inputs: Dict[str, np.ndarray],
                     outputs: Dict[str, np.ndarray]) -> None:
        """Record one batch specialization: the resolved kernel
        selection, its autotune report, and the seeded input / recorded
        output arrays replay diffs against (outputs keyed by the
        optimized graph's output tensors, as the program returns them)."""
        rel = os.path.join("batches", str(batch_size))
        self._write_json(
            os.path.join(rel, "selection.json"),
            {name: choice.to_dict()
             for name, choice in sorted(selection.items())})
        if autotune_report is not None:
            pub = {k: v for k, v in autotune_report.items()
                   if k != "entries"}
            self._write_json(os.path.join(rel, "autotune.json"), pub)
            self._store_tactics(autotune_report.get("entries"))
        arrays = {f"in::{k}": np.asarray(v) for k, v in inputs.items()}
        arrays.update({f"out::{k}": np.asarray(v)
                       for k, v in outputs.items()})
        np.savez(os.path.join(self.dir, rel, "io.npz"), **arrays)
        if batch_size not in self._meta["batches"]:
            self._meta["batches"].append(batch_size)
        self.refresh_manifest()

    # -- manifest ------------------------------------------------------
    def refresh_manifest(self) -> None:
        """(Re)write MANIFEST.json with a sha256 of every bundle file —
        the tamper seal ``repro_torch.replay`` verifies before trusting
        the record."""
        files = {}
        for root, _, names in os.walk(self.dir):
            for name in sorted(names):
                if name == MANIFEST:
                    continue
                path = os.path.join(root, name)
                rel = os.path.relpath(path, self.dir)
                files[rel] = sha256(path)
        manifest = {
            "format": BUNDLE_FORMAT,
            "version": CAPTURE_FORMAT_VERSION,
            "fingerprint": self._fingerprint,
            **self._meta,
            "files": files,
        }
        tmp = os.path.join(self.dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, os.path.join(self.dir, MANIFEST))
