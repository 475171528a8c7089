"""Persistent on-disk tactic cache — measure once, remember forever.

The port of ``repro.autotune.cache``.  The executable cache
(``repro_torch.api.cache``) lets a new process skip the pass pipeline;
this cache lets it skip *measurement*.  A tactic entry records, for one
descriptor (a node's op, shapes, dtypes, batch, target and device, or a
graph-decision site, or a mixed-precision site), which tactic won and
what every candidate measured, so a second process compiling the same
shapes gets the winner without measuring again.

Keys are fingerprinted like the executable cache's: the digest mixes in
the entry format, torch's version, the device's name and compute
capability, the name of the CUDA kernel library (a hash of its sources
and flags, ``kernels/build.py``) and the lowering rules effective under
``cuda``, so editing a kernel or moving to another card misses cleanly
instead of serving a stale winner.  The fingerprint is also stored in
each entry and checked on load: a file copied between environments
degrades to the heuristic, never to a wrong tactic.  Entries are plain
JSON (``cat`` one to see why a tactic won); any parse or validation
failure drops the entry and falls back to the heuristic, never to an
error.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import torch

from ..api.cache import resolve_cache_dir

TACTIC_FORMAT_VERSION = 1

#: Subdirectory of the shared cache root (``$REPRO_TORCH_CACHE_DIR`` or
#: the explicit ``CompileOptions.cache_dir``) holding tactic entries.
TACTICS_SUBDIR = "tactics"


def environment_fingerprint(device) -> str:
    """Everything environmental that invalidates a measurement on
    ``device``: the format version, torch's version, the device's name
    and compute capability (``"cpu"`` for the CPU), the kernel library's
    name and the ``cuda`` lowering-rule set."""
    from ..core.lowering import lowering_fingerprint
    from ..kernels import build

    dev = torch.device(device)
    where = "cpu"
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        where = f"{torch.cuda.get_device_name(dev)} sm_{major}{minor}"
    h = hashlib.sha256()
    for p in (f"v{TACTIC_FORMAT_VERSION}", f"torch {torch.__version__}",
              where, build.library_path().name,
              lowering_fingerprint("cuda")):
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def tactic_key(desc: Mapping[str, Any], fingerprint: str) -> str:
    """Digest of a tactic descriptor (the per-shape identity of one
    decision) and the environment fingerprint."""
    payload = json.dumps(desc, sort_keys=True, default=str)
    return hashlib.sha256(f"{fingerprint}\x00{payload}".encode()).hexdigest()


class TacticCache:
    """JSON-per-entry directory cache of measured winners."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.hits = 0
        self.misses = 0
        self.stores = 0
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def load(self, key: str, fingerprint: str) -> Optional[Dict[str, Any]]:
        """A validated entry, or None on a miss, a corrupt entry (removed,
        so it stops costing a parse) or a stale one (kept: it may be valid
        for the environment that wrote it)."""
        path = self._path(key)
        if not os.path.exists(path):
            self.misses += 1
            return None
        try:
            with open(path) as f:
                entry = json.load(f)
            if not isinstance(entry, dict):
                raise ValueError("tactic entry is not an object")
            if not isinstance(entry.get("winner"), str):
                raise ValueError("tactic entry has no winner")
            if entry.get("fingerprint") != fingerprint:
                self.misses += 1
                return None
            for f in ("block", "tactic"):
                if entry.get(f) is not None:
                    entry[f] = tuple(int(b) for b in entry[f])
            self.hits += 1
            return entry
        except Exception:
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            return None

    def store(self, key: str, entry: Dict[str, Any]) -> bool:
        """Write ``entry`` under ``key``; atomic through a rename, so two
        processes tuning the same shapes never interleave bytes."""
        try:
            blob = json.dumps(entry, indent=2, sort_keys=True, default=str)
        except (TypeError, ValueError):
            return False
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
            self.stores += 1
            return True
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def stats(self) -> dict:
        """Hit/miss/store counters of this instance and its directory."""
        return {"dir": self.root, "hits": self.hits, "misses": self.misses,
                "stores": self.stores}


def open_tactic_cache(explicit_dir: Optional[str]) -> Optional[TacticCache]:
    """The tactic cache under ``<cache root>/tactics``, resolved as the
    executable cache's root (the explicit option, else
    ``$REPRO_TORCH_CACHE_DIR``, else off)."""
    root = resolve_cache_dir(explicit_dir)
    if not root:
        return None
    try:
        return TacticCache(os.path.join(root, TACTICS_SUBDIR))
    except OSError:
        return None
