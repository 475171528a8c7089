"""Persistent on-disk executable cache.

The port of ``repro.api.cache``.  The reference serializes the compiled
XLA executable; a CUDA graph cannot be serialized, so an entry here
holds what a hit lets a new process skip:

* a **graph entry** (looked up before the pass pipeline runs): the
  pipeline's output graph (folded params and ``quant.*`` attrs, in the
  ``.npz`` container of ``frontends/container.py``) and its pass report,
  so a hit runs no pass and no int8 calibration walk;
* a **program entry** per batch size: the resolved kernel selection.

After a hit, each batch size still captures its CUDA graph, which takes
milliseconds.  An entry is one file: a magic line, one JSON line, then
the raw body (the ``.npz`` bytes, or nothing) — JSON and npz, never a
pickle.  Anything unreadable degrades to a normal compile and is
removed, never an error.

Keys mix in the environment that invalidates an entry: the entry
format, torch's version, the device type and compute capability, and
the name of the CUDA kernel library (``kernels/build.py``: a hash of
the CUDA sources and flags).  The directory and the size cap come from
``REPRO_TORCH_CACHE_DIR`` and ``REPRO_TORCH_CACHE_MAX_BYTES``, which the
reference does not read, so the two packages never share a directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

_FORMAT_VERSION = 1
MAGIC = b"REPROTORCHCACHE1"
SUFFIX = ".entry"
#: Environment variable naming the default cache directory.
DIR_ENV = "REPRO_TORCH_CACHE_DIR"
#: Environment variable capping the cache's bytes; when set, every
#: ``store`` sweeps the least recently used entries out until it fits.
#: Bucketed executables add one program entry per bucket.
MAX_BYTES_ENV = "REPRO_TORCH_CACHE_MAX_BYTES"


def environment(device) -> Tuple[str, ...]:
    """The key parts of the environment an entry was made in."""
    from ..kernels import build
    dev = torch.device(device)
    where = dev.type
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        where = f"cuda sm_{major}{minor}"
    return (f"v{_FORMAT_VERSION}", f"torch {torch.__version__}", where,
            build.library_path().name)


def cache_key(device, *parts: str) -> str:
    """Digest of ``parts`` and the :func:`environment` of ``device``."""
    h = hashlib.sha256()
    for p in (*environment(device), *parts):
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def resolve_cache_dir(explicit: Optional[str]) -> Optional[str]:
    """Explicit option wins; else ``$REPRO_TORCH_CACHE_DIR``; else off."""
    return explicit if explicit is not None else os.environ.get(DIR_ENV)


def _frame(meta: dict, body: bytes) -> bytes:
    return MAGIC + b"\n" + json.dumps(meta).encode() + b"\n" + body


def _unframe(blob: bytes) -> Tuple[dict, bytes]:
    magic, meta, body = blob.split(b"\n", 2)
    if magic != MAGIC:
        raise ValueError("not an executable-cache entry")
    return json.loads(meta.decode()), body


class ExecutableCache:
    """One file per entry in a directory: ``<key>.entry``."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.hits = 0
        self.misses = 0
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + SUFFIX)

    def has(self, key: str) -> bool:
        """True if an entry is stored under ``key`` (not read)."""
        return os.path.exists(self._path(key))

    def load(self, key: str) -> Optional[Tuple[dict, bytes]]:
        """``(meta, body)`` of the entry, or None on a miss or an
        unreadable entry (which is removed)."""
        path = self._path(key)
        if not os.path.exists(path):
            self.misses += 1
            return None
        try:
            with open(path, "rb") as f:
                entry = _unframe(f.read())
        except (OSError, ValueError):
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        try:
            # LRU recency: a hit refreshes the entry's mtime so the
            # size-capped sweep evicts cold entries, not hot ones.
            os.utime(path)
        except OSError:
            pass
        return entry

    def store(self, key: str, meta: dict, body: bytes = b"") -> bool:
        """Write the entry under ``key``, atomically (a rename)."""
        try:
            blob = _frame(meta, body)
        except (TypeError, ValueError):
            return False
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        cap = os.environ.get(MAX_BYTES_ENV)
        if cap:
            try:
                prune(int(cap), self.root)
            except (OSError, ValueError):
                pass                       # the sweep is best-effort
        return True

    def stats(self) -> dict:
        """Hit/miss counters of this instance plus the directory."""
        return {"dir": self.root, "hits": self.hits, "misses": self.misses}


def _load_manifests(root: str):
    """Map manifest path -> member entry file names, for every
    ``*.manifest.json`` a :class:`~repro_torch.dist.ShardedExecutable`
    wrote beside its entries.  An unreadable manifest counts as empty
    (and so is cleaned up as dangling)."""
    out = {}
    for path in Path(root).iterdir():
        if not path.name.endswith(".manifest.json"):
            continue
        members = []
        try:
            with open(path) as f:
                members = [f"{k}{SUFFIX}"
                           for k in json.load(f).get("members", [])]
        except (OSError, ValueError, AttributeError, TypeError):
            pass
        out[path] = members
    return out


def prune(max_bytes: int, cache_dir: Optional[str] = None) -> dict:
    """Size-capped LRU sweep of the executable cache.

    Deletes least recently used entries (mtime order; ``load`` refreshes
    it on every hit) until the entries' bytes fit in ``max_bytes``, and
    clears orphaned ``.tmp`` files of interrupted writes.  Entries are
    whole files written by an atomic rename and removed whole, and a
    file that vanishes mid-sweep is skipped, so a reader racing the
    sweep sees a valid entry or a clean miss.

    A sharded executable groups its entries under a ``*.manifest.json``;
    the sweep treats each group as ONE LRU unit — its recency is its
    hottest member's, and eviction removes the members and the manifest
    together — so a pruned cache never holds a manifest pointing at
    missing entries, nor a sharded executable's entries in part.
    Manifests whose members are all gone are removed up front.

    Returns ``{"dir", "before_bytes", "after_bytes", "removed"}``.
    """
    if max_bytes < 0:
        raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
    root = resolve_cache_dir(cache_dir)
    report = {"dir": root, "before_bytes": 0, "after_bytes": 0, "removed": 0}
    if not root or not os.path.isdir(root):
        return report
    manifests = _load_manifests(root)
    grouped = {m for members in manifests.values() for m in members}
    entries = []                           # (mtime, size, [paths]): LRU units
    for path in Path(root).iterdir():
        try:
            if path.suffix == ".tmp":      # orphaned partial write
                path.unlink()
                report["removed"] += 1
                continue
            if (path.suffix != SUFFIX or path.name in grouped
                    or not path.is_file()):
                continue
            st = path.stat()
        except OSError:
            continue                       # vanished mid-sweep: skip
        entries.append((st.st_mtime, st.st_size, [path]))
    for mpath, members in manifests.items():
        group, mtime, size = [], 0.0, 0
        for member in members:
            try:
                st = (Path(root) / member).stat()
            except OSError:
                continue                   # member already gone
            group.append(Path(root) / member)
            mtime = max(mtime, st.st_mtime)
            size += st.st_size
        try:
            if not group:                  # dangling manifest: clean up
                mpath.unlink()
                report["removed"] += 1
                continue
            size += mpath.stat().st_size
        except OSError:
            continue
        entries.append((mtime, size, group + [mpath]))
    total = sum(size for _, size, _ in entries)
    report["before_bytes"] = total
    for _, size, paths in sorted(entries):  # oldest (coldest) first
        if total <= max_bytes:
            break
        removed = False
        for path in paths:                 # a group goes whole: members
            try:                           # first, the manifest last
                path.unlink()
                removed = True
            except OSError:
                continue
        if not removed:
            continue
        total -= size
        report["removed"] += 1
    report["after_bytes"] = total
    return report


def open_cache(explicit_dir: Optional[str]) -> Optional[ExecutableCache]:
    """Open the cache at ``explicit_dir`` (or the resolved default);
    None when caching is off or the directory cannot be created."""
    root = resolve_cache_dir(explicit_dir)
    if not root:
        return None
    try:
        return ExecutableCache(root)
    except OSError:
        return None
