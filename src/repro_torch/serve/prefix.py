"""PrefixCache — shared-prompt-head KV snapshots (the "system prompt"
scenario).

The port of ``repro.serve.prefix``.  Requests that share a common prompt
head would each recompute the same KV rows at prefill.  The scheduler
detects sharing (longest common prefix against the waiting queue),
prefills the head once through chunked prefill, and snapshots the
single-row cache at a chunk boundary into this LRU.  Later requests
whose prompt starts with a cached head take a COPY of the snapshot and
prefill only their tail — bit-identical to an unshared prefill, because
the snapshot holds exactly the rows a full prefill would have written
for those positions.

Copy discipline (copy-on-write): every chunk fills its cache in place,
so both directions copy —

* ``insert`` clones the producer's live cache (which the producer's
  next chunk overwrites);
* ``take`` hands the consumer a fresh clone it may fill freely.

The shared snapshot itself is therefore never written.  Both copy
from and into a *request's* own cache, never a static tensor of a
serving program: the chunk program (``serve/step.py::ChunkProgram``)
stages each request's cache through its own and writes the chunk's rows
back, so what is snapshotted and what a take fills is the request's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np

from ..models.common import tree_map


def common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common head of two 1-D token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = np.asarray(a[:n]) == np.asarray(b[:n])
    return int(n if eq.all() else np.argmin(eq))


def _clone(tree: Any) -> Any:
    return tree_map(lambda t: t.clone(), tree)


class PrefixCache:
    """LRU of prompt-head token bytes -> (head length, KV snapshot)."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, Tuple[int, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.shared_tokens = 0   # head tokens NOT recomputed, over hits

    @staticmethod
    def key_for(tokens: np.ndarray) -> bytes:
        """The cache key for a head: its int32 token bytes."""
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def insert(self, key: bytes, head_len: int, cache: Any) -> None:
        """Snapshot ``cache`` (cloned) under ``key``, evicting the
        least-recently-used entry beyond capacity."""
        self._entries[key] = (head_len, _clone(cache))
        self._entries.move_to_end(key)
        self.inserts += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def take(self, prompt: np.ndarray) -> Optional[Tuple[int, Any]]:
        """The longest cached head that is a PROPER prefix of ``prompt``
        (at least one tail token must remain to produce first-token
        logits), as ``(head_len, cache_copy)`` — or None.  Counts a hit
        or a miss; a hit refreshes LRU order."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        best_key = None
        best = None
        for key, (h, snap) in self._entries.items():
            if h >= len(prompt) or h <= (0 if best is None else best[0]):
                continue
            if prompt[:h].tobytes() == key:
                best_key, best = key, (h, snap)
        if best is None:
            self.misses += 1
            return None
        self._entries.move_to_end(best_key)
        self.hits += 1
        self.shared_tokens += best[0]
        return best[0], _clone(best[1])

    def stats(self) -> dict:
        """Hit/miss/insert/eviction counters plus the total head tokens
        whose recompute the cache avoided."""
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "shared_tokens": self.shared_tokens,
        }
