"""Slot / KV-cache manager: the memory half of continuous batching.

The port of ``repro.serve.slots``.  Owns the batched cache (the paper:
"input and output tensors are owned by CompiledNN because it needs
control over the actual memory layout") and the per-slot host
bookkeeping.  Admission splices a freshly prefilled single-row cache
into a free slot; eviction just marks the slot free — the row is
overwritten by the next admission, so no memory moves on retire.

The cache tensors are made once and never replaced: splice and move
write rows in place (slice assignment), and the decode steps run over
views of them (:meth:`SlotManager.rows`), so a captured step's
addresses stay valid for the scheduler's life.

Each leaf's batch axis is read from the model itself: the axis where
``init_cache(1, L)`` and ``init_cache(2, L)`` differ
(:func:`batch_axes`).  The reference assumes axis 1 for every leaf of
two or more dimensions, which holds for every family but
recurrentgemma, whose ``rec_conv``/``rec_h`` carry the batch on axis 2
(``(blocks, 2, B, ...)``): there the reference splices a row into the
wrong place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.common import tree_flatten


@dataclasses.dataclass
class SlotState:
    """Host-side record for one occupied decode slot."""

    uid: int
    remaining: int           # decode steps left before forced retire
    eos_id: int              # -1 = never
    temperature: float


def batch_axes(model, max_len: int) -> Dict[str, int]:
    """``{leaf name: batch axis}`` of ``model``'s cache: the one axis on
    which a cache of 1 row and one of 2 rows differ (on the meta device,
    nothing allocated)."""
    one = dict(tree_flatten(model.init_cache(1, max_len, "meta")))
    two = dict(tree_flatten(model.init_cache(2, max_len, "meta")))
    axes = {}
    for name, a in one.items():
        diff = [i for i, (x, y) in enumerate(zip(a.shape, two[name].shape))
                if x != y]
        if len(diff) != 1 or a.shape[diff[0]] != 1:
            raise ValueError(
                f"cache leaf {name!r}: no single batch axis "
                f"({tuple(a.shape)} for 1 row, {tuple(two[name].shape)} "
                f"for 2)")
        axes[name] = diff[0]
    return axes


class SlotManager:
    """Owns the batched KV cache and the per-slot request states:
    admission writes one request's rows in, retirement frees them."""

    def __init__(self, model, slots: int, max_len: int,
                 device="cpu") -> None:
        self.slots = slots
        self.max_len = max_len
        self.axes = batch_axes(model, max_len)
        with torch.inference_mode():
            self.cache = model.init_cache(slots, max_len, device)
        self._states: List[Optional[SlotState]] = [None] * slots

    # ------------------------------------------------------------------
    def rows(self, b: int, cache: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        """Views of rows ``[0, b)`` of every leaf of ``cache`` (default:
        the batched cache), each along its own batch axis.  A decode
        step over them writes the batched cache in place."""
        cache = self.cache if cache is None else cache
        return {k: v.narrow(self.axes[k], 0, b) for k, v in cache.items()}

    def _row(self, leaf_name: str, leaf, i: int):
        return leaf.narrow(self.axes[leaf_name], i, 1)

    def splice(self, one_cache: Dict[str, Any], slot: int) -> None:
        """Copy the single-row cache ``one_cache`` into row ``slot`` of
        every leaf, in place."""
        with torch.inference_mode():
            for k, dst in self.cache.items():
                self._row(k, dst, slot).copy_(
                    self._row(k, one_cache[k], 0))

    def move(self, src: int, dst: int) -> None:
        """Copy slot row ``src`` over row ``dst`` in every leaf, in
        place."""
        with torch.inference_mode():
            for k, leaf in self.cache.items():
                self._row(k, leaf, dst).copy_(self._row(k, leaf, src))

    # ------------------------------------------------------------------
    def buffer_pointers(self) -> Tuple[int, ...]:
        """The device address of every cache leaf — the handle
        zero-allocation tests use: across steady-state decode steps every
        pointer stays the same (the cache is updated in place, never
        reallocated)."""
        return tuple(t.data_ptr() for _, t in tree_flatten(self.cache))

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        """Indices of empty slots."""
        return [s for s, st in enumerate(self._states) if st is None]

    def active_slots(self) -> List[int]:
        """Indices of occupied slots."""
        return [s for s, st in enumerate(self._states) if st is not None]

    def num_active(self) -> int:
        """Number of occupied slots."""
        return sum(st is not None for st in self._states)

    def state(self, slot: int) -> Optional[SlotState]:
        """The request state in ``slot`` (None when free)."""
        return self._states[slot]

    # ------------------------------------------------------------------
    def admit(self, slot: int, state: SlotState, one_cache: Any) -> None:
        """Occupy ``slot`` with ``state``, splicing its prefilled
        single-row cache into the batched cache."""
        if self._states[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied "
                               f"(uid={self._states[slot].uid})")
        self.splice(one_cache, slot)
        self._states[slot] = state

    def evict(self, slot: int) -> SlotState:
        """Free ``slot``; the cache row is left in place and simply
        overwritten by the next admission."""
        st = self._states[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} is already free")
        self._states[slot] = None
        return st

    # ------------------------------------------------------------------
    def compact(self) -> List[Tuple[int, int]]:
        """Move active rows down so they occupy the prefix ``[0, k)`` —
        the invariant bucketed decode needs to run over the first ``k``
        cache rows.  Each hole below ``k`` is filled by the *highest*
        active row (one move per hole, no cascades).  Returns the
        ``(src, dst)`` moves so the caller can mirror them in host-side
        per-slot state (``last_token``)."""
        moves: List[Tuple[int, int]] = []
        while True:
            active = self.active_slots()
            k = len(active)
            hole = next((s for s in range(k)
                         if self._states[s] is None), None)
            if hole is None:
                return moves
            src = active[-1]
            self.move(src, hole)
            self._states[hole], self._states[src] = self._states[src], None
            moves.append((src, hole))
