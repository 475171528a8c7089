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

On a live mesh (``placement``) each rank stores its **local form** of
every leaf: the batch axis split over the ``batch`` rule's mesh axes
(this rank holds slots ``[row0, row0 + local_slots)``) and the axis
the model's ``cache_axes`` names ``kv_seq`` split over that rule's
axes; a dim the product does not divide stays whole (the reference's
``fit``).  The reference splits "dim 2" of every leaf of three or more
dims, which is heads in mamba2's ``state`` and the batch in
recurrentgemma's ``rec_conv``/``rec_h``; placement only, either way.
:meth:`SlotManager.gathered` and :meth:`SlotManager.keep` are the
decode step's compute view (the ``kv_seq`` parts gathered whole over
the mesh) and the write-back of this rank's part of it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..dist.collectives import LiveMesh, all_gather, broadcast, local_part
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


@dataclasses.dataclass(frozen=True)
class CachePlacement:
    """Where the batched cache lives on a live mesh: the mesh and the
    mesh axes of the ``batch`` and ``kv_seq`` rules (those the mesh
    has)."""

    mesh: LiveMesh
    batch: Tuple[str, ...]
    kv_seq: Tuple[str, ...]


class SlotManager:
    """Owns the batched KV cache (this rank's local form of it on a
    mesh) and the per-slot request states of every slot: admission
    writes one request's rows in, retirement frees them.  ``log`` is
    the owner's collective log (``record(op, axes, nbytes, ms)``), where
    the compute view's gathers are counted."""

    def __init__(self, model, slots: int, max_len: int,
                 device="cpu", placement: Optional[CachePlacement] = None,
                 log=None) -> None:
        self.slots = slots
        self.max_len = max_len
        self.axes = batch_axes(model, max_len)
        self.placement = placement
        mesh = placement.mesh if placement is not None else None
        # (parts, this rank's part) of the slots, and of each leaf's
        # kv_seq axis; (1, 0) where nothing is split.
        self.row_split = self._fit(slots, placement.batch if mesh else ())
        self.local_slots = slots // self.row_split[0]
        self.row0 = self.row_split[1] * self.local_slots
        logical = model.cache_axes() if mesh is not None else {}
        whole = dict(tree_flatten(model.init_cache(slots, max_len, "meta")))
        self.seq_axes: Dict[str, Tuple[int, int, int]] = {}
        for k, ax in logical.items():
            if "kv_seq" in ax:
                dim = ax.index("kv_seq")
                parts = self._fit(whole[k].shape[dim], placement.kv_seq)
                if parts[0] > 1:
                    self.seq_axes[k] = (dim,) + parts
        self.log = log
        with torch.inference_mode():
            if mesh is None:
                self.cache = model.init_cache(slots, max_len, device)
            else:
                self.cache = {k: torch.zeros(self._local_shape(k, t.shape),
                                             dtype=t.dtype, device=device)
                              for k, t in whole.items()}
        self._states: List[Optional[SlotState]] = [None] * slots

    def _fit(self, dim: int, axes) -> Tuple[int, int]:
        """(parts, this rank's part) of a dim of size ``dim`` split over
        ``axes``: (1, 0) when they do not divide it."""
        mesh = self.placement.mesh if self.placement else None
        if mesh is None:
            return 1, 0
        k, i = mesh.split(axes)
        return (k, i) if k > 1 and dim % k == 0 else (1, 0)

    def _local_shape(self, name: str, shape) -> Tuple[int, ...]:
        shape = list(shape)
        shape[self.axes[name]] //= self.row_split[0]
        if name in self.seq_axes:
            dim, k, _ = self.seq_axes[name]
            shape[dim] //= k
        return tuple(shape)

    def scratch(self) -> Dict[str, Any]:
        """A zeroed cache of the local form's shapes (a capture's
        warm-up runs on it, never on the live cache)."""
        return {k: torch.zeros_like(v) for k, v in self.cache.items()}

    # ------------------------------------------------------------------
    def owns(self, slot: int) -> bool:
        """True when this rank stores slot ``slot``'s rows."""
        return self.row0 <= slot < self.row0 + self.local_slots

    def local_rows(self, b: int) -> int:
        """How many of global rows ``[0, b)`` this rank stores (they are
        its local rows ``[0, local_rows(b))``)."""
        return min(max(b - self.row0, 0), self.local_slots)

    def rows(self, b: int, cache: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        """Views of local rows ``[0, b)`` of every leaf of ``cache``
        (default: the batched cache), each along its own batch axis.  A
        decode step over them writes the batched cache in place."""
        cache = self.cache if cache is None else cache
        return {k: v.narrow(self.axes[k], 0, b) for k, v in cache.items()}

    def _row(self, leaf_name: str, leaf, i: int):
        return leaf.narrow(self.axes[leaf_name], i, 1)

    def _seq_part(self, leaf_name: str, t):
        """This rank's part of a whole-sequence ``t`` of leaf
        ``leaf_name`` (t itself where the leaf's sequence is whole)."""
        if leaf_name not in self.seq_axes:
            return t
        dim, k, i = self.seq_axes[leaf_name]
        return local_part(t, k, i, dim)

    def splice(self, one_cache: Dict[str, Any], slot: int) -> None:
        """Copy the (whole, single-row) cache ``one_cache`` into row
        ``slot`` of every leaf, in place: on a mesh only on the rank
        that stores the slot, and only its part of the sequence."""
        if not self.owns(slot):
            return
        with torch.inference_mode():
            for k, dst in self.cache.items():
                self._row(k, dst, slot - self.row0).copy_(
                    self._seq_part(k, self._row(k, one_cache[k], 0)))

    def move(self, src: int, dst: int) -> None:
        """Copy slot row ``src`` over row ``dst`` in every leaf, in
        place.  Every rank takes the same branch, decided by which parts
        of the slots ``src`` and ``dst`` lie in: within one part its
        owner copies the row and the others do nothing; across parts
        ``src``'s owner sends it over the ``batch`` group (every member
        takes part; ``dst``'s owner keeps it)."""
        part = src // self.local_slots
        with torch.inference_mode():
            if part == dst // self.local_slots:
                if self.owns(src):
                    for k, leaf in self.cache.items():
                        self._row(k, leaf, dst - self.row0).copy_(
                            self._row(k, leaf, src - self.row0))
                return
            p = self.placement
            for k, leaf in self.cache.items():
                row = self._row(k, leaf, (src - self.row0)
                                if self.owns(src) else 0)
                got = broadcast(row, p.batch, p.mesh, part)
                if self.owns(dst):
                    self._row(k, leaf, dst - self.row0).copy_(got)

    # ------------------------------------------------------------------
    def gathered(self, rows: Dict[str, Any]) -> Dict[str, Any]:
        """The decode step's compute view of ``rows`` (views of local
        rows): every ``kv_seq`` leaf gathered whole over the mesh, the
        other leaves the views themselves."""
        if not self.seq_axes:
            return rows
        p = self.placement
        out = dict(rows)
        for k, (dim, _, _) in self.seq_axes.items():
            t0 = time.perf_counter()
            out[k] = all_gather(rows[k], p.kv_seq, p.mesh, dim=dim)
            if self.log is not None:
                self.log.record("all-gather", p.mesh.canonical(p.kv_seq),
                                out[k].numel() * out[k].element_size(),
                                (time.perf_counter() - t0) * 1e3)
        return out

    def keep(self, view: Dict[str, Any], rows: Dict[str, Any]) -> None:
        """Write this rank's part of a compute view's ``kv_seq`` leaves
        (the new K/V rows among them) back into ``rows``."""
        for k in self.seq_axes:
            rows[k].copy_(self._seq_part(k, view[k]))

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
