"""Async checkpointer — the port of ``repro.checkpoint.checkpointer``,
with the reference's layout byte for byte, so either package restores
the other's checkpoints:

    <root>/step_000000123.tmp/  # written here first
        manifest.json           # {"step", "n_leaves", "treedef"}
        arr_00000.npy ...       # one file per leaf, in flatten order
    <root>/step_000000123/      # atomic os.rename when complete

Leaves are taken depth first in sorted-key order (the order
``jax.tree`` flattens a dict in); ``treedef`` is the tree with each leaf
replaced by its index; bf16 is stored as a ``u2`` view (``.npy`` has no
bf16).

* **atomicity** — a crash mid-save leaves only a ``.tmp`` dir, which
  restore ignores and the next save garbage-collects;
* **async** — the device→host copy is synchronous (the train loop may
  update the state in place right after), the disk write runs on a
  thread;
* **keep-N** — bounded disk usage;
* **placement on restore** — each leaf goes to ``like``'s device, or to
  ``device`` (the reference's ``shardings``);
* **a mesh** — a mesh run's checkpoint is the same whole layout, byte
  for byte what one device writes of the same state: every leaf a rank
  holds in part (``training.StateLayout``) is gathered over each axis
  it is cut on, global rank 0 writes, and the others wait at a barrier;
  each rank restores its part of every leaf under its own mesh's
  layout (whichever mesh saved it), and one device restores it whole;
* **preemption hook** — ``install_sigterm_hook`` saves on SIGTERM, from
  the handler (for a state replaced whole by each step; the launcher,
  which updates in place, saves between steps instead).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..distributed.sharding import part_of
from ..models.common import tree_flatten, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else writes (copied off its
    device, or cloned on the CPU), bf16 viewed as u2."""
    t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(h: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """``h`` as a tensor of ``dtype`` on ``device``."""
    if dtype == torch.bfloat16 and h.dtype == np.uint16:
        t = torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(h if h.flags.c_contiguous else h.copy())
    return t.to(device=device, dtype=dtype)


def _index_tree(tree, counter=None):
    """The tree with each leaf replaced by its flatten index, dict keys
    in sorted order (the reference's ``treedef`` in its manifest)."""
    counter = counter if counter is not None else [0]
    if isinstance(tree, dict):
        return {k: _index_tree(tree[k], counter) for k in sorted(tree)}
    counter[0] += 1
    return counter[0] - 1


class Checkpointer:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             layout=None) -> None:
        """Snapshot ``tree`` (a nested dict of tensors) at ``step``.  On a
        mesh, ``layout`` (``training.StateLayout``) gathers the leaves a
        rank holds in part; its writer alone writes the whole state, and
        a blocking save ends with every rank at a barrier."""
        self.wait()  # one in-flight save at a time
        spec = _index_tree(tree)
        if layout is None:
            host = [_to_host(leaf) for _, leaf in tree_flatten(tree)]
        else:
            whole = layout.whole_leaves(tree)
            host = None if whole is None else [_to_host(t) for t in whole]
        if host is None:                      # a rank that does not write
            if blocking:
                layout.barrier()
            return

        def work():
            try:
                name = f"step_{step:09d}"
                tmp = os.path.join(self.root, name + ".tmp")
                final = os.path.join(self.root, name)
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, arr in enumerate(host):
                    np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
                manifest = {"step": step, "n_leaves": len(host),
                            "treedef": spec}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)        # atomic publish
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        if blocking:
            try:
                work()
            finally:
                if layout is not None:
                    layout.barrier()
            self.raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
        for d in os.listdir(self.root):           # stale tmp dirs
            if d.endswith(".tmp"):
                full = os.path.join(self.root, d)
                if not (self._thread and self._thread.is_alive()):
                    shutil.rmtree(full, ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.root, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None,
                layout=None) -> Any:
        """Load ``step`` into the structure, dtypes and devices of
        ``like`` (each leaf on ``device`` instead, where given).  On a
        mesh, ``layout`` says which leaves ``like`` holds in part: each
        takes its part of the whole leaf on disk (the layout of any mesh:
        the files hold every leaf whole).  Every leaf's shape is
        checked before any is read; one leaf at a time is on the host."""
        path = os.path.join(self.root, f"step_{step:09d}")
        paths, leaves = zip(*tree_flatten(like))
        files = [os.path.join(path, f"arr_{i:05d}.npy")
                 for i in range(len(leaves))]
        cuts = [(layout.part(p) or []) if layout is not None else []
                for p in paths]
        for f, leaf, cut in zip(files, leaves, cuts):
            want = list(leaf.shape)
            for dim, axes in cut:
                want[dim] *= layout.mesh.split(axes)[0]
            have = np.load(f, mmap_mode="r").shape
            if have != tuple(want):
                raise ValueError(
                    f"checkpoint leaf shape {have} != expected {tuple(want)}")
        out = []
        for f, leaf, cut in zip(files, leaves, cuts):
            if not cut:
                h = np.load(f)
            else:                   # read this rank's part alone
                h = np.array(part_of(np.load(f, mmap_mode="r"), cut,
                                     layout.mesh), order="C")
            out.append(_from_host(h, leaf.dtype,
                                  leaf.device if device is None else device))
        return tree_unflatten(list(paths), out)


def install_sigterm_hook(save_fn: Callable[[], None]) -> None:
    """Preemption handling: checkpoint before the scheduler kills us.
    ``save_fn`` runs in the handler, between any two bytecodes of the
    main thread, so what it saves must never be half updated."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)
    signal.signal(signal.SIGTERM, handler)
