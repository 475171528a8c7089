"""What a CUDA graph capture refuses, checked on the CPU.

A captured body must issue no data-dependent op (``.item()``,
``nonzero``, a boolean mask: the host would wait for the device, which
a capture refuses) and copy no host value to the device (a pageable
copy, which a capture refuses or freezes at the captured value).
:func:`host_copies` runs a body under ``FakeTensorMode`` on fake tensors
of the ``meta`` device: a data-dependent op on a tensor derived from the
inputs raises there, so does an op on a real tensor made on the device
from a host value (``torch.as_tensor(x, device=...)``: the mode takes
fake inputs only), and :class:`HostCopies` lists every op that takes a
host tensor and makes a device one.  Fake tensors of the ``cuda`` device
cannot run on a CPU-only torch ("not linked with support for cuda
devices"); ``meta`` stands for the card: every op the body issues on
the inputs' device is on it, and anything from the host shows.  Host
arithmetic on constants (``float(torch.tensor(...))``) stays on the
host and is not flagged.
"""

from typing import Any, Callable, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

DEVICE = "meta"


class HostCopies(TorchDispatchMode):
    """Records each op that takes a host tensor and returns a device one."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "cpu" for t in ins) and \
                any(t.device.type == DEVICE for t in outs):
            self.ops.append(str(func))
        return out


def fake(tree):
    """A fake tensor on the meta device of each meta leaf of ``tree``
    (under the active ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: fake(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=DEVICE)


def host_copies(build: Callable[[], Any], run: Callable[..., Any]
                ) -> List[str]:
    """``run(*build())`` under ``FakeTensorMode`` (``build`` makes its
    fake inputs there): the host-to-device ops it issued.  A
    data-dependent op raises."""
    with FakeTensorMode(allow_non_fake_inputs=False):
        args = build()
        with HostCopies() as seen:
            run(*args)
    return seen.ops
