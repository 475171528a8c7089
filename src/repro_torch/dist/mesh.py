"""MeshSpec — the device mesh as a frozen, serializable compile input.

The port of ``repro.dist.mesh``.  A live mesh holds process groups,
which makes it unsuitable as a field of :class:`repro_torch.CompileOptions`
(options must be hashable, comparable and JSON-serializable so they
double as cache-key material).  ``MeshSpec`` is the static description —
ordered ``(axis_name, size)`` pairs — and ``build()`` late-binds it to
the ranks of the default ``torch.distributed`` process group, one rank
a device, raising a typed :class:`MeshUnavailableError` naming the axes
that cannot be filled when the group is too small.  With no process
group initialised one device is visible: the caller's.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple


class MeshUnavailableError(RuntimeError):
    """The visible devices cannot realize a :class:`MeshSpec`.

    Raised at executable construction and before each sharded call when
    the visible device set (the default process group's ranks) is
    smaller than what the mesh needs.  ``missing_axes`` names the axes
    that can no longer be filled, in mesh order.
    """

    def __init__(self, spec: "MeshSpec", available: int) -> None:
        self.spec = spec
        self.available = available
        self.needed = spec.size
        self.missing_axes = spec.missing_axes(available)
        super().__init__(
            f"mesh {spec.describe()} needs {self.needed} device(s) but only "
            f"{available} are visible; axes that cannot be filled: "
            f"{', '.join(self.missing_axes) or '(none)'}")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh described by ordered ``(axis_name, size)`` pairs.

    The canonical data×model mesh is
    ``MeshSpec(axes=(("data", 4), ("model", 2)))`` — batch rows shard
    over ``data``, tensor-parallel dims over ``model``.  Accepts a dict
    (``{"data": 4, "model": 2}``, insertion-ordered) or a sequence of
    pairs; ``parse`` accepts the CLI spelling ``"data=4,model=2"``.
    """

    axes: Tuple[Tuple[str, int], ...] = (("data", 1),)

    def __post_init__(self) -> None:
        axes = self.axes
        if isinstance(axes, dict):
            axes = tuple(axes.items())
        axes = tuple((str(n), int(s)) for n, s in axes)
        if not axes:
            raise ValueError("mesh needs at least one axis")
        names = [n for n, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names in {names}")
        for n, s in axes:
            if s <= 0:
                raise ValueError(f"mesh axis {n!r} must have positive "
                                 f"size, got {s}")
        object.__setattr__(self, "axes", axes)

    # -- construction ---------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Build from the CLI spelling, e.g. ``"data=4,model=2"``."""
        axes = []
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad mesh axis {part!r}; expected name=size "
                    f"(e.g. 'data=4,model=2')")
            name, size = part.split("=", 1)
            axes.append((name.strip(), int(size)))
        return cls(axes=tuple(axes))

    @classmethod
    def coerce(cls, value) -> "MeshSpec":
        """Normalize any accepted spelling (MeshSpec, dict-of-sizes,
        ``to_dict`` output, pair sequence, or ``"data=4"`` string)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls.parse(value)
        if isinstance(value, dict):
            if set(value) == {"axes"}:         # to_dict round trip
                return cls(axes=tuple(tuple(p) for p in value["axes"]))
            return cls(axes=tuple(value.items()))
        return cls(axes=tuple(tuple(p) for p in value))

    # -- queries --------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        """Axis names, in mesh order."""
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Axis sizes, in mesh order."""
        return tuple(s for _, s in self.axes)

    @property
    def size(self) -> int:
        """Total number of devices the mesh needs."""
        return math.prod(self.shape)

    @property
    def is_single_device(self) -> bool:
        """True when every axis has size 1 (the degenerate mesh that
        must stay bit-identical to the unsharded path)."""
        return self.size == 1

    def axis_size(self, name: str) -> int:
        """Size of axis ``name``; 1 for axes the mesh does not have."""
        return dict(self.axes).get(name, 1)

    def missing_axes(self, available: int) -> Tuple[str, ...]:
        """Axes that cannot be filled with ``available`` devices: the
        cumulative device product overflows at and after these axes."""
        missing = []
        running = 1
        for name, size in self.axes:
            running *= size
            if running > max(available, 0):
                missing.append(name)
        return tuple(missing)

    def describe(self) -> str:
        """The CLI spelling, e.g. ``"data=4,model=2"``."""
        return ",".join(f"{n}={s}" for n, s in self.axes)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-dict form for JSON artifacts; invert with ``coerce`` /
        ``from_dict``."""
        return {"axes": [[n, s] for n, s in self.axes]}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        """Rebuild from ``to_dict`` output."""
        return cls.coerce(d)

    def cache_token(self) -> str:
        """Stable string for persistent cache keys."""
        return json.dumps(self.to_dict(), sort_keys=True)

    # -- realization ----------------------------------------------------
    def build(self):
        """Late-bind to the default process group: a
        ``torch.distributed.device_mesh.DeviceMesh`` over its ranks with
        this spec's axis names (rank r at the row-major position r).
        A single-device spec builds none and returns None: each process
        runs alone and every collective is the identity.  Raises
        :class:`MeshUnavailableError` naming the unfillable axes when too
        few ranks are visible, and ``ValueError`` when the group has
        ranks the mesh would leave out."""
        if self.is_single_device:
            return None
        n = available_devices()
        if n < self.size:
            raise MeshUnavailableError(self, n)
        if n > self.size:
            raise ValueError(
                f"mesh {self.describe()} covers {self.size} ranks but the "
                f"default process group has {n}; every rank must be on "
                f"the mesh")
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return DeviceMesh(device_type,
                          torch.arange(self.size).reshape(self.shape),
                          mesh_dim_names=self.names)


def available_devices() -> int:
    """Devices a mesh can use: the default process group's world size
    when one is initialised, else 1 (this process's device)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def ensure_mesh_available(spec: MeshSpec,
                          available: Optional[int] = None) -> None:
    """Raise :class:`MeshUnavailableError` if ``available`` devices
    (default: :func:`available_devices`) cannot realize ``spec``."""
    n = available_devices() if available is None else int(available)
    if n < spec.size:
        raise MeshUnavailableError(spec, n)
