"""Logical-axis sharding rules (MaxText-style).

The port of ``repro.distributed.sharding``.  Model code annotates
tensors with *logical* axis names; the rules table maps them to mesh
axes of whatever mesh is active.  The graph compiler's propagation pass
(``repro_torch.dist.propagate``) reads the same table.  With no mesh
every annotation is a no-op, so the same model code runs everywhere.

The active mesh is a :class:`repro_torch.dist.collectives.LiveMesh` (one
process a device).  Every rank holds each model tensor whole, so a
constraint is placement only: :func:`logical` returns its tensor, and
:func:`named_sharding` describes where a tensor's parts would live.  The
only partitioned compute is what the models write out (the row- and
column-parallel projections under ``tp_psum``, the expert-parallel MoE),
as the reference's ``shard_map`` branches do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

#: logical axis -> mesh axis (or tuple of mesh axes).  "batch" composes
#: pod×data so a multi-pod mesh is pure DP across pods by default.  A
#: copy of the reference's table, entry for entry.
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,             # sequence kept replicated by default ...
    "seq_shard": "data",     # ... except where context parallelism is on
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_capacity": None,
    "vocab": "model",
    # Decode KV caches shard the SEQUENCE dim over "model"
    # (flash-decoding layout).
    "kv_seq": "model",
    "conv": None,
    "state": None,
    "frames": None,
    # Parameter-only axes: "fsdp" shards the weight fan-in dim over the
    # data axis; "layers" is the stacked-layer dim.
    "fsdp": "data",
    "layers": None,
}

_local = threading.local()


def current_rules() -> Dict[str, AxisVal]:
    """The rules of the innermost :func:`use_mesh`, else DEFAULT_RULES."""
    return getattr(_local, "rules", DEFAULT_RULES)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` (a ``LiveMesh``), or
    None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, AxisVal]] = None):
    """Activate a mesh (a ``LiveMesh`` or None) and rules (merged over
    DEFAULT_RULES) for model-code annotations, on this thread."""
    prev_mesh = getattr(_local, "mesh", None)
    prev_rules = getattr(_local, "rules", None)
    _local.mesh = mesh
    _local.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _local.mesh = prev_mesh
        if prev_rules is None:
            if hasattr(_local, "rules"):
                del _local.rules
        else:
            _local.rules = prev_rules


def spec_for(*logical_axes: Optional[str]) -> tuple:
    """The partition spec for a tuple of logical axis names, as a plain
    tuple (an entry per dim: None, a mesh axis name, or a tuple of
    names), deduplicating mesh axes: a mesh axis may appear at most
    once in a spec."""
    rules = current_rules()
    used = set()
    parts = []
    for ax in logical_axes:
        val = rules.get(ax) if ax else None
        if val is None:
            parts.append(None)
            continue
        axes = (val,) if isinstance(val, str) else tuple(val)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
            used.add(axes[0])
        else:
            parts.append(axes)
            used.update(axes)
    return tuple(parts)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of ``mesh``: a ``LiveMesh``, a ``MeshSpec`` or a
    ``DeviceMesh``."""
    spec = getattr(mesh, "spec", mesh)
    if hasattr(spec, "names"):
        return tuple(spec.names)
    return tuple(mesh.mesh_dim_names)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of ``mesh`` (1 with no mesh or no such
    axis)."""
    if mesh is None:
        return 1
    spec = getattr(mesh, "spec", mesh)
    return dict(spec.axes).get(name, 1)


def _keep(spec: tuple, names) -> tuple:
    """``spec`` with the mesh axes ``names`` lacks dropped (the
    reference's ``keep``: "pod" on a 2-D mesh); one axis left of a
    tuple is the bare name, as a ``PartitionSpec`` holds it."""
    def keep(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept[0] if len(kept) == 1 else (kept or None)
    return tuple(keep(v) for v in spec)


class Placement(NamedTuple):
    """The port's ``NamedSharding``: a partition spec (an entry per dim:
    None, a mesh axis, or a tuple of axes) on a mesh."""
    mesh: object
    spec: tuple


def logical(x, *logical_axes: Optional[str]):
    """The sharding constraint by logical axis names.  Every rank holds
    the tensor whole, so it is placement only: ``x`` itself, with or
    without an active mesh."""
    return x


def named_sharding(mesh, *logical_axes: Optional[str]) -> Placement:
    """The placement of a tensor with these logical axes on ``mesh`` (a
    ``LiveMesh``, ``MeshSpec`` or ``DeviceMesh``): the partition spec
    under the current rules, the mesh's missing axes dropped."""
    names = set(mesh_axis_names(mesh))
    return Placement(mesh, _keep(spec_for(*logical_axes), names))
