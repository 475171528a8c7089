"""Logical-axis sharding rules (MaxText-style).

The port of ``repro.distributed.sharding``.  Model code annotates
tensors with *logical* axis names; the rules table maps them to mesh
axes of whatever mesh is active.  The graph compiler's propagation pass
(``repro_torch.dist.propagate``) reads the same table.  With no mesh
every annotation is a no-op, so the same model code runs everywhere.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

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
    """The mesh of the innermost :func:`use_mesh` (a ``DeviceMesh``), or
    None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, AxisVal]] = None):
    """Activate a mesh (a ``DeviceMesh`` or None) and rules (merged over
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


def logical(x, *logical_axes: Optional[str]):
    """The sharding constraint by logical axis names: ``x`` itself when
    no mesh is active.  Constraining a model's tensors on a live mesh
    is ROADMAP A.14b (the models' sharded forms) and raises."""
    if current_mesh() is None:
        return x
    raise NotImplementedError(
        "logical() on a live mesh is not ported yet (ROADMAP A.14b: "
        "sharded models)")


def named_sharding(mesh, *logical_axes: Optional[str]):
    """A placement of a model tensor on a live mesh: ROADMAP A.14b (the
    models' sharded forms); raises."""
    raise NotImplementedError(
        "named_sharding() is not ported yet (ROADMAP A.14b: sharded "
        "models); spec_for gives the partition spec as a tuple")
