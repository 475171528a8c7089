"""repro_torch.dist — sharded compilation: the mesh as a compile-time input.

The port of ``repro.dist``:

    spec = repro_torch.dist.MeshSpec.parse("data=2,model=2")
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(
        target="cuda", mesh=spec))
    exe.partition_spec("dense0:out")   # -> ("data", "model")

``CompileOptions(mesh=...)`` routes the ``"jit"``/``"cuda"`` targets to
a :class:`ShardedExecutable`: the ``propagate_sharding`` pass (in the
ordinary PassManager registry, verified after every pass like shape
inference) annotates every graph tensor with a partition spec derived
from the logical-axis rules of ``repro_torch.distributed.sharding`` and
inserts the collectives the placement implies — ``psum`` /
``all_gather`` / ``reduce_scatter`` / ``ppermute`` are graph ops with
lowering rules like any other op.  The placement is the reference's,
edit for edit.  Where the reference leaves the data movement to XLA's
SPMD partitioner, the port runs it over ``torch.distributed``: one
process a device, the mesh a ``DeviceMesh`` over the default process
group, each rank holding its rows of the batch and its slices of the
weights.

A single-device mesh is bit-identical to the unsharded path: every
collective is the identity and no weight is sliced.
"""

from __future__ import annotations

from .mesh import (MeshSpec, MeshUnavailableError, available_devices,
                   ensure_mesh_available)
from .collectives import COLLECTIVE_OPS
from .propagate import (ShardingError, check_shardings, collective_summary,
                        merged_rules, propagate_shardings)


def __getattr__(name: str):
    # ShardedExecutable pulls in repro_torch.api (targets, cache); loading
    # it lazily keeps ``repro_torch.dist`` importable from the api
    # package without a cycle.
    if name == "ShardedExecutable":
        from .executable import ShardedExecutable
        return ShardedExecutable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "COLLECTIVE_OPS",
    "MeshSpec",
    "MeshUnavailableError",
    "ShardedExecutable",
    "ShardingError",
    "available_devices",
    "check_shardings",
    "collective_summary",
    "ensure_mesh_available",
    "merged_rules",
    "propagate_shardings",
]
