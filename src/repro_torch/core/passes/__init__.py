"""Compiler passes over the graph IR — a registry, not a list.

The port's copy of ``repro.core.passes``.  The passes are numpy-only and
register in the same order under the same constraints, so
``DEFAULT_PIPELINE`` resolves to the same instance names and the
optimized graph is ``structure_hash``- and param-identical to the
reference's:

1. canonicalize           — normalize ops (flatten→reshape, lone softmax→activation)
2. fold_constants         — precompute weight-only subgraphs (through SimpleNN)
3. fuse_pad               — merge zero_pad2d into the following conv
4. fuse_activation        — activations become epilogues of producers (§3.4)
5. fold_batchnorm         — BN folded into adjacent conv/dense (§3.5)
6. fuse_activation.post_bn — rerun: BN removal exposes new conv→act pairs
7. quantize               — no-op without a request on ``graph.quant``
                            (the calibrated modes are ROADMAP A.5)
8. optimize_layout        — compile-time weight re-layout (§3.3)
9. propagate_sharding     — per-tensor partition specs + collectives
                            (no-op without a mesh; repro_torch.dist)

followed by ``plan_memory`` as the pipeline finalizer.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..graph import Graph
from .manager import (PassManager, PassOrderingError, PassVerificationError,
                      register_pass, registered_passes,
                      resolve_order, unregister_pass)

# Importing a pass module registers it; import order is the tie-break
# order for constraint resolution (the reference's order).
from .canonicalize import canonicalize
from .fold_constants import fold_constants
from .fuse_pad import fuse_pad
from .fuse_activation import fuse_activation
from .fold_batchnorm import fold_batchnorm
from .layout import optimize_layout
from .memory_plan import MemoryPlan, plan_memory

register_pass("fuse_activation.post_bn", after=("fold_batchnorm",),
              before=("optimize_layout",))(fuse_activation)

from .quantize import quantize
from .sharding import propagate_sharding

#: The resolved default pipeline (instance names, in execution order).
DEFAULT_PIPELINE: Tuple[str, ...] = resolve_order()


def run_pipeline(
    graph: Graph,
    passes: Optional[Sequence[str]] = None,
    *,
    verify: bool = True,
    dump_ir=None,
) -> Tuple[Graph, Dict]:
    """Run the pass pipeline; returns the optimized graph and a report
    with per-pass statistics plus the memory plan.

    ``passes=None`` runs the registry-resolved default; an explicit
    sequence of names runs exactly those, in that order.
    """
    return PassManager(passes, verify=verify, dump_ir=dump_ir).run(graph)


__all__ = [
    "run_pipeline",
    "DEFAULT_PIPELINE",
    "PassManager",
    "PassOrderingError",
    "PassVerificationError",
    "register_pass",
    "registered_passes",
    "resolve_order",
    "unregister_pass",
    "canonicalize",
    "fold_constants",
    "fold_batchnorm",
    "fuse_pad",
    "fuse_activation",
    "plan_memory",
    "MemoryPlan",
    "optimize_layout",
    "propagate_sharding",
    "quantize",
]
