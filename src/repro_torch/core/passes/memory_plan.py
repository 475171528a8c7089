"""Tensor lifetime analysis and arena planning (paper §3.2).

"the inputs and outputs of all nodes are assigned to actual memory
locations, taking into account that tensors with overlapping lifetimes
must use different memory. … the individual layer compilers can indicate
whether they want any of their outputs to use the memory of an input
tensor that is not referenced afterwards."

On TPU the XLA buffer assigner does the final allocation, but the plan
still matters twice over:

* it decides which ops are *eligible to run in place* — which the back
  end exposes to XLA via donation and via output-aliased Pallas calls;
* it is the compile-time VMEM/HBM working-set report used by the
  roofline analysis (arena bytes vs sum-of-all-tensors bytes).

The allocator is a greedy best-fit over [start, end) lifetime intervals,
processing tensors in program order, with an explicit in-place fast path
mirroring the paper's "output may use the memory of an input tensor that
is not referenced afterwards".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..graph import Graph

#: Ops whose output may alias their (first) input: elementwise or
#: shape-only ops.  Convs/matmuls cannot run in place (their input is
#: read repeatedly while outputs are produced).
INPLACE_OPS = ("activation", "batchnorm", "add", "mul", "reshape", "softmax")


@dataclasses.dataclass
class Assignment:
    offset: int
    nbytes: int
    inplace_of: Optional[str] = None


@dataclasses.dataclass
class MemoryPlan:
    assignments: Dict[str, Assignment]
    arena_bytes: int
    naive_bytes: int
    inplace_count: int

    def stats(self) -> Dict:
        return {
            "arena_bytes": self.arena_bytes,
            "naive_bytes": self.naive_bytes,
            "savings_ratio": (
                1.0 - self.arena_bytes / self.naive_bytes if self.naive_bytes else 0.0
            ),
            "inplace_count": self.inplace_count,
            "tensors": len(self.assignments),
        }


def _lifetimes(graph: Graph) -> Dict[str, Tuple[int, int]]:
    """[first-def, last-use] step index per intermediate tensor.
    Graph outputs live to the end; graph inputs from step -1."""
    order = graph.toposort()
    step_of = {node.output: i for i, node in enumerate(order)}
    last_use: Dict[str, int] = {}
    for i, node in enumerate(order):
        for t in node.inputs:
            last_use[t] = i
    n = len(order)
    lifetimes: Dict[str, Tuple[int, int]] = {}
    for name in graph.inputs:
        lifetimes[name] = (-1, last_use.get(name, -1))
    for node in order:
        t = node.output
        end = n if t in graph.outputs else last_use.get(t, step_of[t])
        lifetimes[t] = (step_of[t], end)
    return lifetimes


def plan_memory(graph: Graph, alignment: int = 128) -> MemoryPlan:
    """Greedy interval-based arena allocation with in-place reuse.

    ``alignment`` defaults to 128 bytes (TPU lane width × f32; the paper
    aligned to 16-byte XMM boundaries — same idea, different hardware).
    """
    specs = graph.infer_shapes()
    lifetimes = _lifetimes(graph)
    order = graph.toposort()

    def aligned(n: int) -> int:
        return -(-n // alignment) * alignment

    assignments: Dict[str, Assignment] = {}
    # Graph inputs each get their own space at the start of the arena.
    cursor = 0
    for name in graph.inputs:
        nbytes = aligned(specs[name].nbytes)
        assignments[name] = Assignment(offset=cursor, nbytes=nbytes)
        cursor += nbytes

    # live blocks: list of (offset, nbytes, tensor, end_step)
    live: List[Tuple[int, int, str, int]] = [
        (assignments[n].offset, assignments[n].nbytes, n, lifetimes[n][1])
        for n in graph.inputs
    ]
    arena_end = cursor
    inplace_count = 0

    for step, node in enumerate(order):
        t = node.output
        nbytes = aligned(specs[t].nbytes)

        # Expire blocks whose lifetime ended before this step.
        live = [blk for blk in live if blk[3] >= step]

        # In-place fast path: elementwise/shape ops whose first input
        # dies at this exact step and whose buffer is large enough.
        placed = False
        if node.op in INPLACE_OPS and node.inputs:
            src = node.inputs[0]
            src_assign = assignments.get(src)
            if (
                src_assign is not None
                and lifetimes[src][1] == step
                and src_assign.nbytes >= nbytes
                and src not in graph.outputs
            ):
                assignments[t] = Assignment(
                    offset=src_assign.offset, nbytes=nbytes, inplace_of=src
                )
                live.append((src_assign.offset, nbytes, t, lifetimes[t][1]))
                inplace_count += 1
                placed = True

        if not placed:
            # Best-fit search over gaps between live blocks.
            blocks = sorted(b for b in live)
            best_gap: Optional[int] = None
            best_size = None
            prev_end = 0
            for off, size, _, _ in blocks:
                gap = off - prev_end
                if gap >= nbytes and (best_size is None or gap < best_size):
                    best_gap, best_size = prev_end, gap
                prev_end = max(prev_end, off + size)
            if best_gap is None:
                best_gap = prev_end
            assignments[t] = Assignment(offset=best_gap, nbytes=nbytes)
            live.append((best_gap, nbytes, t, lifetimes[t][1]))
            arena_end = max(arena_end, best_gap + nbytes)

    naive = sum(aligned(specs[t].nbytes) for t in lifetimes)
    return MemoryPlan(
        assignments=assignments,
        arena_bytes=arena_end,
        naive_bytes=naive,
        inplace_count=inplace_count,
    )
