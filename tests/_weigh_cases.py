"""Shared pieces of the dry-run's weighting tests: the depth each
config is counted at (beyond every depth the dry-run traces, so the
weighing is not one of its own traces) and the check that the weighed
counts equal the program traced whole.

The cells are short (32 tokens, 4 rows): the weighing does not depend on
the shapes, and a trace on fake tensors costs by the op."""

import dataclasses

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import cells
from repro_torch.training import TrainConfig

SEQ, BATCH = 32, 4


def counted_config(arch):
    """The SMOKE config at a depth the dry-run does not trace: 4 layers
    where the layers are all alike, 12 (10 local, 2 global) for gemma3's
    pattern; recurrentgemma's (2 blocks and 2 trailing layers) and
    whisper's (2 and 2) SMOKE depths already are."""
    cfg = get_config(arch, smoke=True)
    kinds = cells.depth_kinds(cfg)
    if set(kinds) == {"layer"}:
        return dataclasses.replace(cfg, num_layers=4)
    if set(kinds) == {"local", "global"}:
        return dataclasses.replace(cfg, num_layers=12)
    return cfg


def assert_weighed_equals_whole(cfg, kind, mesh=None, microbatches=2):
    """The dry-run's weighed counts (FLOPs, HBM bytes, collective bytes
    by kind, ops) equal the counts of the program traced whole."""
    shape = ShapeSpec("t", SEQ, BATCH * microbatches // 2, kind)
    tc = TrainConfig(microbatches=microbatches)
    points = [p for p, _ in cells.depth_points(cfg)]
    assert all(any(p[k] < n for k, n in cells.depth_kinds(cfg).items())
               for p in points), "the counted depth is a traced one"
    lowered = cells.lower_cell(cfg, shape, mesh, tc, device="cpu")
    whole = cells.trace_program(cfg, shape, mesh, tc, device="cpu")
    assert lowered.cost.as_dict() == whole.cost.as_dict()
    return lowered, whole
