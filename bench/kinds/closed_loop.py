"""A closed loop: ``callers`` callers, each sending its next call of
``batch`` inputs when the previous one has returned, from a ring of
``ring`` distinct input batches of the configuration's ``input`` shape,
standard normal, drawn on the host from the seed (pinned where the mix
says so and the process has a card), as a camera or a job's reader hands
them over."""

from __future__ import annotations

from typing import Dict, List

from bench.generator import MASK64


def generate(mix: Dict, seed: int, seconds: float, config: Dict) -> List:
    import torch
    gen = torch.Generator().manual_seed(int(seed) & MASK64)
    shape = (int(mix["batch"]),) + tuple(config["input"])
    out = []
    for _ in range(int(mix["ring"])):
        x = torch.randn(shape, generator=gen)
        if mix.get("pinned") and torch.cuda.is_available():
            x = x.pin_memory()
        out.append(x)
    return out
