"""Compiled program: the card's idle time inside the program's own call
(``repro.call`` and its static-input copy, replay and output clones),
in the traced slice, over the calls there; the rest of the host's cost
a frame is the benchmark's readback and loop."""

from bench.spans import phase_idle


def read(ctx):
    got = phase_idle(ctx, ("call", "input", "output"))
    if got is None or not got[1]["call"]:
        return None
    return got[0] / got[1]["call"] * 1e6
