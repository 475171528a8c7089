"""Serving programs: the benchmark's own time of the scheduler steps that
ran a decode and no prefill chunk, over their count."""


def read(ctx):
    s = [t for t, d, k in ctx.get("steps", ()) if d > 0 and k == 0]
    return sum(s) / len(s) * 1e3 if s else None
