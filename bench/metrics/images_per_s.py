"""Every image whose output reached the host in the window, over the
window."""

from bench.stats import rate


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    return rate(ctx["images"], ctx["window_s"])
