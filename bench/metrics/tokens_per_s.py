"""Every generated token that reached the host in the window, over the
window."""

from bench.stats import rate


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return rate(ctx["tokens"], ctx["window_s"])
