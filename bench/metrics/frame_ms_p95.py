"""The 95th percentile, over every call of the window, of the time from
the call to its output on the host."""

from bench.stats import percentile


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["latency_s"]:
        return None
    return percentile(ctx["latency_s"], 95) * 1e3
