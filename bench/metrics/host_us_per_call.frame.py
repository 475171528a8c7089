"""Compiled program: what a call costs beyond the card's time, in the
traced slice: the mean time from a call to its output on the host, less
the device's busy time per call."""


def read(ctx):
    tr, lat = ctx.get("trace"), ctx.get("slice_latency_s")
    if not tr or not lat or tr["busy_s"] <= 0:
        return None
    return (sum(lat) - tr["busy_s"]) / len(lat) * 1e6
