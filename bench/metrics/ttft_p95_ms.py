"""The 95th percentile, over every request due in the window, of the time
from when it was due to its first token on the host; a request that
failed or was refused counts with its whole wait to the cap."""

from bench.stats import percentile


def read(ctx):
    t = ctx.get("ttft_s")
    if not t:
        return None
    return percentile(t, 95) * 1e3
