"""Device: the model FLOPs of the tokens computed in the window (every
projection of each prompt token the prefix cache did not serve, and of
each decoded token with its attention over its context; the head of
each generated token), over the window, over the configuration's
peak.  Prefill attention is left out, so this is a lower count."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peak_flops"]
