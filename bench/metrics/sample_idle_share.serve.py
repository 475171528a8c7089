"""Scheduler: the share of the traced slice in which the card idled while
the host sampled tokens (``repro.sample``: each slot's ``argmax`` read
back, a step's loop or a request's first token)."""

from bench.spans import idle_share


def read(ctx):
    return idle_share(ctx, ("sample",))
