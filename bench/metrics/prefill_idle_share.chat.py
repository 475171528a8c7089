"""Scheduler: the share of the traced slice in which the card idled while
the host admitted requests and ran their prefill (``repro.admit``,
``repro.chunk``, ``repro.prefill`` and the replays they ran)."""

from bench.spans import idle_share


def read(ctx):
    return idle_share(ctx, ("admit", "chunk", "prefill"))
