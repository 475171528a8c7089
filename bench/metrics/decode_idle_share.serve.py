"""Serving programs: the share of the traced slice in which the card
idled while the host ran the decode step (``repro.decode``: compaction,
the token copy, the step's replay, the logits slice)."""

from bench.spans import idle_share


def read(ctx):
    return idle_share(ctx, ("decode",))
