"""Device: the share of the traced slice in which nothing ran on the card
(one minus the union of its kernels, copies and sets over the slice).
The reader of ``idle_share.serve`` and ``idle_share.infer``, one quantity
split by the end-to-end metric it moves."""

from bench.trace import idle_share


def read(ctx):
    return idle_share(ctx.get("trace"))
