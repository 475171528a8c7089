"""Scheduler: slots a decode step advanced, on average over the window
(the window's deltas of ``decode_slot_steps`` and ``decode_steps``)."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("decode_steps"):
        return None
    return c["decode_slot_steps"] / c["decode_steps"]
