"""Scheduler: the share of the prompt tokens admitted in the window that
the prefix cache served (the window's delta of its ``shared_tokens``)."""


def read(ctx):
    if not ctx.get("prompt_admitted"):
        return None
    return 100.0 * ctx["counters"]["shared_tokens"] / ctx["prompt_admitted"]
