"""Set-up: from the process's start to the window's first timed call
(weights made, program built and warmed)."""


def read(ctx):
    return ctx.get("setup_s")
