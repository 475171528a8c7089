"""Start-up: ``repro_torch.compile``, ``repro_torch.serve`` and
``wait_warm`` (every serving program built and captured)."""


def read(ctx):
    return ctx.get("build_s")
