"""Start-up: ``repro_torch.compile`` and the first call, which captures
the batch's program."""


def read(ctx):
    return ctx.get("compile_s")
