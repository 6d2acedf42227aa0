"""Host ms a block that `run_blocks` waits on its caller after yielding the
block's frames (`Pipeline.timing` consumer: the harness's formatting of
the lines, as the CLI's)."""

UNIT = "ms"


def read(ctx):
    t = ctx.timing.get("consumer", 0.0)
    if t <= 0 or not ctx.blocks:
        return None
    return t * 1e3 / ctx.blocks
