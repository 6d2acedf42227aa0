"""Host ms a block waits from the end of its detect step to the start of
its group's finish (`Pipeline.timing` queue_wait: the group's fill and
`run_blocks`' depth of groups in flight)."""

UNIT = "ms"


def read(ctx):
    t = ctx.timing.get("queue_wait", 0.0)
    if t <= 0 or not ctx.blocks:
        return None
    return t * 1e3 / ctx.blocks
