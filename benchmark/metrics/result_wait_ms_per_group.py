"""Host ms a group waits for its result's copy (`Pipeline.timing`
result_fetch_wait over n_groups)."""

UNIT = "ms"


def read(ctx):
    if not ctx.groups:
        return None
    return ctx.timing.get("result_fetch_wait", 0.0) * 1e3 / ctx.groups
