"""Host ms a round of the group program waits for its class counts
(`Pipeline.timing` counts_wait, inside group_dispatch: the read of 12
bytes waits for the group's detect steps and routing) over the rounds,
first and overflow (n_groups + n_overflow_rounds)."""

UNIT = "ms"


def read(ctx):
    t = ctx.timing.get("counts_wait", 0.0)
    rounds = (ctx.timing.get("n_groups", 0)
              + ctx.timing.get("n_overflow_rounds", 0))
    if t <= 0 or rounds <= 0:
        return None
    return t * 1e3 / rounds
