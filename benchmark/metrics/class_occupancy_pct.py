"""The live share of the class batches' rows: 100 x the live rows over
the rows of every class batch that ran (`Pipeline.timing` rows_live,
rows_run, counted where the host reads the class counts)."""

UNIT = "%"


def read(ctx):
    run = ctx.timing.get("rows_run", 0)
    live = ctx.timing.get("rows_live", 0)
    if run <= 0 or live <= 0:
        return None
    return 100.0 * live / run
