"""Device ms of the group program's rounds per 1,000 detected bursts from
the program's own CUDA events (`Pipeline.timing` round_dev: the copy into
the graphs' buffers, the routing graph and the class graphs' replays, the
result copy left out; recorded while tracing is on), the gaps between
launches and the wait for the class counts included."""

UNIT = "ms"


def read(ctx):
    t = ctx.timing.get("round_dev", 0.0)
    if t <= 0 or ctx.detected <= 0:
        return None
    return t * 1e3 / (ctx.detected / 1000.0)
