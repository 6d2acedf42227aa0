"""Host-to-device bytes a second of device copy time: the pinned blocks'
copies (`Pipeline._upload`) in the detect steps' spans."""

UNIT = "GB/s"


def read(ctx):
    if ctx.trace is None:
        return None
    ops = [o for o in ctx.trace.ops if o.span == "bench.step"
           and o.cat == "gpu_memcpy" and "HtoD" in o.name]
    t = sum(o.dur for o in ops) * 1e-6
    if not ops or t <= 0:
        return None
    n = sum(o.bytes or 0 for o in ops) or ctx.blocks * ctx.block_bytes
    return n / t / 1e9
