"""Device ms a block of the detect step (`Pipeline._dispatch_step`: the
window, cuFFT, |X|^2, the scan, the stream planes and gone table), the
block's upload left out."""

UNIT = "ms"


def read(ctx):
    if ctx.trace is None or not ctx.blocks:
        return None
    t = sum(o.dur for o in ctx.trace.ops if o.span == "bench.step"
            and not (o.cat == "gpu_memcpy" and "HtoD" in o.name))
    return t * 1e-3 / ctx.blocks if t > 0 else None
