"""Device ms of the group program (routing and the class batches'
graphs: front-end, downmix, demodulator, decisions and packing) per 1,000
detected bursts, the result's copy to the host left out."""

UNIT = "ms"


def read(ctx):
    if ctx.trace is None or ctx.detected <= 0:
        return None
    t = sum(o.dur for o in ctx.trace.ops if o.span == "bench.group"
            and not (o.cat == "gpu_memcpy" and "DtoH" in o.name))
    return t * 1e-3 / (ctx.detected / 1000.0) if t > 0 else None
