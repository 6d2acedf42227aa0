"""The fused front-end's (csrc/fused_frontend.cu: its ramp and FIR
kernels) share of its roofline: the larger of the bytes and operations
bound of each launch's live windows (`roofline.frontend_bound_s`, from
the probed routing) over the kernels' device time."""

import roofline

UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.frontend:
        return None
    t = sum(o.dur for o in ctx.trace.ops
            if "fused_frontend" in o.name or "burst_ramp" in o.name) * 1e-6
    if t <= 0:
        return None
    dec = ctx.dec
    b = sum(roofline.frontend_bound_s(
        starts, live, dec.classes[c].l_win, dec.dmp.decimation,
        dec.in_ntaps, n)[0] for c, live, starts, n in ctx.frontend)
    return 100.0 * b / t
