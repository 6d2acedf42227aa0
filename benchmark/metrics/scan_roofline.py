"""The scan kernel's (csrc/detect_scan.cu) share of its roofline: the
bytes bound of its launches (`roofline.scan_bytes` at 3.35 TB/s) over
their device time."""

import roofline

UNIT = "%"


def read(ctx):
    if ctx.trace is None:
        return None
    ops = [o for o in ctx.trace.ops if "detect_scan" in o.name]
    t = sum(o.dur for o in ops) * 1e-6
    if not ops or t <= 0:
        return None
    p = ctx.p
    b = roofline.scan_bound_s(p.fft_size, p.history_size,
                              p.frames_per_block)
    return 100.0 * len(ops) * b / t
