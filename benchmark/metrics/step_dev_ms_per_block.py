"""Device ms a block of the detect step from the program's own CUDA
events (`Pipeline.timing` step_dev: the window, cuFFT, |X|^2, the scan,
the stream planes and the gone table, the upload left out; recorded while
tracing is on), the gaps between its launches included."""

UNIT = "ms"


def read(ctx):
    t = ctx.timing.get("step_dev", 0.0)
    if t <= 0 or not ctx.blocks:
        return None
    return t * 1e3 / ctx.blocks
