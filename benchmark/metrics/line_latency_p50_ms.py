"""The median line latency: from the hand-over of a block to
`run_blocks` to the yield of its frames, over every line."""

import numpy as np

UNIT = "ms"


def read(ctx):
    if len(ctx.lat_ms) == 0:
        return None
    return float(np.median(ctx.lat_ms))
