"""Window function generation (host-side, numpy float32).

Frozen copy of `iridium_tpu_torch/ops/windows.py` (the benchmark's yardstick: later
changes to the program do not move it).

Parity source: reference `window_func.c:19-24` (symmetric Blackman with
0.42/0.5/0.08 coefficients and (n-1) denominator).
"""

import numpy as np


def blackman(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    d = np.float32(n - 1)
    return (
        np.float32(0.42)
        - np.float32(0.5) * np.cos(np.float32(2.0 * np.pi) * i / d)
        + np.float32(0.08) * np.cos(np.float32(4.0 * np.pi) * i / d)
    ).astype(np.float32)


# Equivalent noise bandwidth of the Blackman window used by the detector's
# threshold normalisation (reference burst_detect.c:225-226).
BLACKMAN_ENBW = 1.72
