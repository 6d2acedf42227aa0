"""FIR tap design (host-side, numpy).

Frozen copy of `iridium_tpu_torch/ops/filters.py` (the benchmark's yardstick: later
changes to the program do not move it).

Parity sources in the reference:
  - RRC taps:  `fir_filter.c:74-111`  (alpha=0.4, 51 taps, energy-normalised)
  - RC taps:   `fir_filter.c:115-139`
  - LPF taps:  `fir_filter.c:143-182` (windowed sinc, Blackman-Harris,
               ntaps = 4/(transition/fs), odd, unity-DC-normalised)
  - Box taps:  `fir_filter.c:186-193`

Computed in float64 then cast to float32; the reference computes in float32
directly.  Differences are at the 1e-7 level and within the reference's own
cross-backend tolerance.
"""

import numpy as np


def _sinc(x: np.ndarray) -> np.ndarray:
    # sin(pi x)/(pi x) with the limit at 0
    return np.sinc(x)


def rrc_taps(gain: float, sample_rate: float, symbol_rate: float,
             alpha: float, ntaps: int) -> np.ndarray:
    """Root-raised-cosine taps, energy-normalised to `gain`."""
    ntaps |= 1
    sps = sample_rate / symbol_rate
    center = ntaps // 2
    t = (np.arange(ntaps) - center) / sps

    taps = np.empty(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-10:
            taps[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(abs(ti) - 1.0 / (4.0 * alpha)) < 1e-6:
            taps[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha))
            )
        else:
            num = (np.sin(np.pi * ti * (1.0 - alpha))
                   + 4.0 * alpha * ti * np.cos(np.pi * ti * (1.0 + alpha)))
            den = np.pi * ti * (1.0 - (4.0 * alpha * ti) ** 2)
            taps[i] = num / den

    taps *= gain / np.sqrt(np.sum(taps * taps))
    return taps.astype(np.float32)


def rc_taps(sample_rate: float, symbol_rate: float,
            alpha: float, ntaps: int) -> np.ndarray:
    """Raised-cosine (pulse shaping) taps, peak-normalised."""
    ntaps |= 1
    sps = sample_rate / symbol_rate
    center = ntaps // 2
    t = (np.arange(ntaps) - center) / sps

    taps = np.empty(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-10:
            taps[i] = 1.0
        elif alpha > 0 and abs(abs(ti) - 1.0 / (2.0 * alpha)) < 1e-6:
            taps[i] = (np.pi / 4.0) * _sinc(1.0 / (2.0 * alpha))
        else:
            den = 1.0 - (2.0 * alpha * ti) ** 2
            taps[i] = _sinc(ti) * np.cos(np.pi * alpha * ti) / den

    return taps.astype(np.float32)


def lpf_taps(gain: float, sample_rate: float, cutoff_freq: float,
             transition_width: float) -> np.ndarray:
    """Windowed-sinc low-pass with Blackman-Harris window.

    Tap count is 4/(transition/fs), forced odd; DC gain normalised.
    """
    ntaps = int(4.0 / (transition_width / sample_rate))
    ntaps |= 1
    center = ntaps // 2
    omega_c = 2.0 * np.pi * cutoff_freq / sample_rate

    n = np.arange(ntaps, dtype=np.float64) - center
    h = np.where(np.abs(n) < 1e-10, omega_c / np.pi,
                 np.sin(omega_c * n) / (np.pi * np.where(n == 0, 1.0, n)))

    i = np.arange(ntaps, dtype=np.float64)
    w = (0.35875
         - 0.48829 * np.cos(2.0 * np.pi * i / (ntaps - 1))
         + 0.14128 * np.cos(4.0 * np.pi * i / (ntaps - 1))
         - 0.01168 * np.cos(6.0 * np.pi * i / (ntaps - 1)))

    taps = h * w
    taps *= gain / np.sum(taps)
    return taps.astype(np.float32)


def box_taps(length: int) -> np.ndarray:
    """Moving-average (box) taps."""
    return np.full(length, 1.0 / length, dtype=np.float32)
