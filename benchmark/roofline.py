"""The yardstick's peaks and the bytes and operations of the kernels whose
roofline shares the benchmark reports.

Peaks: NVIDIA's data sheet for the H100 SXM (dense rates, 700 W). The
counts are frozen copies: `chip_smoke.py` `bound` and `scan_bound`, and
`iridium_tpu_torch/tools/exp_frontend.py` `bound` and `covered_samples`.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def bound_s(n_bytes: float, n_flop: float,
            flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time of `n_bytes` moved and `n_flop` computed, and which
    of the two sets it."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = n_flop / flop_per_s
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def scan_bytes(fft_size: int, history: int, frames: int) -> int:
    """The scan's bytes: the block's |X|^2 rows read once, the state (the
    history and the 9 per-bin planes) read and written once."""
    state_bytes = 4 * (history * fft_size + 9 * fft_size)
    return 4 * fft_size * frames + 2 * state_bytes


def scan_bound_s(fft_size: int, history: int, frames: int) -> float:
    return bound_s(scan_bytes(fft_size, history, frames), 0)[0]


def covered_samples(starts: list, span: int, n: int) -> int:
    """Samples of a stream of n that the windows [s, s + span) cover,
    each counted once."""
    total, end = 0, -1
    for s in sorted(starts):
        a, b = max(s, end, 0), min(s + span, n)
        if b > a:
            total += b - a
        end = max(end, s + span)
    return total


def frontend_bound_s(starts: list, rows: int, l_win: int, decim: int,
                     ntaps: int, n_stream: int) -> tuple[float, str]:
    """The fused front-end's least time on `rows` windows starting at
    `starts` in a stream of `n_stream` samples (two f32 planes): the
    samples the windows cover read once, the (rows, l_win // decim)
    complex outputs written once, the taps read; against the f32-grade
    FIR's tensor work (three TF32 passes of 2 ntaps products an output
    and plane)."""
    n_out = l_win // decim
    span = (n_out - 1) * decim + ntaps
    n_bytes = (8 * covered_samples(starts, span, n_stream)
               + 8 * rows * n_out + 4 * ntaps)
    mads = 2.0 * ntaps * rows * n_out
    return bound_s(n_bytes, 3 * 2 * mads, TF32_FLOP_PER_S)
