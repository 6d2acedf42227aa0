"""Synthetic captures of the card's decode checks (`chip_smoke.py`) and of
`tools/exp_mesh.py`, each made from a seed.

  PROD                 the production 10 MHz detector keywords
  production_capture   3 blocks at 10 MHz with 13 DL bursts
  dense_capture        8 blocks at 10 MHz, ~250 bursts/s
  capture_1mhz         one burst at 1 MHz (the window-gather path)
  write_cf32           a capture as an interleaved cf32 file
"""

from __future__ import annotations

import numpy as np

from .. import iridium
from ..io import synth

PROD = dict(sample_rate=10_000_000, frames_per_block=2048,
            gone_capacity=2048)
DENSE_BLOCKS = 8
DENSE_PER_S = 250.0        # BENCH_r05.json's det/s: a live 10 MHz band


def production_capture(seed: int):
    """Three blocks of 10 MHz noise (the last one partial) with 13 DL
    bursts:
    two in the simplex band with frames longer than the normal band
    allows, one straddling the first block boundary. Returns the capture
    and the injected (start, offset Hz, payload bits). (UL bursts are left
    out: the reference's uw_start arithmetic rejects them, and so does
    the port; test_e2e.py's test_ul_burst_rejected_like_reference.)"""
    rng = np.random.default_rng(seed)
    fs = PROD["sample_rate"]
    block = PROD["frames_per_block"] * 8192
    total = 2 * block + 4_000_000
    cap = synth.noise(total, seed=seed)
    plan = [(5_000_000, 137_000.0), (6_900_000, -2_310_000.0),
            (8_800_000, 4_300_000.0), (10_700_000, 1_020_000.0),
            (12_600_000, -4_400_000.0), (14_500_000, 3_050_000.0),
            (block - 30_000, -220_000.0), (19_000_000, 4_650_000.0),
            (21_500_000, -1_480_000.0), (24_000_000, 2_270_000.0),
            (26_500_000, -3_330_000.0), (29_000_000, 620_000.0),
            (31_500_000, -880_000.0)]
    bursts = []
    for start, off in plan:
        n_bits = 500 if off > 4e6 else 300
        # 8 guard bits after the payload: the end-of-frame magnitude drop
        # (qpsk_demod.c:199-260) may trim the last symbols on the ramp
        bits = rng.integers(0, 2, n_bits + 8).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, fs, off), start,
                        snr_db=float(rng.uniform(22.0, 32.0)))
        bursts.append((start, off, bits[:n_bits]))
    return cap, bursts


def dense_capture(seed: int):
    """DENSE_BLOCKS production blocks of 10 MHz noise with DL bursts at
    DENSE_PER_S after the detector's priming, each at a uniform start,
    22-32 dB: 88% with 300-bit payloads over the duplex band (-4.9 to
    +3.95 MHz from the centre), 12% with 500-bit frames in the simplex
    band (+4.02 to +4.46 MHz). Payloads come from 48 waveforms made once
    at baseband and shifted to each burst's offset. Returns the capture
    and the number of bursts."""
    rng = np.random.default_rng(seed)
    fs = PROD["sample_rate"]
    total = DENSE_BLOCKS * PROD["frames_per_block"] * 8192
    cap = synth.noise(total, seed=seed)
    first = (iridium.DEFAULT_HISTORY_SIZE + 32) * 8192
    waves = [synth.burst_waveform(rng.integers(0, 2, nb).astype(np.uint8),
                                  fs, 0.0)
             for nb in [308] * 32 + [508] * 16]
    n = int(DENSE_PER_S * (total - first) / fs)
    for _ in range(n):
        simplex = rng.random() < 0.12
        w = waves[32 + rng.integers(16) if simplex else rng.integers(32)]
        off = (rng.uniform(4.02e6, 4.46e6) if simplex
               else rng.uniform(-4.9e6, 3.95e6))
        start = int(rng.integers(first, total - len(w)))
        # exp(i w n) for n = 512 a + b, as the outer product of two short
        # tables
        step = 2 * np.pi * off / fs
        hi = np.exp(1j * step * 512 * np.arange(-(-len(w) // 512)))
        lo = np.exp(1j * step * np.arange(512))
        tone = (hi.astype(np.complex64)[:, None]
                * lo.astype(np.complex64)[None, :]).reshape(-1)[:len(w)]
        amp = np.float32(0.01 * 10.0 ** (rng.uniform(22.0, 32.0) / 20.0))
        cap[start:start + len(w)] += (amp * w) * tone
    return cap, n


def capture_1mhz(seed: int):
    """One 300-bit DL burst at 1 MHz, 100 kHz off the centre, 30 dB (the
    decimation-4 path: no fused front-end, the window gather)."""
    bits = np.random.default_rng(seed).integers(0, 2, 300).astype(np.uint8)
    return synth.make_capture(bits, sample_rate=1_000_000,
                              freq_offset_hz=100_000.0, snr_db=30.0)


def write_cf32(path: str, cap) -> None:
    np.ascontiguousarray(cap, np.complex64).view(np.float32).tofile(path)
