"""Synthetic captures of the card's decode checks (`chip_smoke.py`) and of
`tools/exp_mesh.py`, each made from a seed.

  PROD                 the production 10 MHz detector keywords
  production_capture   3 blocks at 10 MHz with 13 DL bursts
  dense_capture        8 blocks at 10 MHz, ~250 bursts/s
  capture_1mhz         one burst at 1 MHz (the window-gather path)
  write_cf32           a capture as an interleaved cf32 file
  WIDE_400             the 400 MHz detector keywords
  wideband_400mhz_plan the 400 MHz capture's bursts
  write_ci8            a capture made and written chunk by chunk as ci8
"""

from __future__ import annotations

import concurrent.futures

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


WIDE_400 = dict(sample_rate=400_000_000)


def wideband_400mhz_plan(seed: int, block: int):
    """Twelve DL bursts for a 400 MHz capture of blocks of `block` samples
    (F = 524,288: a block of 1,024 frames is 1.342 s) and part of a third:
    after the detector's priming (the first 512 frames), 25 ms or more
    apart, one across the first block boundary, two 500-bit frames in the
    simplex band, the rest 300-bit, within the 10 MHz band and beyond it
    (-150 to +170 MHz), 12-20 dB a sample (the 801-tap input filter and
    the decimation by 1,600 add ~25 dB). Returns the capture's length and
    [(start, offset Hz, payload bits, waveform, amplitude)]."""
    rng = np.random.default_rng(seed)
    fs = WIDE_400["sample_rate"]
    offsets = [137_000.0, -2_310_000.0, 4_300_000.0, -9_100_000.0,
               1_020_000.0, 4_150_000.0, -4_400_000.0, 60_000_000.0,
               -120_000_000.0, 170_000_000.0, -150_000_000.0,
               3_050_000.0]
    starts = [290_000_000 + 40_000_000 * i for i in range(6)]
    starts[3] = block - 600_000
    starts += [block + 30_000_000 + 40_000_000 * i for i in range(6)]
    drawn = []
    for start, off in zip(starts, offsets):
        n_bits = 500 if 4e6 < off < 4.5e6 else 300
        bits = rng.integers(0, 2, n_bits + 8).astype(np.uint8)
        amp = 0.01 * 10.0 ** (rng.uniform(12.0, 20.0) / 20.0)
        drawn.append((start, off, bits, n_bits, amp))
    return 2 * block + 40_000_000, _with_waveforms(drawn, fs)


def _with_waveforms(drawn, fs: int) -> list:
    """[(start, offset, payload bits, waveform, amplitude)] of drawn
    [(start, offset, bits, payload bit count, amplitude)], the waveforms
    made on threads (resampling to ~10 M samples a burst takes about a
    second each)."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        waves = list(pool.map(lambda d: synth.burst_waveform(d[2], fs, d[1]),
                              drawn))
    return [(start, off, bits[:n], w, amp)
            for (start, off, bits, n, amp), w in zip(drawn, waves)]


# 1.6 GHz (F = 2,097,152, decimation 6,400), blocks of 256 frames: a
# block of 536,870,912 samples, as many as a 400 MHz block of 1,024 frames
WIDE_1600 = dict(sample_rate=1_600_000_000, frames_per_block=256)


def wideband_1600mhz_plan(seed: int, block: int):
    """Twelve DL bursts of 100-bit payloads for a 1.6 GHz capture of six
    blocks of `block` samples (F = 2,097,152; 256 frames, 0.336 s a
    block): after the detector's priming (the first 512 frames, two
    blocks), ~0.1 s apart, from -700 to +700 MHz, one across the boundary
    of blocks 4 and 5, which is sample 2^31 (a 32-bit sample position
    wraps there), 12-20 dB a sample (the 801-tap input filter and the
    decimation by 6,400 add ~31 dB). Returns the capture's length and
    [(start, offset Hz, payload bits, waveform, amplitude)]."""
    rng = np.random.default_rng(seed)
    fs = WIDE_1600["sample_rate"]
    offsets = [137_000.0, -700_000_000.0, 2_310_000.0, 700_000_000.0,
               -9_100_000.0, 350_000_000.0, -480_000_000.0,
               1_020_000.0, 120_000_000.0, -250_000_000.0, 560_000_000.0,
               -3_050_000.0]
    starts = [2 * block + 40_000_000 + 150_000_000 * i for i in range(12)]
    starts[5] = 4 * block - 3_000_000
    drawn = [(start, off, rng.integers(0, 2, 108).astype(np.uint8), 100,
              0.01 * 10.0 ** (rng.uniform(12.0, 20.0) / 20.0))
             for start, off in zip(starts, offsets)]
    return 6 * block, _with_waveforms(drawn, fs)


# write_ci8's gain before rounding (so that the noise spans a few quanta)
# and the samples it makes and writes at a time
CI8_SCALE = 4.0
CI8_CHUNK = 1 << 25


def write_ci8(path: str, n_samples: int, bursts, seed: int,
              device) -> None:
    """A capture of `n_samples` written as ci8 (int8 I, Q; the readers
    divide by 128) CI8_CHUNK samples at a time, never whole in memory:
    complex white noise of sigma 0.01 made on `device` from `seed`, plus
    each burst (start, ..., waveform, amplitude) of `bursts` where it
    overlaps the chunk, all times CI8_SCALE and rounded, clipped to
    +-127."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sigma = 0.01 / np.sqrt(2.0)
    with open(path, "wb") as f:
        for i0 in range(0, n_samples, CI8_CHUNK):
            n = min(CI8_CHUNK, n_samples - i0)
            x = torch.randn((n, 2), generator=gen, device=device) * sigma
            xc = torch.view_as_complex(x)
            for start, _, _, w, amp in bursts:
                a, b = max(start, i0), min(start + len(w), i0 + n)
                if a < b:
                    xc[a - i0:b - i0] += torch.from_numpy(
                        w[a - start:b - start] * np.float32(amp)).to(device)
            q = torch.clamp(torch.round(x * (128.0 * CI8_SCALE)), -127, 127)
            f.write(q.to(torch.int8).cpu().numpy().tobytes())
