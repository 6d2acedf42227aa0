"""Synthetic Iridium burst generator (test oracle).

Builds DQPSK bursts with the exact air-interface structure the demodulator
expects (preamble + unique word + differentially-encoded payload, RRC pulse
shaping), mirroring the reference's golden-vector methodology
(`ARCHITECTURE.md:244-283`: synthetic single burst, bits must come back
byte-identical) and the sync-word construction in
`burst_downmix.c:138-219` / `qpsk_demod.c:264-273`.
"""

from __future__ import annotations

import numpy as np

from .. import iridium
from ..ops import filters

# decode_dqpsk maps (new - old) % 4 -> symbol via {0,2,3,1}; this is the
# inverse: decoded symbol -> transmitted phase step.
_DIFF_FOR_SYMBOL = {0: 0, 2: 1, 3: 2, 1: 3}


def symbol_phases(symbols: np.ndarray) -> np.ndarray:
    """QPSK symbol index -> complex point at pi/4 + s*pi/2 (unit amplitude)."""
    ang = np.pi / 4 + np.asarray(symbols) * (np.pi / 2)
    return np.exp(1j * ang).astype(np.complex64)


def encode_dqpsk(bits: np.ndarray, start_symbol: int) -> np.ndarray:
    """Differentially encode a bit string (MSB-first pairs) into absolute
    QPSK symbols, continuing from `start_symbol`."""
    bits = np.asarray(bits, dtype=np.int64)
    assert bits.size % 2 == 0
    decoded = 2 * bits[0::2] + bits[1::2]
    out = np.empty(decoded.size, dtype=np.int64)
    prev = start_symbol
    for i, d in enumerate(decoded):
        prev = (prev + _DIFF_FOR_SYMBOL[int(d)]) % 4
        out[i] = prev
    return out


def burst_symbols(payload_bits: np.ndarray, direction: str = "DL",
                  preamble_len: int = iridium.PREAMBLE_LENGTH_SHORT) -> np.ndarray:
    """Full absolute-symbol sequence: preamble + UW + DQPSK payload."""
    if direction == "DL":
        preamble = np.zeros(preamble_len, dtype=np.int64)  # all s0
        uw = np.asarray(iridium.UW_DL, dtype=np.int64)
    else:
        preamble = np.asarray([2, 0] * (preamble_len // 2), dtype=np.int64)
        uw = np.asarray(iridium.UW_UL, dtype=np.int64)
    payload = encode_dqpsk(payload_bits, start_symbol=int(uw[-1]))
    return np.concatenate([preamble, uw, payload])


def modulate(symbols: np.ndarray, sps: int = 10,
             rrc_ntaps: int = 255, alpha: float = 0.4) -> np.ndarray:
    """Upsample + RRC pulse shape at `sps` samples/symbol (baseband)."""
    points = symbol_phases(symbols)
    up = np.zeros(len(points) * sps, dtype=np.complex64)
    up[::sps] = points
    taps = filters.rrc_taps(1.0, sps * iridium.SYMBOLS_PER_SECOND,
                            iridium.SYMBOLS_PER_SECOND, alpha, rrc_ntaps)
    # "same" convolution, normalised so symbol centers have ~unit amplitude
    shaped = np.convolve(up, taps.astype(np.float64), mode="same")
    peak = np.max(np.abs(shaped))
    return (shaped / peak).astype(np.complex64)


def burst_waveform(payload_bits: np.ndarray, sample_rate: int,
                   freq_offset_hz: float, direction: str = "DL") -> np.ndarray:
    """One burst at full rate, unit peak amplitude, shifted to
    `freq_offset_hz` and ramped at both edges."""
    from scipy.signal import resample_poly

    out_rate = 250_000
    decim = sample_rate // out_rate
    bb = modulate(burst_symbols(payload_bits, direction))
    x = resample_poly(bb, up=decim, down=1).astype(np.complex64) if decim > 1 else bb

    n = np.arange(len(x), dtype=np.float64)
    x = (x * np.exp(2j * np.pi * freq_offset_hz / sample_rate * n)).astype(np.complex64)

    # Amplitude ramp over ~4 symbols at both edges: real transmitters ramp
    # the PA, and a hard onset splatters a wideband transient across the
    # whole detection band (rect-edge leakage) that no real burst has.
    ramp_len = max(int(4 * sample_rate / 25_000), 8)
    if len(x) > 2 * ramp_len:
        r = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp_len) / ramp_len)
        x[:ramp_len] *= r.astype(np.float32)
        x[-ramp_len:] *= r[::-1].astype(np.float32)
    return x


def noise(total_samples: int, noise_floor: float = 0.01,
          seed: int = 0) -> np.ndarray:
    """Complex white noise with time-domain sigma `noise_floor`."""
    rng = np.random.default_rng(seed)
    out = (rng.standard_normal(total_samples) +
           1j * rng.standard_normal(total_samples)).astype(np.complex64)
    out *= np.float32(noise_floor / np.sqrt(2))
    return out


def add_burst(capture: np.ndarray, x: np.ndarray, start: int,
              snr_db: float, noise_floor: float = 0.01) -> None:
    """Add waveform `x` into `capture` at `start`, in place. SNR is
    per-bin-ish: amplitude = noise_floor * 10^(snr/20) relative to the
    time-domain noise sigma."""
    amp = noise_floor * 10.0 ** (snr_db / 20.0)
    capture[start:start + len(x)] += (amp * x).astype(np.complex64)


def make_capture(payload_bits: np.ndarray,
                 sample_rate: int = 10_000_000,
                 freq_offset_hz: float = 120_000.0,
                 direction: str = "DL",
                 snr_db: float = 30.0,
                 noise_floor: float = 0.01,
                 burst_start_sample: int | None = None,
                 total_samples: int | None = None,
                 seed: int = 0) -> np.ndarray:
    """Build a full-rate capture: noise floor + one burst at an offset.

    The leading noise region primes the detector's 512-frame history.
    """
    x = burst_waveform(payload_bits, sample_rate, freq_offset_hz, direction)
    fft_size = 1 << int(round(np.log2(sample_rate / 1000.0)))
    history = iridium.DEFAULT_HISTORY_SIZE
    if burst_start_sample is None:
        burst_start_sample = (history + 32) * fft_size
    if total_samples is None:
        total_samples = burst_start_sample + len(x) + int(0.12 * sample_rate)
    capture = noise(total_samples, noise_floor, seed)
    add_burst(capture, x, burst_start_sample, snr_db, noise_floor)
    return capture


def expected_bits(payload_bits: np.ndarray, direction: str = "DL") -> np.ndarray:
    """The full bit string the demodulator should print for this burst:
    DQPSK decode of [UW + payload] starting from symbol 0 — i.e. the 24
    access-code bits followed by the payload bits."""
    access = iridium.ACCESS_DL if direction == "DL" else iridium.ACCESS_UL
    return np.concatenate([np.asarray(access, dtype=np.uint8),
                           np.asarray(payload_bits, dtype=np.uint8)])
