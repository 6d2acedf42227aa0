"""Synthetic Iridium burst waveforms: DQPSK bursts with the air
interface's structure (preamble, unique word, differentially encoded
payload, RRC pulse shaping).

Frozen copy of `iridium_tpu_torch/io/synth.py` (`encode_dqpsk`,
`burst_symbols`, `modulate`, `expected_bits`), so that a later change to
the program cannot move the benchmark's traffic.
"""

from __future__ import annotations

import numpy as np

from reference import filters, iridium

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
                  preamble_len: int = iridium.PREAMBLE_LENGTH_SHORT
                  ) -> np.ndarray:
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


def expected_bits(payload_bits: np.ndarray, direction: str = "DL"
                  ) -> np.ndarray:
    """The bit string the demodulator prints for a burst: the 24 access
    code bits, then the payload bits."""
    access = iridium.ACCESS_DL if direction == "DL" else iridium.ACCESS_UL
    return np.concatenate([np.asarray(access, dtype=np.uint8),
                           np.asarray(payload_bits, dtype=np.uint8)])
