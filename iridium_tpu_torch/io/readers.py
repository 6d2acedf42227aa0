"""IQ sample ingest: file readers with format auto-detection.

Parity sources in the reference:
  - ci8 -> cf32 conversion (/128):           `simd_generic.c:147-153`
  - ci16 -> ci8 (>>8) lossy conversion:      `main.c:239-249`
  - cf32 passthrough (no quantisation):      `main.c:251-257`
  - Extension auto-detect:                   `options.c:532-544`

Readers yield fixed-size complex64 blocks (zero-padded at EOF) so the device
step compiles once.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

FORMATS = ("ci8", "ci16", "cf32")

_EXT_MAP = {
    ".cf32": "cf32", ".fc32": "cf32", ".cfile": "cf32",
    ".ci16": "ci16", ".cs16": "ci16", ".sc16": "ci16",
}


def detect_format(path: str) -> str:
    """Format from extension; ci8 is the default (reference options.c:532-544)."""
    _, ext = os.path.splitext(path)
    return _EXT_MAP.get(ext, "ci8")


def convert_ci8(raw: np.ndarray) -> np.ndarray:
    """Interleaved int8 IQ -> complex64, scaled by 1/128."""
    return (raw.astype(np.float32) / np.float32(128.0)).view(np.complex64)


def convert_ci16(raw: np.ndarray) -> np.ndarray:
    """Interleaved int16 IQ -> complex64 via the reference's lossy >>8 path."""
    i8 = (raw.astype(np.int16) >> 8).astype(np.int8)
    return convert_ci8(i8)


def convert_cf32(raw: np.ndarray) -> np.ndarray:
    """Interleaved float32 IQ -> complex64 (no quantisation): the same
    bytes, copied out of the read-only read buffer."""
    return raw.view(np.complex64).copy()


_DTYPES = {"ci8": np.int8, "ci16": np.int16, "cf32": np.float32}
_CONVERT = {"ci8": convert_ci8, "ci16": convert_ci16, "cf32": convert_cf32}


def _read_stream(f, block_samples: int, dtype,
                 conv) -> Iterator[Tuple[np.ndarray, int]]:
    """Blockwise reader over a binary stream (file or pipe). Short reads
    are retried until EOF so live pipes work (the reference's spewer
    semantics, main.c:223-284)."""
    itemsize = np.dtype(dtype).itemsize
    want_bytes = block_samples * 2 * itemsize
    while True:
        buf = b""
        while len(buf) < want_bytes:
            chunk = f.read(want_bytes - len(buf))
            if not chunk:
                break
            buf += chunk
        if not buf:
            return
        raw = np.frombuffer(buf[:len(buf) - len(buf) % (2 * itemsize)],
                            dtype=dtype)
        n_valid = raw.size // 2
        samples = conv(raw[: n_valid * 2])
        if n_valid < block_samples:
            padded = np.zeros(block_samples, dtype=np.complex64)
            padded[:n_valid] = samples
            samples = padded
        yield samples, n_valid
        if n_valid < block_samples:
            return


def read_stream(f, block_samples: int,
                fmt: str = "ci8") -> Iterator[Tuple[np.ndarray, int]]:
    """`read_blocks` over an open binary stream `f` (e.g. fd 0 opened
    with `open(0, "rb", closefd=False)`)."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown IQ format: {fmt}")
    yield from _read_stream(f, block_samples, _DTYPES[fmt], _CONVERT[fmt])


def read_blocks(path: str, block_samples: int,
                fmt: str | None = None) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (block complex64 of exactly block_samples, n_valid).

    `path` may be "-" for stdin (live pipe from an SDR tool, e.g.
    `rx_sdr -f 1622e6 -s 10e6 - | iridium-tpu -f - --format ci16`).
    The final partial block is zero-padded; n_valid gives the true count.
    """
    if path == "-":
        import sys
        yield from read_stream(sys.stdin.buffer, block_samples, fmt or "ci8")
        return
    fmt = fmt or detect_format(path)
    if fmt not in FORMATS:
        raise ValueError(f"unknown IQ format: {fmt}")
    with open(path, "rb") as f:
        yield from read_stream(f, block_samples, fmt)
