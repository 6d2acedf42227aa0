"""`RAW:` line formatting, byte-compatible with the reference/iridium-toolkit.

Parity source: reference `frame_output.c:144-199`. (The `IDA:` formatter
of the JAX package belongs to the parsed-output path, not ported yet.)
"""

from __future__ import annotations


class RawPrinter:
    """Stateful printer mirroring frame_output.c's t0/file_info latching
    (frame_output.c:144-158): t0 = first frame's timestamp floored to the
    second; auto file_info is "i-<epoch>-t1"."""

    def __init__(self, file_info: str | None = None):
        self.file_info = file_info
        self.t0_ns: int | None = None

    def _ensure_init(self, timestamp_ns: int) -> None:
        if self.t0_ns is not None:
            return
        self.t0_ns = (timestamp_ns // 1_000_000_000) * 1_000_000_000
        if not self.file_info:
            self.file_info = f"i-{self.t0_ns // 1_000_000_000}-t1"

    def format(self, frame: dict) -> str:
        """frame keys: timestamp_ns, frequency, magnitude, noise, id,
        confidence, level, n_symbols, bits (iterable of 0/1)."""
        self._ensure_init(frame["timestamp_ns"])
        ts_ms = (frame["timestamp_ns"] - self.t0_ns) / 1e6
        freq_hz = int(frame["frequency"] + 0.5)
        n_payload = max(frame["n_symbols"] - 12, 0)
        bits = "".join("1" if b else "0" for b in frame["bits"])
        return (f"RAW: {self.file_info} {ts_ms:012.4f} {freq_hz:010d} "
                f"N:{frame['magnitude']:05.2f}{frame['noise']:+06.2f} "
                f"I:{frame['id']:011d} {frame['confidence']:3d}% "
                f"{frame['level']:.5f} {n_payload:3d} {bits}")
