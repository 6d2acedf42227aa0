"""`RAW:`/`IDA:` line formatting, byte-compatible with the
reference/iridium-toolkit.

Parity sources: reference `frame_output.c:144-199` (RAW) and
`frame_output.c:203-362` (IDA, byte-format-compatible with
iridium-parser.py: LCW header, cont/ctr/len fields, hex payload with `!`
split and 60-char pad, CRC, SBD ASCII preview).
"""

from __future__ import annotations

import math

import numpy as np

# a bool array's bytes (0 and 1) to the ASCII digits '0' and '1'
_BITS_ASCII = bytes.maketrans(b"\x00\x01", b"01")


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
        confidence, level, n_symbols, bits (a 1-D array or sequence: a
        nonzero element prints as 1, a zero as 0)."""
        self._ensure_init(frame["timestamp_ns"])
        ts_ms = (frame["timestamp_ns"] - self.t0_ns) / 1e6
        freq_hz = int(frame["frequency"] + 0.5)
        n_payload = max(frame["n_symbols"] - 12, 0)
        bits = (np.asarray(frame["bits"], bool).tobytes()
                .translate(_BITS_ASCII).decode("ascii"))
        return (f"RAW: {self.file_info} {ts_ms:012.4f} {freq_hz:010d} "
                f"N:{frame['magnitude']:05.2f}{frame['noise']:+06.2f} "
                f"I:{frame['id']:011d} {frame['confidence']:3d}% "
                f"{frame['level']:.5f} {n_payload:3d} {bits}")

    def format_ida(self, burst) -> str:
        """IDA: parsed line (frame_output.c:203-362). `burst` is a
        decode.ida.IdaBurst."""
        self._ensure_init(burst.timestamp_ns)
        parsed_info = f"p-{self.t0_ns // 1_000_000_000}"
        ts_ms = (burst.timestamp_ns - self.t0_ns) / 1e6
        freq_hz = int(burst.frequency + 0.5)
        leveldb = (20.0 * math.log10(burst.level)
                   if burst.level > 0 else -99.99)
        out = (f"IDA: {parsed_info} {ts_ms:014.4f} {freq_hz:010d} "
               f"{burst.confidence:3d}% {leveldb:06.2f}|"
               f"{burst.noise:07.2f}|{burst.magnitude:05.2f} "
               f"{max(burst.n_symbols, 0):3d} "
               f"{'UL' if burst.direction == 'UL' else 'DL'} ")
        out += burst.lcw_header

        bs = burst.bch_stream
        bch_len = len(bs)
        if bch_len < 20:
            return out

        out += f"{bs[0]}{bs[1]}{bs[2]}"
        out += f" cont={bs[3]}"
        out += f" {bs[4]}"
        out += f" ctr={bs[5]}{bs[6]}{bs[7]}"
        out += f" {bs[8]}{bs[9]}{bs[10]}"
        out += f" len={burst.da_len:02d}"
        out += f" 0:{bs[16]}{bs[17]}{bs[18]}{bs[19]}"

        # 20-byte payload from the stream (all of it, independent of da_len)
        payload20 = bytes(
            int("".join(str(int(b)) for b in bs[20 + i * 8:28 + i * 8]), 2)
            for i in range(20))
        hex_parts = []
        if burst.da_len > 0:
            # quirk preserved: the check starts at da_len+1
            # (frame_output.c:277)
            all_zero = all(payload20[i] == 0
                           for i in range(burst.da_len + 1, 20))
            if all_zero:
                nbytes = burst.da_len
                body = ".".join(f"{payload20[i]:02x}" for i in range(nbytes))
            else:
                nbytes = 20
                chars = []
                for i in range(20):
                    if i > 0:
                        chars.append("!" if (i == burst.da_len
                                             and 0 < burst.da_len < 20)
                                     else ".")
                    chars.append(f"{payload20[i]:02x}")
                body = "".join(chars)
        else:
            nbytes = 20
            body = ".".join(f"{payload20[i]:02x}" for i in range(20))
        hexlen = nbytes * 3 - 1 + 1
        out += " [" + body + "]"
        out += " " * max(60 - hexlen, 0)

        if burst.da_len > 0:
            out += f" {burst.stored_crc:04x}/{burst.computed_crc:04x}"
            out += " CRC:OK" if burst.crc_ok else " CRC:no"
        else:
            out += "  ---   "

        if bch_len > 9 * 20 + 16:
            out += " " + "".join(str(int(b)) for b in bs[196:bch_len])
        else:
            out += " 0000"

        if burst.da_len > 0 and bch_len >= 9 * 20:
            out += " SBD: "
            for i in range(20):
                byte = int("".join(str(int(b))
                                   for b in bs[20 + i * 8:28 + i * 8]), 2)
                out += chr(byte) if 32 <= byte < 127 else "."
        return out
