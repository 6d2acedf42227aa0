"""GSMTAP v2 UDP export of reassembled IDA frames (Wireshark).

Parity source: reference `gsmtap.c:29-96` / `gsmtap.h:18-30` — 16-byte
packed header (type=ABIS, sub=BCCH), ARFCN = (f - 1616 MHz)/41.667 kHz
with the 0x4000 uplink flag, raw frequency in frame_number, signal dBm
from 20*log10(magnitude).
"""

from __future__ import annotations

import math
import socket
import struct

GSMTAP_VERSION = 2
GSMTAP_HDR_LEN = 4           # 32-bit words
GSMTAP_TYPE_ABIS = 2
GSMTAP_SUB_BCCH = 1
ARFCN_F_UPLINK = 0x4000
IR_BASE_FREQ = 1_616_000_000.0
IR_CHANNEL_WIDTH = 41_666.667

_HDR = struct.Struct(">BBBBHbbIBBBB")


def build_packet(data: bytes, frequency: float, direction: str,
                 signal_dbm: int) -> bytes:
    fchan = int((frequency - IR_BASE_FREQ) / IR_CHANNEL_WIDTH) & 0xFFFF
    arfcn = fchan | (ARFCN_F_UPLINK if direction == "UL" else 0)
    data = data[:240]
    hdr = _HDR.pack(GSMTAP_VERSION, GSMTAP_HDR_LEN, GSMTAP_TYPE_ABIS, 0,
                    arfcn, max(-128, min(127, signal_dbm)), 0,
                    int(frequency) & 0xFFFFFFFF,
                    GSMTAP_SUB_BCCH, 0, 0, 0)
    return hdr + data


class GsmtapSender:
    def __init__(self, host: str = "127.0.0.1", port: int = 4729):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.count = 0

    def send(self, data: bytes, frequency: float, direction: str,
             magnitude: float) -> None:
        if not data:
            return
        dbm = int(20.0 * math.log10(magnitude)) if magnitude > 0 else -128
        self.sock.sendto(build_packet(bytes(data), frequency, direction,
                                      dbm), self.addr)
        self.count += 1

    def close(self) -> None:
        self.sock.close()
