"""IDA (Iridium Data) frame decoder: LCW extraction, payload descramble
with Chase BCH(31,20), CRC-CCITT verification, LCW pretty-printing and
multi-burst reassembly.

Parity sources (reference file:line):
  - LCW permutation + 3-component BCH:  ida_decode.c:53-60, 193-253
  - payload descramble (124-bit blocks,
    2-way de-interleave, chunk reorder
    [3,1,2,0], partial-tail handling):  ida_decode.c:259-377
  - CRC-CCITT-FALSE w/ 12-bit splice:   ida_decode.c:379-394, 604-634
  - field extraction / gates:           ida_decode.c:543-664
  - LCW pretty-printer:                 ida_decode.c:396-539
  - 16-slot reassembly (dir match,
    |df|<=260 Hz, dt<=280 ms,
    ctr=(prev+1)%8):                    ida_decode.c:667-748
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import bch, gf2

LCW_PERM = [40, 39, 36, 35, 32, 31, 28, 27, 24, 23,
            20, 19, 16, 15, 12, 11, 8, 7, 4, 3,
            41, 38, 37, 34, 33, 30, 29, 26, 25, 22,
            21, 18, 17, 14, 13, 10, 9, 6, 5, 2,
            1, 46, 45, 44, 43, 42]

# pair-swap then permute, fused into one gather (ida_decode.c:193-253)
_LCW_IDX = np.array([p - 1 for p in LCW_PERM], np.int32)
_LCW_IDX = (_LCW_IDX ^ 1)  # pair swap: index i reads source bit i^1

BCH_DA_SYN = 11
BCH_DA_DATA = 20
IDA_MAX_REASSEMBLY = 16


@dataclasses.dataclass
class Lcw:
    ft: int = 0
    lcw_ok: int = 0
    lcw_ft: int = 0
    lcw_code: int = 0
    lcw3_val: int = 0
    ec_lcw: int = 0


def decode_lcw(data) -> Lcw | None:
    """ida_decode.c:193-253: pair-swap, permute, 3-component BCH."""
    if len(data) < 46:
        return None
    lcw_bits = np.asarray(data[:46], np.uint8)[_LCW_IDX]

    v1 = int(gf2.pack_bits(lcw_bits[:7]))
    s1 = int(gf2.TBL_LCW1.syndrome(np.uint32(v1)))
    if s1 != 0:
        if s1 >= 16 or bch.TBL_LCW1.errs[s1] < 0:
            return None
        v1 ^= int(bch.TBL_LCW1.locator[s1])
    ft = (v1 >> 4) & 0x7

    v2 = int(gf2.pack_bits(lcw_bits[7:20])) << 1
    s2 = int(gf2.TBL_LCW2.syndrome(np.uint32(v2)))
    if s2 != 0:
        if s2 >= 256 or bch.TBL_LCW2.errs[s2] < 0:
            return None
        v2 ^= int(bch.TBL_LCW2.locator[s2])

    v3 = int(gf2.pack_bits(lcw_bits[20:46]))
    s3 = int(gf2.TBL_LCW3.syndrome(np.uint32(v3)))
    if s3 != 0:
        if s3 >= 32 or bch.TBL_LCW3.errs[s3] < 0:
            return None
        v3 ^= int(bch.TBL_LCW3.locator[s3])

    lcw2_data = (v2 >> 8) & 0x3F
    lcw3_data = v3 >> 5
    return Lcw(ft=ft, lcw_ok=1,
               lcw_ft=(lcw2_data >> 4) & 0x3,
               lcw_code=lcw2_data & 0xF,
               lcw3_val=lcw3_data,
               ec_lcw=(s1 != 0) + (s2 != 0) + (s3 != 0))


def de_interleave_n(x, n_sym):
    """2*n_sym values -> two n_sym-length halves (ida_decode.c:259-272)."""
    out1 = []
    out2 = []
    for s in range(n_sym - 1, 0, -2):
        out1 += [x[2 * s], x[2 * s + 1]]
    for s in range(n_sym - 2, -1, -2):
        out2 += [x[2 * s], x[2 * s + 1]]
    return out1, out2


_CHUNK_ORDER = np.array([3, 1, 2, 0], np.int32)


def descramble_payload(data, llr, max_bch=512):
    """ida_decode.c:276-377 -> (bch_stream bit array, fixederrs).

    All 31-bit chunks of every full 124-bit block are Chase-decoded in one
    batched call; the reference's early-exit (return at the first failed
    chunk) and stream-length cap (skip chunks once len+20 > max_bch, keep
    going) are applied to the results in the identical scan order."""
    data = np.asarray(data, np.uint8)
    data_len = len(data)
    n_full = data_len // 124
    remain = data_len % 124

    stream_vals: list = []          # corrected 20-bit chunk values, in order
    fixederrs = 0
    failed_early = False

    if n_full:
        blocks = data[:n_full * 124].reshape(n_full, 124)
        i1, i2 = gf2.deint2_idx(62)
        comb = np.concatenate([blocks[:, i1], blocks[:, i2]], axis=1)
        chunks = comb.reshape(n_full, 4, 31)[:, _CHUNK_ORDER, :].reshape(-1, 31)
        if llr is None:
            lch = None
        else:
            lb = np.asarray(llr[:n_full * 124], np.float32).reshape(n_full, 124)
            lcomb = np.concatenate([lb[:, i1], lb[:, i2]], axis=1)
            lch = lcomb.reshape(n_full, 4, 31)[:, _CHUNK_ORDER, :].reshape(-1, 31)
        cv, ce, cf = gf2.TBL_DA.chase(gf2.pack_bits(chunks), lch)
        n_ch = len(cv)
        # chunk k is attempted iff 20*k + 20 <= max_bch (the cap `break`
        # skips it but continues; a failure among ATTEMPTED chunks returns)
        k_cap = min(n_ch, max(0, (max_bch - BCH_DA_DATA) // BCH_DA_DATA + 1))
        fails = np.nonzero(ce[:k_cap] < 0)[0]
        k_end = int(fails[0]) if len(fails) else k_cap
        failed_early = len(fails) > 0
        stream_vals.extend(cv[:k_end] >> BCH_DA_SYN)
        fixederrs += int(cf[:k_end].sum())
        if failed_early:
            return _vals_to_bits(stream_vals), fixederrs

    slen = BCH_DA_DATA * len(stream_vals)
    if remain >= 4 and slen + 2 * (remain // 2 - 1) <= max_bch:
        n_sym_last = remain // 2
        tail = data[n_full * 124:]
        ti1, ti2 = gf2.deint2_idx(n_sym_last)
        if n_sym_last > 1 and slen + BCH_DA_DATA <= max_bch:
            # combined = h2[1:] + h1[1:] (ida_decode.c partial-tail path)
            combined = np.concatenate([tail[ti2][1:], tail[ti1][1:]])
            if llr is not None:
                lt = np.asarray(llr[n_full * 124:], np.float32)
                lcombined = np.concatenate([lt[ti2][1:], lt[ti1][1:]])
            n_tc = len(combined) // 31
            n_tc = min(n_tc, (max_bch - slen) // BCH_DA_DATA)
            if n_tc > 0:
                tc = combined[:n_tc * 31].reshape(-1, 31)
                ltc = (None if llr is None
                       else lcombined[:n_tc * 31].reshape(-1, 31))
                cv, ce, cf = gf2.TBL_DA.chase(gf2.pack_bits(tc), ltc)
                fails = np.nonzero(ce < 0)[0]
                k_end = int(fails[0]) if len(fails) else len(cv)
                stream_vals.extend(cv[:k_end] >> BCH_DA_SYN)
                fixederrs += int(cf[:k_end].sum())
    return _vals_to_bits(stream_vals), fixederrs


def _vals_to_bits(vals: list) -> np.ndarray:
    if not vals:
        return np.zeros(0, np.uint8)
    return gf2.unpack_bits(np.asarray(vals, np.uint32), BCH_DA_DATA).ravel()


def _crc_table(poly: int = 0x1021) -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
        t[b] = crc
    return t


_CRC_TBL = _crc_table()


def crc_ccitt(data: bytes) -> int:
    """CRC-CCITT-FALSE (0x1021, init 0xFFFF) — table-driven
    (ida_decode.c:379-394)."""
    crc = 0xFFFF
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(_CRC_TBL[(crc >> 8) ^ byte])
    return crc


def format_lcw_header(ft: int, lcw: Lcw) -> str:
    """ida_decode.c:405-539 — byte-format-compatible with bitsparser.py."""
    b = format(lcw.lcw3_val, "021b")

    def u(s):
        return int(s, 2) if s else 0

    if lcw.lcw_ft == 0:
        ty = "maint"
        if lcw.lcw_code == 0:
            code = (f"sync[status:{int(b[1])},dtoa:{u(b[3:13])},"
                    f"dfoa:{u(b[13:21])}]")
            remain = f"{b[0]}|{b[2]}"
        elif lcw.lcw_code == 1:
            code = f"switch[dtoa:{u(b[3:13])},dfoa:{u(b[13:21])}]"
            remain = b[:3]
        elif lcw.lcw_code == 3:
            code = (f"maint[2][lqi:{u(b[1:3])},power:{u(b[3:6])},"
                    f"f_dtoa:{u(b[6:13])},f_dfoa:{u(b[13:20])}]")
            remain = f"{b[0]}|{b[20]}"
        elif lcw.lcw_code == 6:
            code = "geoloc"
            remain = b
        elif lcw.lcw_code == 12:
            code = f"maint[1][lqi:{u(b[19:21])},power:{u(b[16:19])}]"
            remain = b[:16]
        elif lcw.lcw_code == 15:
            code = "<silent>"
            remain = b
        else:
            code = f"rsrvd({lcw.lcw_code})"
            remain = b
    elif lcw.lcw_ft == 1:
        ty = "acchl"
        if lcw.lcw_code == 1:
            code = (f"acchl[msg_type:{u(b[1:4]):01x},"
                    f"bloc_num:{int(b[4]):01x},"
                    f"sapi_code:{u(b[5:8]):01x},segm_list:{b[8:16]}]")
            remain = f"{b[0]},{u(b[16:21]):02x}"
        else:
            code = f"rsrvd({lcw.lcw_code})"
            remain = b
    elif lcw.lcw_ft == 2:
        ty = "hndof"
        if lcw.lcw_code == 3:
            cand = "P" if b[2] == "0" else "S"
            slot = 1 + int(b[6]) * 2 + int(b[7])
            code = (f"handoff_resp[cand:{cand},denied:{int(b[3])},"
                    f"ref:{int(b[4])},slot:{slot},sband_up:{u(b[8:13])},"
                    f"sband_dn:{u(b[13:18])},access:{u(b[18:21]) + 1}]")
            remain = f"{b[:2]},{b[5]}"
        elif lcw.lcw_code == 12:
            code = "handoff_cand"
            remain = f"{b[:11]},{b[11:21]}"
        elif lcw.lcw_code == 15:
            code = "<silent>"
            remain = b
        else:
            code = f"rsrvd({lcw.lcw_code})"
            remain = b
    else:
        ty = "rsrvd"
        code = f"<{lcw.lcw_code}>"
        remain = b

    raw = f"LCW({ft},T:{ty},C:{code},{remain})"
    return f"{raw:<110} "


@dataclasses.dataclass
class IdaBurst:
    timestamp_ns: int
    frequency: float
    direction: str
    magnitude: float
    noise: float
    level: float
    confidence: int
    n_symbols: int
    cont: int
    da_ctr: int
    da_len: int
    crc_ok: bool
    stored_crc: int
    computed_crc: int
    fixederrs: int
    payload: bytes
    bch_stream: list
    lcw: Lcw
    lcw_header: str


def ida_decode(frame: dict) -> IdaBurst | None:
    """ida_decode.c:543-664. frame: demod output dict (bits/llr/...)."""
    bits = np.asarray(frame["bits"], np.uint8)
    if len(bits) < 24 + 46 + 124:
        return None
    if frame.get("direction") not in ("DL", "UL"):
        return None
    data = bits[24:]
    llr = frame.get("llr")
    dllr = None if llr is None else np.asarray(llr)[24:]

    lcw = decode_lcw(data)
    if lcw is None or lcw.ft != 2:
        return None

    payload_data = data[46:]
    payload_llr = None if dllr is None else dllr[46:]
    if len(payload_data) < 124:
        return None

    stream, fixederrs = descramble_payload(payload_data, payload_llr)
    if len(stream) < 196:
        return None

    bs = stream
    cont = int(bs[3])
    da_ctr = int(bs[5]) << 2 | int(bs[6]) << 1 | int(bs[7])
    da_len = (int(bs[11]) << 4 | int(bs[12]) << 3 | int(bs[13]) << 2
              | int(bs[14]) << 1 | int(bs[15]))
    zero1 = int(bs[17]) << 2 | int(bs[18]) << 1 | int(bs[19])
    if zero1 != 0 or da_len > 20:
        return None

    payload = bytes(np.packbits(np.asarray(bs[20:180], np.uint8)))

    crc_ok = False
    stored_crc = 0
    computed = 0
    if da_len > 0:
        stored_crc = int(gf2.pack_bits(np.asarray(bs[180:196], np.uint8)))
        # CRC input: bits 0-19, 12 zero bits, bits 20..len-4
        stream_bits = np.concatenate(
            [np.asarray(bs[:20], np.uint8), np.zeros(12, np.uint8),
             np.asarray(bs[20:len(bs) - 4], np.uint8)])
        computed = crc_ccitt(bytes(np.packbits(stream_bits)))
        crc_ok = computed == 0

    return IdaBurst(
        timestamp_ns=frame["timestamp_ns"],
        frequency=frame["frequency"],
        direction=frame["direction"],
        magnitude=frame["magnitude"],
        noise=frame["noise"],
        level=frame["level"],
        confidence=frame["confidence"],
        n_symbols=max(frame["n_symbols"] - 12, 0),
        cont=cont, da_ctr=da_ctr, da_len=da_len,
        crc_ok=crc_ok, stored_crc=stored_crc, computed_crc=computed,
        fixederrs=fixederrs,
        payload=payload[:da_len] if da_len > 0 else payload,
        bch_stream=bs, lcw=lcw,
        lcw_header=format_lcw_header(lcw.ft, lcw))


# ---- Multi-burst reassembly (ida_decode.c:667-748) ----

@dataclasses.dataclass
class _Slot:
    active: bool = False
    direction: str = "DL"
    frequency: float = 0.0
    last_timestamp: int = 0
    last_ctr: int = 0
    data: bytes = b""


class IdaReassembler:
    def __init__(self):
        self.slots = [_Slot() for _ in range(IDA_MAX_REASSEMBLY)]

    def push(self, burst: IdaBurst, cb):
        """cb(data: bytes, timestamp_ns, frequency, direction, magnitude)"""
        if not burst.crc_ok or burst.da_len == 0:
            return False
        for s in self.slots:
            if not s.active or s.direction != burst.direction:
                continue
            if abs(s.frequency - burst.frequency) > 260.0:
                continue
            if burst.timestamp_ns < s.last_timestamp:
                continue
            if burst.timestamp_ns - s.last_timestamp > 280_000_000:
                continue
            if (s.last_ctr + 1) % 8 != burst.da_ctr:
                continue
            if len(s.data) + burst.da_len <= 1024:
                s.data += burst.payload[:burst.da_len]
            s.last_timestamp = burst.timestamp_ns
            s.last_ctr = burst.da_ctr
            if not burst.cont:
                cb(s.data, burst.timestamp_ns, s.frequency,
                   s.direction, burst.magnitude)
                s.active = False
                return True
            return False

        if burst.da_ctr == 0 and not burst.cont:
            cb(burst.payload[:burst.da_len], burst.timestamp_ns,
               burst.frequency, burst.direction, burst.magnitude)
            return True

        if burst.da_ctr == 0 and burst.cont:
            idx = None
            oldest = None
            for i, s in enumerate(self.slots):
                if not s.active:
                    idx = i
                    break
                if oldest is None or s.last_timestamp < oldest:
                    oldest = s.last_timestamp
                    idx = i
            s = self.slots[idx]
            s.active = True
            s.direction = burst.direction
            s.frequency = burst.frequency
            s.last_timestamp = burst.timestamp_ns
            s.last_ctr = burst.da_ctr
            s.data = burst.payload[:burst.da_len]
            return False
        return False

    def flush(self, now_ns: int):
        for s in self.slots:
            if s.active and now_ns > s.last_timestamp + 280_000_000:
                s.active = False
