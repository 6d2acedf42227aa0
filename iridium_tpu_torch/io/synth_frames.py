"""Synthetic IRA / IBC / IDA frame bit encoders (test oracles).

These build payload bit strings that the decode layer — and the C
reference — must accept and parse back to the same fields. They are the
encode-side inverses of:
  - BCH(31,21)+parity interleaved blocks (frame_decode.c:147-199,399-407)
  - the IRA/IBC field layouts (frame_decode.c:317-393)
  - the LCW permutation + 3-component BCH (ida_decode.c:53-60,193-253)
  - the IDA payload scramble (ida_decode.c:259-377) and the spliced
    CRC-CCITT convention (ida_decode.c:604-634)
"""

from __future__ import annotations

import numpy as np

from ..decode import bch
from ..decode.frame import ACCESS_DL, ACCESS_UL
from ..decode.ida import LCW_PERM, crc_ccitt


def bch_encode(data_val: int, poly: int, syn_bits: int) -> int:
    shifted = data_val << syn_bits
    return shifted ^ bch.gf2_remainder(poly, shifted)


def _ra_block32(data21) -> list:
    """21 data bits -> 31-bit BCH(31,21) codeword + even-parity bit."""
    d = bch.bits_to_uint(data21)
    cw = bch_encode(d, 1207, 10)
    bits = list(bch.uint_to_bits(cw, 31))
    parity = (sum(int(b) for b in bits[:31])) % 2
    # check_parity32 counts data+check+parity even; data+check == all 31
    bits.append(parity)
    return bits


def interleave2(out1, out2) -> list:
    """Inverse of frame_decode.c de_interleave (64 bits)."""
    x = [0] * 64
    p = 0
    for s in range(31, 0, -2):
        x[2 * s] = out1[p]
        x[2 * s + 1] = out1[p + 1]
        p += 2
    p = 0
    for s in range(30, -1, -2):
        x[2 * s] = out2[p]
        x[2 * s + 1] = out2[p + 1]
        p += 2
    return x


def interleave3(o1, o2, o3) -> list:
    """Inverse of frame_decode.c de_interleave3 (96 bits)."""
    x = [0] * 96
    for out, start in ((o1, 47), (o2, 46), (o3, 45)):
        p = 0
        for s in range(start, -1, -3):
            x[2 * s] = out[p]
            x[2 * s + 1] = out[p + 1]
            p += 2
    return x


def _uint_bits(val: int, n: int) -> list:
    return [(val >> (n - 1 - i)) & 1 for i in range(n)]


def _signed12(v: int) -> list:
    if v < 0:
        return [1] + _uint_bits(v + (1 << 11), 11)
    return [0] + _uint_bits(v, 11)


def ira_payload_bits(sat_id: int, beam_id: int, xyz, pages=()) -> np.ndarray:
    """Payload bits (after the access code) of an IRA frame."""
    hdr = (_uint_bits(sat_id, 7) + _uint_bits(beam_id, 6)
           + [0]  # bit 13 unused by the parser's sat/beam extraction
           )
    # field layout: sat[0:7] beam[7:13] x[13:25] y[25:37] z[37:49] rest 0
    data = (_uint_bits(sat_id, 7) + _uint_bits(beam_id, 6)
            + _signed12(xyz[0]) + _signed12(xyz[1]) + _signed12(xyz[2]))
    data += [0] * (63 - len(data))
    del hdr
    # pages: 42 bits each [tmsi(32) pad(2) msc(5) pad(3)]
    for tmsi, msc in pages:
        data += (_uint_bits(tmsi, 32) + [0, 0] + _uint_bits(msc, 5)
                 + [0, 0, 0])
    # all-ones terminator page
    data += [1] * 42
    # pad to whole blocks of 21
    while len(data) % 21:
        data.append(0)
    blocks = [_ra_block32(data[i:i + 21]) for i in range(0, len(data), 21)]
    assert len(blocks) >= 3
    bits = interleave3(blocks[0], blocks[1], blocks[2])
    rest = blocks[3:]
    for i in range(0, len(rest) - 1, 2):
        bits += interleave2(rest[i], rest[i + 1])
    return np.array(bits, np.uint8)


def ibc_payload_bits(sat_id: int, beam_id: int, timeslot=0, sv_blocking=0,
                     iri_time: int | None = None, bc_type: int = 0) -> np.ndarray:
    """Payload bits of an IBC frame: 6-bit BCH(7,3) header (one bit
    dropped -- the parser reads only 6 bits) + interleaved blocks."""
    hdr_cw = bch_encode(bc_type, 29, 4)           # 7-bit codeword
    hdr_bits = _uint_bits(hdr_cw >> 1, 6)          # parser reads 6 bits
    # ensure the 6-bit truncation still BCH-checks: the parser computes
    # the syndrome of the 6-bit value directly, so encode for 6 bits:
    # find 6-bit value whose top 3 bits are bc_type and syndrome==0
    found = None
    for low in range(8):
        v = (bc_type << 3) | low
        if bch.gf2_remainder(29, v) == 0:
            found = v
            break
    if found is None:    # fall back: 1-bit-correctable value
        found = bc_type << 3
    hdr_bits = _uint_bits(found, 6)

    data = (_uint_bits(sat_id, 7) + _uint_bits(beam_id, 6)
            + [0, timeslot & 1, sv_blocking & 1])
    data += [0] * (42 - len(data))
    if iri_time is not None:
        blk2 = _uint_bits(1, 6) + [0] * 4 + _uint_bits(iri_time, 32)
        data += blk2
    while len(data) % 21:
        data.append(0)
    blocks = [_ra_block32(data[i:i + 21]) for i in range(0, len(data), 21)]
    bits = list(hdr_bits)
    for i in range(0, len(blocks) - 1, 2):
        bits += interleave2(blocks[i], blocks[i + 1])
    return np.array(bits, np.uint8)


# ---- IDA encoding ----

def _lcw_bits(ft: int, lcw_ft: int, lcw_code: int, lcw3_val: int) -> list:
    """Inverse of decode_lcw: component encode -> permutation -> pair-swap."""
    cw1 = bch_encode(ft, 29, 4)                     # 7 bits
    # lcw2: 14-bit codewords of poly 465 with even value (LSB 0),
    # found by scanning GF(2) multiples of the generator
    # Enumerate GF(2) multiples of the generator; an even codeword
    # transmits exactly; an odd one is sent with its LSB dropped (the
    # decoder appends a 0 and its 1-bit syndrome correction restores it).
    data6 = ((lcw_ft & 0x3) << 4) | (lcw_code & 0xF)
    cw2 = None
    for prefer_even in (True, False):
        for m in range(1 << 6):
            c = 0
            mm, g = m, 465
            while mm:
                if mm & 1:
                    c ^= g
                mm >>= 1
                g <<= 1
            if c < (1 << 14) and (c >> 8) == data6:
                if prefer_even and (c & 1):
                    continue
                cw2 = c & ~1
                break
        if cw2 is not None:
            break
    assert cw2 is not None, "no codeword for lcw2 data"
    cw3 = bch_encode(lcw3_val, 41, 5)               # 26 bits

    lcw_bits = (_uint_bits(cw1, 7) + _uint_bits(cw2 >> 1, 13)
                + _uint_bits(cw3, 26))
    # invert permutation: lcw_bits[i] = swapped[PERM[i]-1]
    swapped = [0] * 46
    for i in range(46):
        swapped[LCW_PERM[i] - 1] = lcw_bits[i]
    data = [0] * 46
    for i in range(0, 46, 2):
        data[i + 1] = swapped[i]
        data[i] = swapped[i + 1]
    return data


def _interleave_n(h1, h2, n_sym) -> list:
    x = [0] * (2 * n_sym)
    p = 0
    for s in range(n_sym - 1, 0, -2):
        x[2 * s] = h1[p]
        x[2 * s + 1] = h1[p + 1]
        p += 2
    p = 0
    for s in range(n_sym - 2, -1, -2):
        x[2 * s] = h2[p]
        x[2 * s + 1] = h2[p + 1]
        p += 2
    return x


def _solve_crc_bits(stream: list) -> list:
    """Choose stream[180:196] so the reference's spliced CRC check
    (ida_decode.c:604-634) computes 0."""
    L = len(stream)

    def crc_of(bits):
        nbytes = (len(bits) + 7) // 8
        buf = bytearray(nbytes)
        for i, b in enumerate(bits):
            if b:
                buf[i // 8] |= 1 << (7 - (i % 8))
        return crc_ccitt(bytes(buf))

    def buf_bits(s):
        return list(s[:20]) + [0] * 12 + list(s[20:L - 4])

    # crc is affine in the input bits: crc(x) = crc(0) ^ sum x_i * lin_i
    base = list(stream)
    for i in range(180, 196):
        base[i] = 0
    c_zero = crc_of(buf_bits([0] * L))
    lin = []
    for i in range(180, 196):
        e = [0] * L
        e[i] = 1
        lin.append(crc_of(buf_bits(e)) ^ c_zero)
    c_base = crc_of(buf_bits(base))
    # want crc(base ^ sum_{i in S} e_i) == 0  =>  sum_{i in S} lin_i = c_base
    basis = [0] * 16
    sel = [0] * 16
    for i, col in enumerate(lin):
        cur, cursel = col, 1 << i
        for b in range(15, -1, -1):
            if not (cur >> b) & 1:
                continue
            if basis[b]:
                cur ^= basis[b]
                cursel ^= sel[b]
            else:
                basis[b] = cur
                sel[b] = cursel
                break
    cur, cursel = c_base, 0
    for b in range(15, -1, -1):
        if (cur >> b) & 1:
            if not basis[b]:
                raise ValueError("CRC system unsolvable")
            cur ^= basis[b]
            cursel ^= sel[b]
    out = list(base)
    for i in range(16):
        if (cursel >> i) & 1:
            out[180 + i] = 1
    return out


def ida_payload_bits(payload: bytes, cont=0, ctr=0,
                     lcw_ft=0, lcw_code=0, lcw3_val=0) -> np.ndarray:
    """Payload bits (after access code) of an IDA frame whose descrambled
    BCH stream is exactly 200 bits (2.5 interleave blocks)."""
    da_len = len(payload)
    assert da_len <= 20
    pay = payload + bytes(20 - da_len)

    stream = [0] * 200
    stream[3] = cont
    stream[5:8] = _uint_bits(ctr, 3)
    stream[11:16] = _uint_bits(da_len, 5)
    for i, byte in enumerate(pay):
        stream[20 + 8 * i:28 + 8 * i] = _uint_bits(byte, 8)
    if da_len > 0:
        stream = _solve_crc_bits(stream)

    # 200 bits -> 10 chunks of 20 -> BCH(31,20) codewords
    chunks = []
    for i in range(10):
        d = bch.bits_to_uint(stream[20 * i:20 * i + 20])
        chunks.append(_uint_bits(bch_encode(d, 3545, 11), 31))

    order = [3, 1, 2, 0]
    bits: list = []
    for blk in range(2):
        combined = [0] * 124
        for c in range(4):
            combined[order[c] * 31:order[c] * 31 + 31] = chunks[4 * blk + c]
        h1, h2 = combined[:62], combined[62:]
        bits += _interleave_n(h1, h2, 62)
    # partial tail: 2 chunks -> combined 62 = h2[1:32] + h1[1:32]
    combined = chunks[8] + chunks[9]
    h2 = [0] + combined[:31]
    h1 = [0] + combined[31:]
    bits += _interleave_n(h1, h2, 32)

    lcw = _lcw_bits(2, lcw_ft, lcw_code, lcw3_val)
    return np.array(lcw + bits, np.uint8)


def with_access(payload_bits, direction="DL") -> np.ndarray:
    acc = ACCESS_DL if direction == "DL" else ACCESS_UL
    return np.concatenate([np.asarray(acc, np.uint8),
                           np.asarray(payload_bits, np.uint8)])


# ---- SBD/ACARS messages over IDA (test and smoke-run inputs) ----

def acars_sbd(text: bytes, reg: bytes = b".N1234A",
              label: bytes = b"H1") -> bytes:
    """An ACARS SBD payload that the fallback parser accepts: SOH, odd
    parity on every byte, Kermit CRC, DEL (sbd_acars.c:603-996)."""
    from ..decode.sbd_acars import crc16_kermit

    core = (b"2" + reg + b"\x06" + label + b"1" + b"\x02" + text + b"\x03")
    core = bytes(c | 0x80 if bin(c).count("1") % 2 == 0 else c
                 for c in core)
    crc = crc16_kermit(core)
    return b"\x01" + core + bytes([crc & 0xFF, crc >> 8]) + b"\x7f"


def sbd_ida_message(sbd: bytes) -> bytes:
    """A single-packet DL SBD message (type 0x76 0x08, msgcnt 1) carrying
    `sbd`, as the IDA reassembler hands it to the ACARS decoder."""
    return (bytes([0x76, 0x08, 0x20, 0, 0, 1, 0, 0x10, len(sbd), 1])
            + sbd)


def ida_message_bursts(message: bytes, **lcw) -> list:
    """Split `message` into IDA payload bit strings of at most 20 bytes,
    with the continuation flag and counter the reassembler follows
    (ida_decode.c:667-748)."""
    parts = [message[i:i + 20] for i in range(0, len(message), 20)]
    return [ida_payload_bits(p, cont=int(k < len(parts) - 1), ctr=k % 8,
                             **lcw)
            for k, p in enumerate(parts)]
