"""IRA (ring alert) / IBC (broadcast) frame decoder.

Parity sources (reference file:line):
  - access codes:             frame_decode.c:51-56
  - 2/3-way de-interleave
    (pair-swap cancellation): frame_decode.c:156-199
  - parity-32 gate:           frame_decode.c:399-407
  - IBC detection + decode:   frame_decode.c:441-514
  - IRA detection + decode:   frame_decode.c:522-595
  - IRA field extraction:     frame_decode.c:317-366
  - IBC field extraction:     frame_decode.c:368-393
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import bch, gf2

ACCESS_DL = np.array([0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1,
                      0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1], np.uint8)
ACCESS_UL = np.array([1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1,
                      1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0], np.uint8)

BCH_RA_DATA = 21


def de_interleave(x):
    """64 values -> (32, 32): odd symbols reversed, even symbols reversed
    (net permutation after the cancelled pair-swaps,
    frame_decode.c:156-176)."""
    x = np.asarray(x)
    i1, i2 = gf2.deint2_idx(32)
    return x[i1], x[i2]


def de_interleave3(x):
    """96 values -> 3 x 32 via reverse stride-3 (frame_decode.c:178-199):
    symbols [47,44,...,2] / [46,43,...,1] / [45,42,...,0]."""
    x = np.asarray(x)
    return x[gf2.DEINT3_IDX[0]], x[gf2.DEINT3_IDX[1]], x[gf2.DEINT3_IDX[2]]


def _extract_uint(bits, n):
    v = 0
    for i in range(n):
        v = (v << 1) | int(bits[i])
    return v


def _extract_signed12(bits):
    sign = int(bits[0])
    mag = _extract_uint(bits[1:12], 11)
    return mag - (1 << 11) if sign else mag


def _check_parity32(block32, data_bits, check_bits):
    ones = int(np.sum(data_bits)) + int(np.sum(check_bits)) + int(block32[31])
    return ones % 2 == 0


def _chase_ra(block32, llr32):
    data, check, e, _ = bch.chase_decode(
        block32[:31], None if llr32 is None else llr32[:31],
        bch.TBL_RA, 10, BCH_RA_DATA)
    if e < 0:
        return None
    if not _check_parity32(block32, data, check):
        return None
    return data


def _chase_ra_batch(blocks32: np.ndarray, llrs32: np.ndarray | None):
    """Batched _chase_ra over K 32-bit blocks: Chase BCH(31,21) + the
    parity-32 gate (frame_decode.c:224-295, 399-407).

    blocks32: (K, 32) bits; llrs32: (K, 32) f32 or None.
    -> (data (K,) uint32 21-bit values, ok (K,) bool)."""
    v = gf2.pack_bits(blocks32[:, :31])
    l31 = None if llrs32 is None else np.asarray(llrs32, np.float32)[:, :31]
    cv, ce, _ = gf2.TBL_RA.chase(v, l31)
    ones = gf2.popcount32(cv) + blocks32[:, 31].astype(np.int32)
    ok = (ce >= 0) & (ones % 2 == 0)
    return cv >> 10, ok


@dataclasses.dataclass
class IraData:
    sat_id: int
    beam_id: int
    pos_xyz: tuple
    lat: float
    lon: float
    alt: int
    pages: list            # [(tmsi, msc_id)]


@dataclasses.dataclass
class IbcData:
    bc_type: int
    sat_id: int = 0
    beam_id: int = 0
    timeslot: int = 0
    sv_blocking: int = 0
    iri_time: int = 0


def _parse_ira(bs):
    n = len(bs)
    if n < 63:
        return IraData(0, 0, (0, 0, 0), 0.0, 0.0, 0, [])
    sat = _extract_uint(bs[0:7], 7)
    beam = _extract_uint(bs[7:13], 6)
    x = _extract_signed12(bs[13:25])
    y = _extract_signed12(bs[25:37])
    z = _extract_signed12(bs[37:49])
    xy = math.sqrt(float(x) * x + float(y) * y)
    lat = math.atan2(float(z), xy) * 180.0 / math.pi
    lon = math.atan2(float(y), float(x)) * 180.0 / math.pi
    alt = int(math.sqrt(float(x) * x + float(y) * y + float(z) * z)
              * 4.0) - 6378 + 23
    pages = []
    off = 63
    while off + 42 <= n and len(pages) < 12:
        page = bs[off:off + 42]
        if all(int(b) for b in page):
            break
        tmsi = _extract_uint(page[0:32], 32)
        msc = _extract_uint(page[34:39], 5)
        pages.append((tmsi, msc))
        off += 42
    return IraData(sat, beam, (x, y, z), lat, lon, alt, pages)


def _parse_ibc(bs, hdr_type):
    ibc = IbcData(bc_type=hdr_type)
    n = len(bs)
    if n < 42:
        return ibc
    ibc.sat_id = _extract_uint(bs[0:7], 7)
    ibc.beam_id = _extract_uint(bs[7:13], 6)
    ibc.timeslot = int(bs[14])
    ibc.sv_blocking = int(bs[15])
    if n >= 84:
        type2 = _extract_uint(bs[42:48], 6)
        if type2 == 1:
            ibc.iri_time = _extract_uint(bs[52:84], 32)
    return ibc


def frame_decode(frame: dict):
    """frame: dict with 'bits', 'llr', 'timestamp_ns', 'frequency'.

    Returns ('IRA', IraData) / ('IBC', IbcData) / None, mirroring the
    reference detection flow (frame_decode.c:414-598): IBC tried first,
    then IRA; each gated by Chase-BCH success + parity on the leading
    blocks."""
    bits = np.asarray(frame["bits"], np.uint8)
    llr = frame.get("llr")
    if len(bits) < 24:
        return None
    if not (np.array_equal(bits[:24], ACCESS_DL)
            or np.array_equal(bits[:24], ACCESS_UL)):
        return None

    data = bits[24:]
    dllr = None if llr is None else np.asarray(llr)[24:]
    n = len(data)

    # All candidate 32-bit blocks of a frame are Chase-decoded in ONE
    # batched call (decoding past the reference's early-exit point is
    # harmless — surplus results are discarded by the same walk order).
    i1, i2 = gf2.deint2_idx(32)

    def gather_groups(offs: list[int], src):
        """De-interleave each 64-value group at `offs` -> (2*len, 32)."""
        g = np.stack([src[o:o + 64] for o in offs])
        return np.stack([g[:, i1], g[:, i2]], axis=1).reshape(-1, 32)

    # ---- IBC ----
    if n >= 6 + 64:
        hdr = bch.bits_to_uint(data[:6])
        v, e = bch.TBL_HDR.correct(hdr)
        if e >= 0:
            # group offsets exactly as the reference loop would visit them
            # (off += 64 while off+64 <= min(262, n) and stream+42 <= 256)
            ibc_max = min(262, n)
            offs = [6]
            off, slen = 6 + 64, 42
            while off + 64 <= ibc_max and slen + 42 <= 256:
                offs.append(off)
                off += 64
                slen += 42
            blocks = gather_groups(offs, data)
            lls = None if dllr is None else gather_groups(offs, dllr)
            d, ok = _chase_ra_batch(blocks, lls)
            if ok[0] and ok[1]:
                bc_type = (v >> 4) & 0x7
                n_grp = 1
                while n_grp < len(offs) and ok[2 * n_grp] and ok[2 * n_grp + 1]:
                    n_grp += 1
                stream = gf2.unpack_bits(d[:2 * n_grp], BCH_RA_DATA).ravel()
                return "IBC", _parse_ibc(stream, bc_type)

    # ---- IRA ----
    if n >= 96:
        first3 = np.stack([data[gf2.DEINT3_IDX[0]], data[gf2.DEINT3_IDX[1]],
                           data[gf2.DEINT3_IDX[2]]])
        offs = []
        off, slen = 96, 63
        while off + 64 <= n and slen + 42 <= 512:
            offs.append(off)
            off += 64
            slen += 42
        if offs:
            blocks = np.concatenate([first3, gather_groups(offs, data)])
        else:
            blocks = first3
        if dllr is None:
            lls = None
        else:
            lfirst3 = np.stack([dllr[gf2.DEINT3_IDX[0]],
                                dllr[gf2.DEINT3_IDX[1]],
                                dllr[gf2.DEINT3_IDX[2]]])
            lls = (np.concatenate([lfirst3, gather_groups(offs, dllr)])
                   if offs else lfirst3)
        d, ok = _chase_ra_batch(blocks, lls)
        if ok[0] and ok[1] and ok[2]:
            n_blk = 3
            while (n_blk + 2 <= len(d) and ok[n_blk] and ok[n_blk + 1]):
                n_blk += 2
            stream = gf2.unpack_bits(d[:n_blk], BCH_RA_DATA).ravel()
            return "IRA", _parse_ira(stream)

    return None
