"""Cross-frame batched protocol decode: the --parsed hot path.

frame_decode/ida_decode (scalar-per-frame) spend most of their time in
per-call numpy overhead once the GF(2) math is vectorized. This module
decodes a whole BLOCK of demodulated frames at once: every BCH(31,21)
block of every frame rides in ONE gf2.TBL_RA.chase call, every IDA
BCH(31,20) chunk in ONE gf2.TBL_DA.chase call, and all LCW components in
three vectorized syndrome lookups. The per-frame early-exit walks
(extension groups stop at the first failed pair, descramble stops at the
first failed chunk) are then applied to the precomputed results in the
reference's exact scan order — decoding past an early-exit point is pure
waste, never a behavior change, because surplus results are discarded.

Parity contract: results are identical to frame.frame_decode /
ida.ida_decode on every frame (tested in tests/test_torch_decode.py); those
remain the readable single-frame reference implementations.

Reference behavior sources: frame_decode.c:414-598, ida_decode.c:543-664.
"""

from __future__ import annotations

import numpy as np

from . import bch, gf2
from . import frame as frame_mod
from . import ida as ida_mod

_MAX_IBC_GROUPS = 4        # off 6+64g, off+64 <= 262
_MAX_IRA_EXT = 10          # stream cap 63+42g+42 <= 512


def _build_ra_idx():
    i1, i2 = gf2.deint2_idx(32)
    pair = np.stack([i1, i2])                      # (2, 32)
    ibc = np.concatenate(
        [6 + 64 * g + pair for g in range(_MAX_IBC_GROUPS)])
    ira = np.concatenate(
        [gf2.DEINT3_IDX]
        + [96 + 64 * g + pair for g in range(_MAX_IRA_EXT)])
    return ibc.astype(np.int32), ira.astype(np.int32)


_IBC_IDX, _IRA_IDX = _build_ra_idx()     # (8, 32), (23, 32) absolute indices

_CHUNK_IDX_CACHE: dict[int, np.ndarray] = {}
_TAIL_IDX_CACHE: dict[int, np.ndarray] = {}


def _chunk_idx(n_full: int) -> np.ndarray:
    """(n_full*4, 31) absolute indices into the payload for the full-block
    descramble chunks, in the reference's scan order."""
    r = _CHUNK_IDX_CACHE.get(n_full)
    if r is None:
        i1, i2 = gf2.deint2_idx(62)
        comb = np.concatenate([i1, i2])            # (124,)
        per_block = comb.reshape(4, 31)[ida_mod._CHUNK_ORDER]   # (4, 31)
        r = (124 * np.arange(n_full, dtype=np.int32)[:, None, None]
             + per_block[None]).reshape(-1, 31)
        _CHUNK_IDX_CACHE[n_full] = r
    return r


def _tail_idx(remain: int) -> np.ndarray:
    """(n_tc, 31) indices into the REMAINDER region for the partial-tail
    chunks (combined = h2[1:] + h1[1:], ida_decode.c partial-tail path)."""
    r = _TAIL_IDX_CACHE.get(remain)
    if r is None:
        n_sym = remain // 2
        ti1, ti2 = gf2.deint2_idx(n_sym)
        combined = np.concatenate([ti2[1:], ti1[1:]])
        n_tc = len(combined) // 31
        r = combined[:n_tc * 31].reshape(-1, 31).astype(np.int32)
        _TAIL_IDX_CACHE[remain] = r
    return r


class _Slices:
    """Bookkeeping for one frame's rows inside the global batch arrays."""
    __slots__ = ("kind", "data", "dllr", "n",
                 "ibc_off", "ibc_cnt", "ira_off", "ira_cnt", "hdr_pos",
                 "lcw_pos", "da_off", "da_cnt", "tail_off", "tail_cnt",
                 "payload")

    def __init__(self):
        self.kind = None
        self.ibc_cnt = self.ira_cnt = self.da_cnt = self.tail_cnt = 0
        self.hdr_pos = self.lcw_pos = -1


def decode_block(frames: list[dict], want_frame: bool = True,
                 want_ida: bool = True):
    """-> list of (frame_result, ida_result) aligned with `frames`.

    frame_result: ('IRA', IraData) | ('IBC', IbcData) | None
    ida_result:   IdaBurst | None
    """
    n_frames = len(frames)
    out = [(None, None)] * n_frames
    if n_frames == 0:
        return out

    infos: list[_Slices | None] = [None] * n_frames
    ra_rows, ra_llrs = [], []
    hdr_vals = []
    lcw_rows = []
    da_rows, da_llrs = [], []
    ra_total = 0
    da_total = 0

    for i, f in enumerate(frames):
        bits = np.asarray(f["bits"], np.uint8)
        llr = f.get("llr")
        if len(bits) < 24 or llr is None:
            # scalar fallback (keeps None-llr semantics identical)
            out[i] = (frame_mod.frame_decode(f) if want_frame else None,
                      ida_mod.ida_decode(f) if want_ida else None)
            continue
        if np.array_equal(bits[:24], frame_mod.ACCESS_DL):
            direction = "DL"
        elif np.array_equal(bits[:24], frame_mod.ACCESS_UL):
            direction = "UL"
        else:
            continue
        info = _Slices()
        info.kind = direction
        data = bits[24:]
        dllr = np.asarray(llr, np.float32)[24:]
        info.data = data
        info.dllr = dllr
        n = len(data)
        info.n = n

        if want_frame:
            # IBC candidate blocks (offsets fixed: 6+64g, g < #groups)
            if n >= 6 + 64:
                ibc_max = min(262, n)
                n_grp = min((ibc_max - 6) // 64, _MAX_IBC_GROUPS)
                rows = _IBC_IDX[:2 * n_grp]
                info.ibc_off = ra_total
                ra_rows.append(data[rows])
                ra_llrs.append(dllr[rows])
                info.ibc_cnt = 2 * n_grp
                ra_total += 2 * n_grp
                info.hdr_pos = len(hdr_vals)
                hdr_vals.append(int(gf2.pack_bits(data[:6])))
            # IRA candidate blocks
            if n >= 96:
                n_ext = min((n - 96) // 64, _MAX_IRA_EXT)
                rows = _IRA_IDX[:3 + 2 * n_ext]
                info.ira_off = ra_total
                ra_rows.append(data[rows])
                ra_llrs.append(dllr[rows])
                info.ira_cnt = 3 + 2 * n_ext
                ra_total += info.ira_cnt

        if want_ida and n >= 46 + 124:
            info.lcw_pos = len(lcw_rows)
            lcw_rows.append(data[:46][ida_mod._LCW_IDX])

        infos[i] = info

    # ---- vectorized LCW decode over all frames ----
    lcw_res: list = []
    if lcw_rows:
        L = np.stack(lcw_rows)
        v1 = gf2.pack_bits(L[:, :7])
        v2 = gf2.pack_bits(L[:, 7:20]) << 1
        v3 = gf2.pack_bits(L[:, 20:46])
        lcw_res = _lcw_correct_batch(v1, v2, v3)

    # IDA chunk gathering needs the LCW ft==2 gate first
    if want_ida:
        for i, f in enumerate(frames):
            info = infos[i]
            if info is None or info.lcw_pos < 0:
                continue
            lcw = lcw_res[info.lcw_pos]
            if lcw is None or lcw.ft != 2:
                continue
            payload = info.data[46:]
            pllr = info.dllr[46:]
            info.payload = payload
            plen = len(payload)
            n_full = plen // 124
            remain = plen % 124
            if n_full:
                idx = _chunk_idx(n_full)
                info.da_off = da_total
                da_rows.append(payload[idx])
                da_llrs.append(pllr[idx])
                info.da_cnt = len(idx)
                da_total += len(idx)
            if remain >= 4 and remain // 2 > 1:
                tidx = _tail_idx(remain)
                if len(tidx):
                    base = n_full * 124
                    info.tail_off = da_total
                    da_rows.append(payload[base + tidx])
                    da_llrs.append(pllr[base + tidx])
                    info.tail_cnt = len(tidx)
                    da_total += len(tidx)

    # ---- the two global chase calls ----
    if ra_rows:
        RA = np.concatenate(ra_rows)
        RL = np.concatenate(ra_llrs)
        ra_data, ra_ok = frame_mod._chase_ra_batch(RA, RL)
    if da_rows:
        DA = np.concatenate(da_rows)
        DL = np.concatenate(da_llrs)
        da_v, da_e, da_f = gf2.TBL_DA.chase(gf2.pack_bits(DA), DL)
        da_vals = da_v >> ida_mod.BCH_DA_SYN

    # ---- per-frame walks over precomputed results ----
    for i, f in enumerate(frames):
        info = infos[i]
        if info is None:
            continue
        fr_res = None
        ida_res = None

        if want_frame:
            fr_res = _walk_frame(info, hdr_vals,
                                 ra_data if ra_rows else None,
                                 ra_ok if ra_rows else None)
        if want_ida and info.lcw_pos >= 0:
            lcw = lcw_res[info.lcw_pos]
            if lcw is not None and lcw.ft == 2:
                ida_res = _walk_ida(f, info, lcw,
                                    da_vals if da_rows else None,
                                    da_e if da_rows else None,
                                    da_f if da_rows else None)
        out[i] = (fr_res, ida_res)
    return out


def _lcw_correct_batch(v1, v2, v3) -> list:
    """Vectorized decode_lcw over all frames (ida_decode.c:193-253)."""
    s1 = gf2.TBL_LCW1.syndrome(v1)
    s2 = gf2.TBL_LCW2.syndrome(v2)
    s3 = gf2.TBL_LCW3.syndrome(v3)
    ok1 = (s1 == 0) | ((s1 < 16) & (gf2.TBL_LCW1.errs[np.minimum(s1, 15)] >= 0))
    ok2 = (s2 == 0) | ((s2 < 256) & (gf2.TBL_LCW2.errs[np.minimum(s2, 255)] >= 0))
    ok3 = (s3 == 0) | ((s3 < 32) & (gf2.TBL_LCW3.errs[np.minimum(s3, 31)] >= 0))
    c1 = v1 ^ np.where(s1 < 16, gf2.TBL_LCW1.locator[np.minimum(s1, 15)], 0)
    c2 = v2 ^ np.where(s2 < 256, gf2.TBL_LCW2.locator[np.minimum(s2, 255)], 0)
    c3 = v3 ^ np.where(s3 < 32, gf2.TBL_LCW3.locator[np.minimum(s3, 31)], 0)
    res = []
    for k in range(len(v1)):
        if not (ok1[k] and ok2[k] and ok3[k]):
            res.append(None)
            continue
        ft = (int(c1[k]) >> 4) & 0x7
        lcw2_data = (int(c2[k]) >> 8) & 0x3F
        lcw3_data = int(c3[k]) >> 5
        res.append(ida_mod.Lcw(
            ft=ft, lcw_ok=1,
            lcw_ft=(lcw2_data >> 4) & 0x3,
            lcw_code=lcw2_data & 0xF,
            lcw3_val=lcw3_data,
            ec_lcw=int(s1[k] != 0) + int(s2[k] != 0) + int(s3[k] != 0)))
    return res


def _walk_frame(info: _Slices, hdr_vals, ra_data, ra_ok):
    """IBC-then-IRA walk with the reference's early exits
    (frame_decode.c:441-595) over the precomputed block results."""
    # ---- IBC ----
    if info.ibc_cnt:
        hdr = hdr_vals[info.hdr_pos]
        v, e = bch.TBL_HDR.correct(hdr)
        if e >= 0:
            o = info.ibc_off
            ok = ra_ok[o:o + info.ibc_cnt]
            if ok[0] and ok[1]:
                # extension groups also capped by stream len (42/group + 42
                # <= 256 allows 5; the offset cap of 4 is tighter)
                n_grp = 1
                while (2 * n_grp + 1 < len(ok) and ok[2 * n_grp]
                       and ok[2 * n_grp + 1]):
                    n_grp += 1
                d = ra_data[o:o + 2 * n_grp]
                stream = gf2.unpack_bits(d, frame_mod.BCH_RA_DATA).ravel()
                return "IBC", frame_mod._parse_ibc(stream, (v >> 4) & 0x7)

    # ---- IRA ----
    if info.ira_cnt:
        o = info.ira_off
        ok = ra_ok[o:o + info.ira_cnt]
        if ok[0] and ok[1] and ok[2]:
            n_blk = 3
            while n_blk + 2 <= info.ira_cnt and ok[n_blk] and ok[n_blk + 1]:
                n_blk += 2
            d = ra_data[o:o + n_blk]
            stream = gf2.unpack_bits(d, frame_mod.BCH_RA_DATA).ravel()
            return "IRA", frame_mod._parse_ira(stream)
    return None


def _walk_ida(f: dict, info: _Slices, lcw, da_vals, da_e, da_f):
    """descramble walk + field extraction (ida_decode.c:543-664) over the
    precomputed chunk results; mirrors ida.descramble_payload exactly."""
    max_bch = 512
    D = ida_mod.BCH_DA_DATA
    stream_parts = []
    n_vals = 0
    fixederrs = 0
    failed_early = False

    if info.da_cnt:
        o = info.da_off
        e = da_e[o:o + info.da_cnt]
        k_cap = min(info.da_cnt, max(0, (max_bch - D) // D + 1))
        fails = np.nonzero(e[:k_cap] < 0)[0]
        k_end = int(fails[0]) if len(fails) else k_cap
        failed_early = len(fails) > 0
        stream_parts.append(da_vals[o:o + k_end])
        n_vals += k_end
        fixederrs += int(da_f[o:o + k_end].sum())

    if not failed_early and info.tail_cnt:
        slen = D * n_vals
        remain = len(info.payload) % 124
        if remain >= 4 and slen + 2 * (remain // 2 - 1) <= max_bch \
                and slen + D <= max_bch:
            n_tc = min(info.tail_cnt, (max_bch - slen) // D)
            if n_tc > 0:
                o = info.tail_off
                e = da_e[o:o + n_tc]
                fails = np.nonzero(e < 0)[0]
                k_end = int(fails[0]) if len(fails) else n_tc
                stream_parts.append(da_vals[o:o + k_end])
                n_vals += k_end
                fixederrs += int(da_f[o:o + k_end].sum())

    if n_vals * D < 196:
        return None
    bs = gf2.unpack_bits(np.concatenate(stream_parts), D).ravel()
    return _ida_fields(f, bs, fixederrs, lcw)


def _ida_fields(frame: dict, bs: np.ndarray, fixederrs: int, lcw):
    """Field extraction + CRC splice (shared tail of ida.ida_decode)."""
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
        stream_bits = np.concatenate(
            [np.asarray(bs[:20], np.uint8), np.zeros(12, np.uint8),
             np.asarray(bs[20:len(bs) - 4], np.uint8)])
        computed = ida_mod.crc_ccitt(bytes(np.packbits(stream_bits)))
        crc_ok = computed == 0

    return ida_mod.IdaBurst(
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
        lcw_header=ida_mod.format_lcw_header(lcw.ft, lcw))
