"""Vectorized GF(2) decode primitives: batched syndrome/Chase BCH over
numpy uint32 codewords.

The scalar layer (`bch.py`) iterates Python ints bit-by-bit — fine for
hundreds of frames/s, a serial bottleneck at the device pipeline's target
rates (tens of thousands of frames/s with `--parsed`). This module is the
dense restatement SURVEY §7.5 prescribes: GF(2) remainders become 4 byte-
table lookups (the remainder map is linear over GF(2)), the Chase flip
search becomes a (31, N) candidate matrix with argmax-over-candidates
replicating the reference's first-syndrome-hit-wins order
(frame_decode.c:224-295, ida_decode.c:107-173).

Behavioral parity notes:
  - The 5 least-reliable positions come from a partial selection sort
    whose swaps change later scan order on ties (frame_decode.c:250-263);
    `chase_positions` replicates the swaps exactly, batched.
  - Flip masks are tried in mask order 1..31 and the first correctable
    candidate wins; `argmax` over the candidate axis returns the first
    True, which is the same order.
"""

from __future__ import annotations

import numpy as np

CHASE_FLIP_BITS = 5

_POW2_DESC = {}  # n -> (1 << [n-1 .. 0]) as uint32


def _pow2_desc(n: int) -> np.ndarray:
    w = _POW2_DESC.get(n)
    if w is None:
        w = (np.uint32(1) << np.arange(n - 1, -1, -1, dtype=np.uint32))
        _POW2_DESC[n] = w
    return w


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(..., n) {0,1} -> (...,) uint32, MSB first (bch.bits_to_uint)."""
    bits = np.asarray(bits, np.uint32)
    return bits @ _pow2_desc(bits.shape[-1])


def unpack_bits(vals: np.ndarray, n: int) -> np.ndarray:
    """(...,) uint32 -> (..., n) uint8, MSB first (bch.uint_to_bits)."""
    vals = np.asarray(vals, np.uint32)
    return ((vals[..., None] >> np.arange(n - 1, -1, -1, dtype=np.uint32))
            & 1).astype(np.uint8)


def _gf2_remainder(poly: int, val: int) -> int:
    if val == 0:
        return 0
    pb = poly.bit_length()
    for i in range(31, pb - 2, -1):
        if val & (1 << i):
            val ^= poly << (i - pb + 1)
    return val


class VecSyndromeTable:
    """Vectorized analogue of bch.SyndromeTable: same polynomial, same
    error-locator construction (frame_decode.c:95-135), plus byte-sliced
    syndrome tables exploiting GF(2) linearity:
    syn(v) = syn(b0) ^ syn(b1<<8) ^ syn(b2<<16) ^ syn(b3<<24)."""

    def __init__(self, poly: int, nbits: int, max_errors: int,
                 table_size: int):
        self.poly = poly
        self.size = table_size
        errs = np.full(table_size, -1, np.int32)
        loc = np.zeros(table_size, np.uint32)
        for b in range(nbits):
            r = _gf2_remainder(poly, 1 << b)
            if r < table_size:
                errs[r] = 1
                loc[r] = 1 << b
        if max_errors >= 2:
            for b1 in range(nbits):
                for b2 in range(b1 + 1, nbits):
                    v = (1 << b1) | (1 << b2)
                    r = _gf2_remainder(poly, v)
                    if r < table_size and errs[r] < 0:
                        errs[r] = 2
                        loc[r] = v
        self.errs = errs
        self.locator = loc
        # byte-sliced syndrome tables (4 x 256)
        self.syn_b = np.empty((4, 256), np.uint32)
        for k in range(4):
            for byte in range(256):
                self.syn_b[k, byte] = _gf2_remainder(poly, byte << (8 * k))

    def syndrome(self, vals: np.ndarray) -> np.ndarray:
        v = np.asarray(vals, np.uint32)
        return (self.syn_b[0, v & 0xFF]
                ^ self.syn_b[1, (v >> 8) & 0xFF]
                ^ self.syn_b[2, (v >> 16) & 0xFF]
                ^ self.syn_b[3, v >> 24])

    def correct(self, vals: np.ndarray):
        """-> (corrected vals, n_errors) with n_errors = -1 where
        uncorrectable. Vectorized SyndromeTable.correct."""
        vals = np.asarray(vals, np.uint32)
        syn = self.syndrome(vals)
        idx = np.minimum(syn, self.size - 1)
        in_table = syn < self.size
        e = np.where(in_table, self.errs[idx], -1).astype(np.int32)
        e = np.where(syn == 0, 0, e)
        fix = np.where(in_table & (syn != 0), self.locator[idx],
                       np.uint32(0))
        return vals ^ fix, e

    def chase(self, vals: np.ndarray, llrs: np.ndarray | None):
        """Batched Chase decode of N 31-bit codewords.

        vals: (N,) uint32; llrs: (N, 31) float or None.
        -> (corrected (N,) uint32, n_errs (N,) i32 with -1 = failure,
            fixed (N,) i32: 1 iff any correction applied).
        """
        vals = np.asarray(vals, np.uint32)
        v, e = self.correct(vals)
        fixed = ((v != vals) | (e > 0)).astype(np.int32) * (e >= 0)
        if llrs is None:
            return v, e, fixed
        need = e < 0
        if not need.any():
            return v, e, fixed
        sub = vals[need]
        pos = chase_positions(np.asarray(llrs, np.float32)[need])  # (M, 5)
        flips = (np.uint32(1) << (30 - pos).astype(np.uint32))      # (M, 5)
        combo = (((np.arange(1, 32, dtype=np.uint32)[:, None]
                   >> np.arange(CHASE_FLIP_BITS, dtype=np.uint32)[None, :])
                  & 1).astype(np.uint32))                           # (31, 5)
        # distinct single-bit masks: XOR of a subset == sum of the subset
        cand_flip = combo @ flips.T.astype(np.uint32)               # (31, M)
        cands = sub[None, :] ^ cand_flip
        cv, ce = self.correct(cands.ravel())
        cv = cv.reshape(31, -1)
        ok = (ce >= 0).reshape(31, -1)
        first = np.argmax(ok, axis=0)                 # first hit in mask order
        hit = ok.any(axis=0)
        m = np.arange(cv.shape[1])
        v_sub = np.where(hit, cv[first, m], sub)
        e_sub = np.where(hit, ce.reshape(31, -1)[first, m], -1).astype(np.int32)
        v = v.copy()
        e = e.copy()
        fixed = fixed.copy()
        v[need] = v_sub
        e[need] = e_sub
        fixed[need] = hit.astype(np.int32)
        return v, e, fixed


def chase_positions(llrs: np.ndarray) -> np.ndarray:
    """(N, 31) LLR magnitudes -> (N, 5) least-reliable bit positions via
    the reference's partial selection sort, batched (the swap at each round
    changes later scan order on ties, so a stable argsort is NOT
    equivalent; frame_decode.c:250-263)."""
    llrs = np.asarray(llrs, np.float32)
    N = llrs.shape[0]
    pos = np.tile(np.arange(31, dtype=np.int32), (N, 1))
    rows = np.arange(N)
    for i in range(CHASE_FLIP_BITS):
        vals = np.take_along_axis(llrs, pos[:, i:], axis=1)
        m = np.argmin(vals, axis=1) + i          # first minimum, like the C scan
        tmp = pos[rows, i].copy()
        pos[rows, i] = pos[rows, m]
        pos[rows, m] = tmp
    return pos[:, :CHASE_FLIP_BITS]


# Vectorized twins of the bch.py tables (same polynomials/sizes)
TBL_RA = VecSyndromeTable(1207, 31, 2, 1024)      # BCH(31,21)
TBL_HDR = VecSyndromeTable(29, 7, 1, 16)          # BCH(7,3)
TBL_DA = VecSyndromeTable(3545, 31, 2, 2048)      # BCH(31,20)
TBL_LCW1 = VecSyndromeTable(29, 7, 1, 16)
TBL_LCW2 = VecSyndromeTable(465, 14, 1, 256)
TBL_LCW3 = VecSyndromeTable(41, 26, 2, 32)


# ---- de-interleave index permutations (applied as one numpy gather) ----

def _build_deint2(n_sym: int) -> tuple[np.ndarray, np.ndarray]:
    i1 = [(2 * s + d) for s in range(n_sym - 1, 0, -2) for d in (0, 1)]
    i2 = [(2 * s + d) for s in range(n_sym - 2, -1, -2) for d in (0, 1)]
    return np.array(i1, np.int32), np.array(i2, np.int32)


_DEINT2 = {}


def deint2_idx(n_sym: int) -> tuple[np.ndarray, np.ndarray]:
    """Index arrays for the 2-way de-interleave of 2*n_sym values
    (frame_decode.c:156-176 / ida_decode.c:259-272)."""
    r = _DEINT2.get(n_sym)
    if r is None:
        r = _build_deint2(n_sym)
        _DEINT2[n_sym] = r
    return r


DEINT3_IDX = np.array(
    [(2 * s + d) for start in (47, 46, 45)
     for s in range(start, -1, -3) for d in (0, 1)], np.int32
).reshape(3, -1)   # (3, 32) — frame_decode.c:178-199


_POPCNT_OK = hasattr(np, "bitwise_count")


def popcount32(vals: np.ndarray) -> np.ndarray:
    v = np.asarray(vals, np.uint32)
    if _POPCNT_OK:
        return np.bitwise_count(v).astype(np.int32)
    c = v - ((v >> 1) & 0x55555555)
    c = (c & 0x33333333) + ((c >> 2) & 0x33333333)
    return ((((c + (c >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24).astype(np.int32)
