"""GF(2) BCH syndrome decoding + LLR-guided Chase decoding.

Parity sources (reference file:line):
  - gf2 remainder:        frame_decode.c:82-91
  - syndrome tables:      frame_decode.c:95-135, ida_decode.c:64-102
  - Chase flip search:    frame_decode.c:224-295, ida_decode.c:107-173
    (partial selection sort of the 5 least-reliable positions, then
    masks 1..31 in order, first syndrome hit wins — the early-exit
    order is part of the behavior and is replicated exactly)

Polynomials (protocol facts):
  1207 = BCH(31,21) t=2 (IRA/IBC blocks), 29 = BCH(7,3) t=1 (IBC header,
  LCW1), 465 (LCW2), 41 (LCW3), 3545 = BCH(31,20) t=2 (IDA payload).
"""

from __future__ import annotations

import numpy as np

CHASE_FLIP_BITS = 5


def bits_to_uint(bits) -> int:
    val = 0
    for b in bits:
        val = (val << 1) | int(b)
    return val


def uint_to_bits(val: int, n: int) -> np.ndarray:
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)],
                    dtype=np.uint8)


def gf2_remainder(poly: int, val: int) -> int:
    if val == 0:
        return 0
    poly_bits = poly.bit_length()
    for i in range(31, poly_bits - 2, -1):
        if val & (1 << i):
            val ^= poly << (i - poly_bits + 1)
    return val


class SyndromeTable:
    """Error-locator lookup keyed by syndrome (reference build_syn)."""

    def __init__(self, poly: int, nbits: int, max_errors: int,
                 table_size: int):
        self.poly = poly
        self.size = table_size
        errs = np.full(table_size, -1, np.int32)
        loc = np.zeros(table_size, np.uint32)
        for b in range(nbits):
            r = gf2_remainder(poly, 1 << b)
            if r < table_size:
                errs[r] = 1
                loc[r] = 1 << b
        if max_errors >= 2:
            for b1 in range(nbits):
                for b2 in range(b1 + 1, nbits):
                    v = (1 << b1) | (1 << b2)
                    r = gf2_remainder(poly, v)
                    if r < table_size and errs[r] < 0:
                        errs[r] = 2
                        loc[r] = v
        self.errs = errs
        self.locator = loc

    def correct(self, val: int) -> tuple[int, int]:
        """-> (corrected val, n_errors) or (val, -1) if uncorrectable."""
        syn = gf2_remainder(self.poly, val)
        if syn == 0:
            return val, 0
        if syn < self.size and self.errs[syn] >= 0:
            return val ^ int(self.locator[syn]), int(self.errs[syn])
        return val, -1


# Tables built lazily at import of the decode package users
TBL_RA = SyndromeTable(1207, 31, 2, 1024)      # BCH(31,21)
TBL_HDR = SyndromeTable(29, 7, 1, 16)          # BCH(7,3)
TBL_DA = SyndromeTable(3545, 31, 2, 2048)      # BCH(31,20)
TBL_LCW1 = SyndromeTable(29, 7, 1, 16)
TBL_LCW2 = SyndromeTable(465, 14, 1, 256)
TBL_LCW3 = SyndromeTable(41, 26, 2, 32)


def _chase_positions(llr31) -> list[int]:
    """The 5 least-reliable positions by the reference's partial selection
    sort (frame_decode.c:250-263) — tie-breaking replicated exactly."""
    pos = list(range(31))
    llr = [float(x) for x in llr31]
    for i in range(CHASE_FLIP_BITS):
        m = i
        for j in range(i + 1, 31):
            if llr[pos[j]] < llr[pos[m]]:
                m = j
        pos[i], pos[m] = pos[m], pos[i]
    return pos[:CHASE_FLIP_BITS]


def chase_decode(block31, llr31, table: SyndromeTable,
                 syn_bits: int, data_bits: int):
    """Chase BCH decode of a 31-bit block.

    Returns (data_bits_array, check_bits_array, n_errs, fixed) with
    n_errs == -1 on failure. `fixed` is 1 iff any correction (hard BCH
    or Chase) was applied (ida_decode.c chase_bch_da semantics).
    """
    val = bits_to_uint(block31)
    v, e = table.correct(val)
    if e >= 0:
        return (uint_to_bits(v >> syn_bits, data_bits),
                uint_to_bits(v & ((1 << syn_bits) - 1), syn_bits),
                e, 1 if v != val or e > 0 else 0)

    if llr31 is None:
        return None, None, -1, 0

    flips = [1 << (30 - p) for p in _chase_positions(llr31)]
    for mask in range(1, 1 << CHASE_FLIP_BITS):
        flipped = val
        for b in range(CHASE_FLIP_BITS):
            if mask & (1 << b):
                flipped ^= flips[b]
        v, e = table.correct(flipped)
        if e >= 0:
            return (uint_to_bits(v >> syn_bits, data_bits),
                    uint_to_bits(v & ((1 << syn_bits) - 1), syn_bits),
                    e, 1)
    return None, None, -1, 0
