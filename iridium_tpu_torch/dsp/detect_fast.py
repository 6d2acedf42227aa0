"""Branchless chunked burst detector with per-bin state: the port of
iridium_tpu/dsp/detect_fast.py (the JAX package's XLA scan).

The pipeline runs it for the detector shapes the scan kernel
(csrc/detect_scan.cu) refuses, such as blocks of 2^31 samples or more
(1.6 GHz at its default 1,024 frames, `detect_scan.resolve_impl`), or
where it is asked for (`detect_impl="fast"`); the sharded pipeline's
bin-split mode runs it sharded, as the JAX package's does.

`make_scan_fast` builds the scan. On a CUDA state it launches the
hand-written kernel (csrc/detect_fast.cu, in the layout `plan` gives):
with one bin range (no `coupling_sum`) one launch a block
(`scan_fast_kernel`); with a `coupling_sum` (binshard: the per-frame pair
summed over the ranks by `all_reduce`) two launches a frame cut at the
coupling seam, the pair summed between them (`scan_fast_split`). On a CPU
state it runs `scan_fast_plain`, the same state machine as tensor ops,
frame by frame, which the tests hold to the JAX function row for row and
the card holds both forms of the kernel to bit for bit. No path runs the
twin on the card.

`scan_fast_plain` keeps the JAX function's structure, since its results
depend on it:
  - the frames go in chunks of CHUNK (at most H / 2 and at most 32, a
    divisor of frames_per_block): a chunk reads the 2 * CHUNK history rows
    its noise updates can evict when it starts and writes the rows it
    updated when it ends (at most two updates a frame, so a chunk never
    evicts a row it wrote; the kernel's live ring gives the same rows);
  - creation candidates are the K_TOP = 2 * K_CREATE largest segment
    maxima of the masked relative magnitude (segments of up to 16 bins, no
    wider than half the burst width), walked greedily: a candidate within
    half the burst width of an accepted one is skipped. The scan kernel's
    greedy argmax walk can place same-frame secondary creations on other
    bins (detect_pallas.py:27-35);
  - the documented capacity divergences from the reference
    (detect_fast.py:32-45): at most K_CREATE = 4 creations a frame (a
    one-time note on stderr when max_new_per_frame asks for more; the
    excess peaks create on later frames, counted in `create_waits`), at
    most E_DEL deletion and E_SQ squelch emissions a frame (the excess is
    counted in n_tagged and `burst_dropped` but not emitted; the mask is
    released for every deleted burst), and the stale history row after two
    noise resets in one chunk.

Both keep the JAX function's local bin range (`n_bins`, `bin_lo`,
`own_lo`, `own_hi`: bursts centred outside [own_lo, own_hi) are tracked
but not emitted) and its one per-frame coupling sum, the [any long-burst
deletion, active count] pair that the JAX package sums over shards with
`psum` (:369-383). Here `coupling_sum` is that hook and defaults to the
identity.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..config import DetectorParams
from . import detect_scan
from . import state as state_mod
from .state import E_DEL, E_SQ, GONE_FIELDS, PLANE_FIELDS, ScanState
from .state import init_state  # noqa: F401  (this module's state)

E_TOT = E_DEL + E_SQ

_warned_clamp = False


def _warn_clamp_once(configured: int, used: int) -> None:
    """The one-time note that the creation budget is clamped
    (detect_fast.py:84-95)."""
    global _warned_clamp
    if not _warned_clamp:
        _warned_clamp = True
        print(f"detect_fast: clamping burst creations to {used}/frame "
              f"(max_new_per_frame={configured}); excess peaks create "
              "on later frames", file=sys.stderr)


def chunk_frames(p: DetectorParams) -> int:
    """Frames a chunk (detect_fast.py:196-204): at most two noise updates
    a frame, and a chunk must not evict a row it wrote, so at most H / 2."""
    chunk = max(min(32, p.history_size // 2), 1)
    while p.frames_per_block % chunk:
        chunk //= 2
    return chunk


def _window_sums(x: torch.Tensor, hb: int) -> torch.Tensor:
    """out[i] = sum of x[max(i - hb, 0) : min(i + hb, n - 1) + 1] (int32):
    the mask coverage that bursts centred at the bins of x add, clipped at
    the edges (burst_detect.c:473-486)."""
    n = x.shape[0]
    cs = torch.cumsum(torch.nn.functional.pad(x, (hb + 1, hb)), 0,
                      dtype=torch.int32)
    return cs[2 * hb + 1:] - cs[:n]


def _segments(hb: int, FL: int) -> tuple[int, int]:
    """(SEG, NS): the candidate pool's segments (detect_fast.py:214-241),
    the largest power of two up to min(half_bw, 16) that divides FL, and
    their number; under 4 bins every bin is its own segment (NS = FL)."""
    SEG = 1
    while SEG * 2 <= min(max(hb, 1), 16) and FL % (SEG * 2) == 0:
        SEG *= 2
    return SEG, (FL // SEG if SEG >= 4 else FL)


def scan_fast_plain(mag2: torch.Tensor, state: ScanState, n_valid: int,
                    p: DetectorParams, n_bins: int | None = None,
                    coupling_sum=None, id_stride: int = 1, bin_lo=0,
                    own_lo=0, own_hi=None) -> ScanState:
    """The new ScanState after the block of fftshifted |X|^2 rows `mag2`
    (frames_per_block, n_bins) f32, as tensor ops on mag2's device, frame
    by frame (the kernel's plain twin); the input state is left as it
    was. `coupling_sum` maps the frame's (2,) int64 [any long-burst
    deletion, owned active count] to its sum over every bin range
    (identity: this range is all of them)."""
    F = p.fft_size
    FL = n_bins if n_bins is not None else F
    G, H = p.gone_capacity, p.history_size
    hb = p.burst_width_bins // 2
    c = detect_scan._consts(p)
    thr = float(c["threshold"])
    hist_f, enbw = float(c["hist_f"]), float(c["enbw"])
    f2, bin_width = float(c["f2"]), float(c["bin_width"])
    K_CREATE = c["k_create"]
    K_TOP = 2 * K_CREATE
    n_frames = p.frames_per_block
    CHUNK = chunk_frames(p)
    C2 = 2 * CHUNK
    if G > n_frames * E_TOT:
        raise ValueError(f"gone_capacity {G} above the {n_frames * E_TOT} "
                         "emissions a block can make")
    # segment maxima as the candidate pool
    SEG, NS = _segments(hb, FL)
    gsum = coupling_sum or (lambda x: x)
    # earlier[j, k]: candidate k comes before candidate j
    earlier = np.tril(np.ones((K_TOP, K_TOP), bool), -1)
    dc = F // 2

    own_hi = F if own_hi is None else own_hi
    dev = mag2.device
    i32, i64 = torch.int32, torch.int64
    iota = torch.arange(FL, device=dev)
    gbins = bin_lo + iota
    # edge and DC-notch exclusion and ownership, in global bins
    eligible = ((gbins >= hb) & (gbins < F - hb)
                & ~((gbins >= dc - 3) & (gbins <= dc + 3))).float()
    owned = (gbins >= own_lo) & (gbins < own_hi)
    gbin_i = gbins.to(i32)
    ones_i = torch.ones(FL, dtype=i32, device=dev)
    zero_f = torch.zeros((), device=dev)
    pool_rev = NS - 1 - torch.arange(NS, device=dev)
    tri = torch.from_numpy(earlier).to(dev)
    ar2 = torch.arange(C2, device=dev)
    del_rows = torch.arange(1, E_DEL + 1, dtype=i32, device=dev)
    sq_rows = torch.arange(1, E_SQ + 1, dtype=i32, device=dev)

    s = state.clone()
    hist = s.baseline_hist
    bsum = s.baseline_sum
    a_valid, a_id, a_start, a_last = s.a_valid, s.a_id, s.a_start, s.a_last
    a_mag, a_noise, mask = s.a_mag, s.a_noise, s.mask_count
    sc = s.ints.to(i64)
    hidx, prim, burst_id, sq_count = sc[0], sc[1], sc[2], sc[3]
    n_tagged, dropped, waits = sc[4], sc[5], sc[6]
    peak = s.floats[0]
    ems = torch.zeros((n_frames, E_TOT, 8), dtype=i32, device=dev)

    def top_pool(relm):
        """(values, bins) of the K_TOP largest segment maxima, in
        descending order, the lower bin first among equal values (as
        lax.top_k): the keys are unique, so any top-k gives them."""
        if SEG >= 4:
            segmax, segarg = relm.view(NS, SEG).max(1)
        else:
            segmax, segarg = relm, None
        # relm >= +0.0, so its bits order as its values
        key = (segmax.view(i32).to(i64) << 32) | pool_rev
        si = torch.topk(key, K_TOP).indices
        if segarg is None:
            return segmax[si], si
        return segmax[si], si * SEG + segarg[si]

    n_act_frames = active_frames(p, n_valid)
    for c0 in range(0, n_act_frames, CHUNK):
        pos = (hidx + ar2) % H
        pre = hist[pos]
        upd_k = torch.zeros((), dtype=i64, device=dev)
        k0s, d0s, k1s, d1s = [], [], [], []
        for f in range(c0, min(c0 + CHUNK, n_act_frames)):
            idx = f * F
            mag = mag2[f]
            primed = prim >= H
            ev = pre.index_select(0, torch.stack([upd_k, upd_k + 1]))
            evict_a, evict_b = ev[0], ev[1]
            rel = torch.where(bsum > 0, mag / bsum, zero_f)

            # extend last_active (burst_detect.c:458-469)
            th = rel > thr
            dil = th.clone()
            dil[:-1] |= th[1:]
            dil[1:] |= th[:-1]
            a_last = torch.where(a_valid & dil & primed, idx, a_last)

            # peaks under the carried mask
            relm = rel * (mask == 0) * eligible
            relm = torch.where(relm > thr, relm, zero_f)

            # gone bursts (burst_detect.c:490-518)
            long_b = a_valid & ((a_last - a_start) > p.max_burst_len)
            gone = a_valid & (((a_last + p.burst_post_len) <= idx)
                              | long_b)
            flags = gone & primed
            any_long = long_b.any().to(i64)
            emit = flags & owned
            vals8 = torch.stack(
                [a_id, a_start, torch.full_like(a_id, idx), a_last,
                 gbin_i, a_mag.view(i32), a_noise.view(i32), ones_i], 1)
            a_valid = a_valid & ~flags

            # creation (burst_detect.c:556-632): the descending
            # candidates, each skipped within half_bw of an accepted one
            topv, topi = top_pool(relm)
            above = primed & (topv > thr)
            near = ((topi[:, None] - topi[None, :]).abs() <= hb) & tri
            acc = torch.zeros(K_TOP, dtype=torch.bool, device=dev)
            for j in range(K_TOP):
                acc[j] = above[j] & ~(acc & near[j]).any()
            acc_i = acc.to(i64)
            rank = torch.cumsum(acc_i, 0) - acc_i
            take = acc & (rank < K_CREATE)
            n_acc = take.sum()
            ids_k = burst_id + 10 * id_stride * rank
            at_any = torch.zeros(FL, dtype=torch.bool,
                                 device=dev).scatter(0, topi, take)

            # the per-frame coupling: [any long-burst deletion (forced
            # noise update, :516), post-creation active count]
            n_own_post = ((a_valid | at_any) & owned).sum()
            cpl = gsum(torch.stack([any_long, n_own_post]))
            force = (cpl[0] > 0) & primed
            n_active = cpl[1]

            # the created bursts' noise reads see the forced update at
            # their bin, in the same float order
            base_at, mag_at, ev_at = bsum[topi], mag[topi], evict_a[topi]
            old_at = ev_at * (prim >= H)
            base_eff = torch.where(force, (base_at - old_at) + mag_at,
                                   base_at)
            mag_db = 10.0 * torch.log10(
                torch.clamp(topv * hist_f * enbw, min=1e-30))
            noise_db = 10.0 * torch.log10(torch.clamp(
                base_eff / hist_f / f2 / enbw / bin_width, min=1e-30))

            # forced noise update (long-burst deletion)
            did0, k0 = force, upd_k
            old = evict_a * (prim >= H)
            bsum = torch.where(force, (bsum - old) + mag, bsum)
            prim = torch.clamp(prim + force.to(i64), max=H)
            upd_k = upd_k + force.to(i64)

            start = idx - p.burst_pre_len
            a_valid = a_valid | at_any
            a_id = a_id.scatter(0, topi, torch.where(
                take, ids_k.to(i32), a_id[topi]))
            a_start = torch.where(at_any, start, a_start)
            a_last = torch.where(at_any, start, a_last)
            a_mag = a_mag.scatter(0, topi, torch.where(
                take, mag_db, a_mag[topi]))
            a_noise = a_noise.scatter(0, topi, torch.where(
                take, noise_db, a_noise[topi]))
            # one mask update: add the creations, release the deletions
            mask = mask + _window_sums(at_any.to(i32) - flags.to(i32), hb)
            burst_id = burst_id + 10 * id_stride * n_acc
            peak = torch.maximum(peak, torch.where(
                take, mag_db, float("-inf")).max())
            more = (n_acc == K_CREATE) & (acc & (rank >= K_CREATE)).any()
            waits = waits + more.to(i64)

            # squelch (burst_detect.c:594-631) on the coupled count
            if p.max_bursts > 0:
                squelch = primed & (n_active > p.max_bursts)
            else:
                squelch = torch.zeros((), dtype=torch.bool, device=dev)
            sq_flags = squelch & a_valid & ~at_any

            # the frame's emissions: deletion rows first (ascending
            # bin), then squelch rows, each set ranked by one cumsum
            fi_d = emit.to(i32)
            fi_s = (sq_flags & owned).to(i32)
            cs = torch.cumsum(fi_d + (fi_s << 16), 0, dtype=i32)
            cs_d, cs_s = cs & 0xFFFF, cs >> 16
            n_del, n_sq = cs_d[-1].to(i64), cs_s[-1].to(i64)
            rows = torch.cat([torch.searchsorted(cs_d, del_rows),
                              torch.searchsorted(cs_s, sq_rows)])
            ems[f] = torch.where((rows < FL)[:, None],
                                 vals8[rows.clamp(max=FL - 1)], 0)
            n_tagged = n_tagged + n_del + n_sq
            dropped = (dropped + torch.clamp(n_del - E_DEL, min=0)
                       + torch.clamp(n_sq - E_SQ, min=0))

            a_valid = a_valid & ~squelch
            mask = torch.where(squelch, 0, mask)
            sq_count = torch.where(squelch, sq_count + 3,
                                   torch.clamp(sq_count - 1, min=0))
            # noise-estimate reset after repeated squelch; the history
            # slots continue
            reset = sq_count >= 10
            bsum = torch.where(reset, zero_f, bsum)
            prim = torch.where(reset, 0, prim)
            sq_count = torch.where(reset, 0, sq_count)

            # final noise update when no burst is active (:698)
            evict2 = torch.where(did0, evict_b, evict_a)
            k1 = upd_k
            do1 = torch.where(squelch, 0, n_active) == 0
            old = evict2 * (prim >= H)
            bsum = torch.where(do1, (bsum - old) + mag, bsum)
            prim = torch.clamp(prim + do1.to(i64), max=H)
            upd_k = upd_k + do1.to(i64)
            k0s.append(k0)
            d0s.append(did0)
            k1s.append(k1)
            d1s.append(do1)

        # the chunk's written rows: update k stores the |X|^2 row of the
        # frame that made it; the rest keep what was read
        nf = len(k0s)
        frame_of = torch.full((C2 + 1,), c0, dtype=i64, device=dev)
        local = torch.arange(c0, c0 + nf, device=dev)
        frame_of.scatter_(0, torch.where(torch.stack(d0s),
                                         torch.stack(k0s), C2), local)
        frame_of.scatter_(0, torch.where(torch.stack(d1s),
                                         torch.stack(k1s), C2), local)
        hist[pos] = torch.where((ar2 < upd_k)[:, None],
                                mag2[frame_of[:C2]], pre)
        hidx = (hidx + upd_k) % H

    # the gone table: the emission rows in frame order, first G kept
    em = ems.reshape(-1, 8)
    cs = torch.cumsum((em[:, 7] > 0).to(i32), 0, dtype=i32)
    src = torch.searchsorted(
        cs, torch.arange(1, G + 1, dtype=i32, device=dev))
    table = torch.where((src < em.shape[0])[:, None],
                        em[src.clamp(max=em.shape[0] - 1)], 0)
    # the row's columns are the gone fields, in order, then the flag
    for k, name in enumerate(GONE_FIELDS):
        col = table[:, k]
        if name in ("g_mag", "g_noise"):
            col = col.view(torch.float32)
        getattr(s, name).copy_(col)
    s.baseline_sum, s.a_valid, s.a_id = bsum, a_valid, a_id
    s.a_start, s.a_last, s.a_mag, s.a_noise = (a_start, a_last, a_mag,
                                               a_noise)
    s.mask_count = mask
    s.ints = torch.stack([hidx, prim, burst_id, sq_count, n_tagged,
                          dropped, waits,
                          torch.clamp(cs[-1].to(i64), max=G)]).to(i32)
    s.floats = peak.reshape(1)
    return s


# The kernel's layout (csrc/detect_fast.cu). Block b owns the local bins
# [b FB, (b + 1) FB) (FB = T BPT bins, T <= MAX_THREADS threads of BPT
# contiguous bins), so bin k's deletion flag is a bit of flag word
# k // BPT. Up to RING_BINS bins one block, whose barrier is
# __syncthreads; up to MAX_CLUSTER RING_BINS one cluster of the least
# power of two of blocks of at most RING_BINS bins, 8 a thread, and up to
# MAX_CLUSTER WIDE_BINS one cluster of 16 blocks of 16 a thread (the wide
# path): a cluster's blocks meet through distributed shared memory after
# a cluster barrier. Above, a grid of clusters that meet in device memory
# between clusters, which needs every cluster resident at once: up to
# MAX_GRID clusters of 16 blocks of 8 bins a thread, then of 16, then
# clusters of 2 wide blocks (one an SM, MAX_PAIRS of them: every SM of an
# H100 SXM), then of 2 deep blocks of DEEP_BINS, 32 a thread (their rows
# read from device memory, not staged: 3.2 GHz), up to MAX_BINS. The
# blocks of a grid share its bins evenly, T rounded up to whole warps, so
# its last blocks may hold none. The packing asks the card how many
# clusters it places and refuses a grid of more before anything runs.
RING_BINS = 8192
WIDE_BINS = 16384
DEEP_BINS = 32768
MAX_THREADS = 1024
MAX_CLUSTER = 16
MAX_GRID = 7
MAX_PAIRS = 66
MAX_BINS = 2 * MAX_PAIRS * DEEP_BINS
# scratch (32-bit words): two arrival counters, a line each; a grid's
# slots, two parities of one `Frame` a cluster (8 candidate keys of 64
# bits, 4 counts); the flag words, two parities of one a thread; the
# split's after them: the frame's pair (2 int64, at an even word), the
# scalars in two slots (`Scalars`: 8 ints, the peak, a pad word), the
# frame's `Seam` (the taken candidates' 4 bins and values, 8 counts), and
# each thread's first emission rank
LINE_WORDS = 32
FRAME_WORDS = 2 * 8 + 4
PAIR_WORDS = 4
SCALAR_WORDS = 10
SEAM_WORDS = 16


class Plan(NamedTuple):
    blocks: int        # thread blocks of the launch
    block_bins: int    # bins a block: threads x bpt
    threads: int       # T, whole warps
    bpt: int           # bins a thread, a power of two
    clusters: int      # blocks a cluster (1: one block)
    seg: int           # the twin's SEG (`_segments`)
    ns: int            # the twin's NS; FL // ns bins a kernel segment
    scratch_words: int  # the one launch's; the split's pair starts there
    grid: bool         # a grid of clusters (else one block or cluster)
    split_words: int   # the split's scratch


def scratch_words(blocks: int, clusters: int, threads: int) -> tuple:
    """(one launch's, the split's) scratch words of a layout."""
    n = blocks // clusters
    one = (2 * LINE_WORDS + (2 * n * FRAME_WORDS if n > 1 else 0)
           + 2 * blocks * threads)
    return one, (one + PAIR_WORDS + 2 * SCALAR_WORDS + SEAM_WORDS
                 + blocks * threads)


def plan(p: DetectorParams, n_bins: int | None = None) -> Plan:
    """The kernel's launch over n_bins local bins (all fft_size bins by
    default): the one place its layout is decided (the C entry checks it
    and refuses any other). Raises ValueError on what the kernel does not
    take: more than MAX_BINS bins; a history under 2 rows (a chunk's
    evictions would reach a row the chunk wrote, where the twin reads the
    row from before the chunk and the kernel's live ring the new one);
    frame positions past int32; a gone table larger than the emission caps
    fill; fewer segments than candidates (the twin's top-k raises)."""
    F = p.fft_size
    FL = n_bins if n_bins is not None else F
    SEG, NS = _segments(p.burst_width_bins // 2, FL)
    k_top = 2 * detect_scan._consts(p)["k_create"]
    if FL <= 0 or FL > MAX_BINS:
        raise ValueError(f"detect_fast kernel: {FL} bins, it takes 1 to "
                         f"{MAX_BINS}")
    if p.history_size < 2:
        raise ValueError("detect_fast kernel: a history of 2 rows or more")
    if (p.frames_per_block - 1) * F > 2**31 - 1:
        raise ValueError("detect_fast kernel: frame positions past int32")
    _check_gone(p)
    if NS < k_top:
        raise ValueError(f"detect_fast kernel: {NS} segments, fewer than "
                         f"the {k_top} candidates")
    C, N = 1, 1
    if FL <= RING_BINS:
        bpt = 1
        while bpt * MAX_THREADS < FL:
            bpt *= 2
    elif FL <= MAX_CLUSTER * RING_BINS:
        C, bpt = 2, 8
        while C * RING_BINS < FL:
            C *= 2
    elif FL <= MAX_CLUSTER * WIDE_BINS:
        C, bpt = MAX_CLUSTER, 16
    elif FL <= MAX_GRID * MAX_CLUSTER * RING_BINS:
        C, bpt = MAX_CLUSTER, 8
        N = -(-FL // (C * RING_BINS))
    elif FL <= MAX_GRID * MAX_CLUSTER * WIDE_BINS:
        C, bpt = MAX_CLUSTER, 16
        N = -(-FL // (C * WIDE_BINS))
    elif FL <= 2 * MAX_PAIRS * WIDE_BINS:
        C, bpt = 2, 16
        N = -(-FL // (C * WIDE_BINS))
    else:
        C, bpt = 2, 32
        N = -(-FL // (C * DEEP_BINS))
    blocks = N * C
    T = -(-FL // (blocks * bpt))
    T = -(-T // 32) * 32
    one, split = scratch_words(blocks, C, T)
    return Plan(blocks, T * bpt, T, bpt, C, SEG, NS, one, N > 1, split)


def _check_gone(p: DetectorParams) -> None:
    if p.gone_capacity > p.frames_per_block * E_TOT:
        raise ValueError(f"gone_capacity {p.gone_capacity} above the "
                         f"{p.frames_per_block * E_TOT} emissions a block "
                         "can make")


def active_frames(p: DetectorParams, n_valid: int) -> int:
    """The frames of the block that n_valid samples fill (the twin's)."""
    F = p.fft_size
    return min(max((int(n_valid) - F) // F + 1, 0), p.frames_per_block)


# the kernel's launches (its C entry `detect_fast`): the whole block, or
# the split's launch A or B of a frame
MODE_WHOLE, MODE_A, MODE_B = 0, 1, 2
# a block's arguments as `detect_fast_args` packs them
PACKED_BYTES = 512


class _Launch:
    """The kernel's arguments for one block, packed once by the C side
    (which checks them): the |X|^2 rows `mag2`, the state `out` that the
    kernel updates in place (its gone table zeroed), the scratch (zeroed;
    the one launch's, or with `split` the split's); raises on a shape
    `plan` refuses and on tensors the kernel does not take. Without `out`
    and `scratch` they are made: the input state's clone and a zeroed
    scratch."""

    def __init__(self, mag2, state, n_valid, p, n_bins, id_stride, bin_lo,
                 own_lo, own_hi, split: bool, out=None, scratch=None):
        F, H, G = p.fft_size, p.history_size, p.gone_capacity
        FL = n_bins if n_bins is not None else F
        own_hi = F if own_hi is None else own_hi
        lay = self.lay = plan(p, FL)
        dev = self.dev = mag2.device
        _kernels.check(mag2, "mag2", torch.float32, dev,
                       (p.frames_per_block, FL))
        self.mag2 = mag2  # its pointer is in the arguments
        if out is None:
            out = state.clone()
            for name in GONE_FIELDS:
                getattr(out, name).zero_()
        self.out = out
        state_mod.check(out, p, dev, FL)
        words = lay.split_words if split else lay.scratch_words
        if scratch is None:
            scratch = torch.zeros(words, dtype=torch.int32, device=dev)
        self.scratch = scratch
        self.n_act = active_frames(p, n_valid)
        c = detect_scan._consts(p)
        k = _kernels
        self.packed = ctypes.create_string_buffer(PACKED_BYTES)
        k.DETECT_FAST.call(
            "detect_fast_args", k.ptr(mag2),
            *[k.ptr(getattr(out, name)) for name in PLANE_FIELDS],
            *[k.ptr(getattr(out, name)) for name in GONE_FIELDS],
            k.ptr(out.ints), k.ptr(out.floats), k.ptr(scratch),
            F, FL, self.n_act, H, G, p.burst_width_bins // 2,
            c["k_create"], int(p.max_bursts), int(p.max_burst_len),
            int(p.burst_post_len), int(p.burst_pre_len), int(id_stride),
            int(bin_lo), int(own_lo), int(own_hi),
            float(c["threshold"]), float(c["hist_f"]), float(c["enbw"]),
            float(c["f2"]), float(c["bin_width"]),
            lay.blocks, lay.clusters, lay.block_bins, lay.threads, lay.bpt,
            FL // lay.ns, words, int(split), self.packed, PACKED_BYTES)
        w = lay.scratch_words
        # the split's pair, in the scratch
        self.pair = scratch[w:w + PAIR_WORDS].view(torch.int64)

    def step(self, mode: int, frame: int = 0) -> None:
        """The one launch over every active frame (MODE_WHOLE), or the
        split's launch A or B of `frame`."""
        _kernels.DETECT_FAST.launch(self.dev, self.packed, mode, frame)


def scan_fast_kernel(mag2: torch.Tensor, state: ScanState, n_valid: int,
                     p: DetectorParams, n_bins: int | None = None,
                     id_stride: int = 1, bin_lo=0, own_lo=0,
                     own_hi=None) -> ScanState:
    """`scan_fast_plain` with the identity coupling, as one launch of the
    kernel on mag2's CUDA device in the layout `plan` gives; the input
    state is left as it was. Raises on a shape `plan` refuses, on tensors
    the kernel does not take and on a launch the card refuses."""
    run = _Launch(mag2, state, n_valid, p, n_bins, id_stride, bin_lo,
                  own_lo, own_hi, split=False)
    run.step(MODE_WHOLE)
    return run.out


class SplitScan:
    """`scan_fast_plain` with a coupling, as the kernel's split on mag2's
    CUDA device, a step at a time, eagerly (csrc/detect_fast.cu, its
    header): the step API of the tools and the card tests. Made with the
    block (the begin: the input state's clone, gone table zeroed,
    checked; the split's scratch zeroed); then for each of the `n_act`
    active frames in order, `a(f)` launches phase A and the seam and
    returns the frame's pair `pair`, (2,) int64 [any long-burst deletion,
    owned active count] in the scratch; the caller sums it over every bin
    range in place; `b(f)` launches phase B, which reads it; `end()`
    returns the new ScanState. Several ranges can run in lockstep on one
    card, their pairs summed between the steps. Raises as
    `scan_fast_kernel` does."""

    def __init__(self, mag2: torch.Tensor, state: ScanState, n_valid: int,
                 p: DetectorParams, n_bins: int | None = None,
                 id_stride: int = 1, bin_lo=0, own_lo=0, own_hi=None):
        self._run = _Launch(mag2, state, n_valid, p, n_bins, id_stride,
                            bin_lo, own_lo, own_hi, split=True)
        self.n_act = self._run.n_act
        self.pair = self._run.pair

    def a(self, f: int) -> torch.Tensor:
        self._run.step(MODE_A, f)
        return self.pair

    def b(self, f: int) -> None:
        self._run.step(MODE_B, f)

    def end(self) -> ScanState:
        out = self._run.out
        if self.n_act == 0:
            # the last launch B writes the gone count; with none, no row
            out.g_count.zero_()
        return out


def _captured():
    """A CUDA graph captured at its first replay without an eager run
    first (`pipeline.Captured(warm=False)`): the split's graph updates the
    state in place, so a run before the capture would advance it; the
    packing has bound the kernel's library and set its attributes, and
    binshard's all_reduce has run on its communicator before the block's
    detect step."""
    from ..runtime import pipeline  # which imports this module
    return pipeline.Captured(warm=False)


class SplitGraphs:
    """The split's frame loop (`scan_fast_split`) as one CUDA graph a
    block: for each active frame launch A, `coupling_sum` of the pair in
    the scratch (binshard's `all_reduce`, in place), launch B. Its inputs
    live in fixed buffers: the |X|^2 rows, the scratch and the state,
    which the kernel updates in place and which is returned, so that the
    pipeline's next block (`rebase_` updates a state in place) starts from
    it without a copy; a state from elsewhere is first copied in. A graph
    is captured once per count of active frames and replayed after; the
    last MAX_KEPT counts' graphs are kept (a stream's blocks have one
    count, all frames, but at its end). `replays` counts the blocks
    run."""

    MAX_KEPT = 2

    def __init__(self):
        self._cfg = None
        self._graphs: dict = {}
        self.replays = 0

    def run(self, mag2, state, n_valid, p, coupling_sum, n_bins=None,
            id_stride=1, bin_lo=0, own_lo=0, own_hi=None) -> ScanState:
        FL = n_bins if n_bins is not None else p.fft_size
        cfg = (FL, id_stride, bin_lo, own_lo, own_hi, p, coupling_sum,
               tuple(mag2.shape), mag2.device)
        if cfg != self._cfg:
            self._graphs.clear()
            self._cfg = cfg
            self.mag2 = torch.empty_like(mag2)
            self.state = state.clone()
            self.scratch = torch.zeros(plan(p, FL).split_words,
                                       dtype=torch.int32, device=mag2.device)
        out = self.state
        if state.baseline_hist is not out.baseline_hist:
            for f in dataclasses.fields(state):
                getattr(out, f.name).copy_(getattr(state, f.name))
        n_act = active_frames(p, n_valid)
        if n_act not in self._graphs:
            if len(self._graphs) >= self.MAX_KEPT:
                del self._graphs[next(iter(self._graphs))]
            run = _Launch(self.mag2, None, n_valid, p, n_bins, id_stride,
                          bin_lo, own_lo, own_hi, split=True, out=out,
                          scratch=self.scratch)

            def frames():
                for name in GONE_FIELDS:
                    getattr(out, name).zero_()
                out.g_count.zero_()
                self.scratch.zero_()
                for f in range(n_act):
                    run.step(MODE_A, f)
                    if coupling_sum(run.pair) is not run.pair:
                        raise ValueError("coupling_sum must sum the pair "
                                         "in place and return it")
                    run.step(MODE_B, f)
            self._graphs[n_act] = (_captured(), frames)
        self.mag2.copy_(mag2)
        graph, frames = self._graphs[n_act]
        graph.replay(frames)
        self.replays += 1
        return out


def scan_fast_split(mag2: torch.Tensor, state: ScanState, n_valid: int,
                    p: DetectorParams, coupling_sum,
                    n_bins: int | None = None, id_stride: int = 1,
                    bin_lo=0, own_lo=0, own_hi=None,
                    graphs: SplitGraphs | None = None) -> ScanState:
    """`scan_fast_plain(..., coupling_sum=coupling_sum)` on mag2's CUDA
    device: the block's active frames replayed as one CUDA graph of, per
    frame, the kernel's launch A, `coupling_sum` of its pair, launch B
    (`SplitGraphs`; `graphs` keeps them across blocks, a fresh one
    captures anew). `coupling_sum` sums the pair over the bin ranges in
    place and returns it (binshard's `all_reduce`); the identity leaves
    it. The result is the graphs' state buffer, which the next call with
    the same `graphs` updates in place (a state from elsewhere is copied
    in first, and is left as it was). Raises where the kernel cannot build
    or launch, and where the capture fails."""
    graphs = SplitGraphs() if graphs is None else graphs
    return graphs.run(mag2, state, n_valid, p, coupling_sum, n_bins,
                      id_stride, bin_lo, own_lo, own_hi)


def scan_fast_steps(mag2: torch.Tensor, state: ScanState, n_valid: int,
                    p: DetectorParams, coupling_sum,
                    n_bins: int | None = None, id_stride: int = 1,
                    bin_lo=0, own_lo=0, own_hi=None) -> ScanState:
    """`scan_fast_split`'s frame loop run eagerly from the host: per active
    frame the kernel's launch A, `coupling_sum` of its pair (in place),
    launch B (`SplitScan`). The input state is left as it was. binshard
    across cards runs this: its graph, whose all_reduces NCCL would run
    inside the capture, has not been run on more than one card. Raises as
    `scan_fast_split` does."""
    s = SplitScan(mag2, state, n_valid, p, n_bins, id_stride, bin_lo,
                  own_lo, own_hi)
    for f in range(s.n_act):
        pair = s.a(f)
        if coupling_sum(pair) is not pair:
            raise ValueError("coupling_sum must sum the pair in place and "
                             "return it")
        s.b(f)
    return s.end()


def make_scan_fast(p: DetectorParams, n_bins: int | None = None,
                   coupling_sum=None, id_stride: int = 1,
                   graph: bool = True):
    """Build run(mag2, state, n_valid, bin_lo=0, own_lo=0, own_hi=F) ->
    new ScanState over a block of fftshifted |X|^2 rows (frames_per_block,
    n_bins) f32; the input state is left as it was, but for a state that
    `run` returned on the card with a `coupling_sum`, which the next call
    updates in place. `coupling_sum` maps the frame's (2,) int64 [any
    long-burst deletion, owned active count] to its sum over every bin
    range (identity: this range is all of them). On a CPU tensor `run` is
    `scan_fast_plain`. On a CUDA tensor it launches the kernel, which
    raises where it cannot build or launch: one launch a block
    (`scan_fast_kernel`), or with a `coupling_sum` (binshard) the split's
    frame loop replayed as one CUDA graph a block (`scan_fast_split`, its
    graphs and state buffer kept across calls in `run.graphs`), or with
    `graph` False run eagerly from the host (`scan_fast_steps`; the input
    state is left as it was). No path falls back to the twin on the
    card."""
    K_CREATE = detect_scan._consts(p)["k_create"]
    if p.max_new_per_frame > K_CREATE:
        _warn_clamp_once(p.max_new_per_frame, K_CREATE)
    _check_gone(p)
    graphs = SplitGraphs() if coupling_sum is not None and graph else None

    def run(mag2: torch.Tensor, state: ScanState, n_valid: int,
            bin_lo=0, own_lo=0, own_hi=None) -> ScanState:
        rng = dict(n_bins=n_bins, id_stride=id_stride, bin_lo=bin_lo,
                   own_lo=own_lo, own_hi=own_hi)
        if mag2.device.type == "cpu":
            return scan_fast_plain(mag2, state, n_valid, p,
                                   coupling_sum=coupling_sum, **rng)
        if coupling_sum is None:
            return scan_fast_kernel(mag2, state, n_valid, p, **rng)
        if graphs is None:
            return scan_fast_steps(mag2, state, n_valid, p, coupling_sum,
                                   **rng)
        return scan_fast_split(mag2, state, n_valid, p, coupling_sum,
                               graphs=graphs, **rng)

    run.graphs = graphs
    return run


def make_detect_block_fast(p: DetectorParams):
    """detect(samples, state, n_valid, window=None) -> new ScanState: the
    spectrogram of the block (detect_scan.spectrogram), then the scan."""
    run = make_scan_fast(p)

    def detect(samples: torch.Tensor, state: ScanState, n_valid: int,
               window: torch.Tensor | None = None) -> ScanState:
        return run(detect_scan.spectrogram(samples, p, window), state,
                   n_valid)

    return detect
