"""Burst-detector scan and detect step.

`scan` runs the hand-written CUDA kernel (csrc/detect_scan.cu) on a CUDA
state and `scan_plain` on a CPU one; `scan_plain` is the same state
machine written with tensor ops, frame by frame, and is what the tests
hold against the JAX package's Pallas kernel
(iridium_tpu/dsp/detect_pallas.py, kernel :152-375). Both follow that
kernel's greedy-argmax creation walk, not detect_fast's segment maxima.

`detect_block` is the detect step: Blackman window, FFT, |X|^2 and
fftshift of every frame of a block (`make_detect_block_pallas` :485-502),
then the scan.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..config import DetectorParams
from ..ops import windows
from . import state as state_mod
from .state import E_DEL, E_SQ, GONE_FIELDS, ScanState

# The kernel's layout (csrc/detect_scan.cu): one thread block, a
# thread-block cluster of C blocks, or a grid of N clusters of C blocks,
# walks the frames; each block owns K contiguous tiles of FB bins, tile t
# (counted across the grid, block r holding tiles r K ... r K + K - 1) the
# bins [t FB, min((t + 1) FB, F)), and thread i of a block the BPT bins
# from t FB + i BPT of each of its tiles. A block of the ring path holds
# at most RING_BINS bins (1024 threads of 8 and its |X|^2 ring); a
# cluster has at most 16 blocks (H100's largest, a non-portable size
# above 8), so above 16 x RING_BINS the blocks take BLOCK_BINS bins (1024
# threads of 16: the wide path). Above one cluster of 16 wide blocks the
# kernel runs as a grid of clusters of 16 that meet through device memory
# behind a grid-wide barrier, which needs every cluster resident at once:
# of ring blocks up to MAX_GRID clusters, then of wide blocks, up to
# MAX_RESIDENT bins, the most that blocks holding their bins' state on
# chip cover. Above it the grid stays MAX_GRID clusters and each block
# walks K = 2 or more tiles of at most BLOCK_BINS bins, whose state waits
# in device memory between the block's turns on them (the tiled kernel).
# MAX_GRID is the number of clusters of 16 blocks (one an SM) that an
# H100 SXM holds at once (`max_active_clusters`, measured 7 for every
# kind of block); the C entry asks the card before each grid launch and
# refuses a grid of more clusters than it places, before anything runs,
# and a layout whose shared memory a block cannot hold.
RING_BINS = 8192
BLOCK_BINS = 16384
MAX_THREADS = 1024
MAX_CLUSTER = 16
MAX_GRID = 7
MAX_RESIDENT = MAX_GRID * MAX_CLUSTER * BLOCK_BINS
# the kernel's sample positions (n_valid, a frame's end) are int32: a
# block holds fewer than 2^31 samples
MAX_BLOCK_SAMPLES = 2**31 - 1


def layout(F: int) -> tuple[int, int, int, int, int, int]:
    """(C, FB, T, BPT, N, K): blocks of a cluster, bins a tile, threads a
    block, bins a thread, clusters of the grid and tiles a block. Up to
    RING_BINS bins one block, each thread with the fewest bins that 1024
    threads hold (power-of-two F from 1024: 1024 threads); then the least
    power-of-two cluster of blocks of at most RING_BINS bins, 8 a thread;
    above 16 such blocks (F > 131072) 16 blocks of 16 bins a thread; above
    one such cluster (F > 262144) the least grid of clusters of 16 ring
    blocks, up to MAX_GRID clusters (F <= 917504), then of 16 wide blocks,
    up to MAX_RESIDENT; so far one tile a block (K = 1, FB the block's
    bins). Above MAX_RESIDENT: MAX_GRID clusters of 16 blocks of K =
    ceil(F / MAX_RESIDENT) tiles of at most BLOCK_BINS bins, 16 a thread
    (1.6 GHz, F = 2097152: 2 tiles of 9,376 bins a block). The bins are
    split evenly over the N C K tiles. T is rounded up to whole warps:
    the threads past a tile's last bin hold no bin of it (F = 4224: 544
    threads of 8, the last 16 idle); every bin is one thread's."""
    if F <= 0 or F % 128:
        raise ValueError(f"F = {F}: the scan kernel takes a multiple of "
                         f"128 bins")
    C, N, K = 1, 1, 1
    while C * RING_BINS < F and C < MAX_CLUSTER:
        C *= 2
    if F > MAX_RESIDENT:
        N, BPT = MAX_GRID, 16
        K = -(-F // MAX_RESIDENT)
    elif C * BLOCK_BINS < F:
        N = -(-F // (C * RING_BINS))
        BPT = 8
        if N > MAX_GRID:
            N = -(-F // (C * BLOCK_BINS))
            BPT = 16
    elif C * RING_BINS < F:
        BPT = 16
    elif C > 1:
        BPT = 8
    else:
        BPT = 1
        while BPT * MAX_THREADS < F:
            BPT *= 2
    FB = -(-F // (N * C * K))
    FB = -(-FB // BPT) * BPT
    T = -(-FB // BPT)
    return C, FB, -(-T // 32) * 32, BPT, N, K


def clusters(F: int) -> int:
    """Blocks of the kernel's cluster at F bins (`layout`)."""
    return layout(F)[0]


def grid_clusters(F: int) -> int:
    """Clusters of the kernel's grid at F bins (`layout`): 1 up to 262144."""
    return layout(F)[4]


def tiles(F: int) -> int:
    """Tiles a block of the kernel walks at F bins (`layout`): 1 up to
    MAX_RESIDENT."""
    return layout(F)[5]


def block_edges(F: int) -> list[int]:
    """The first bin of every tile but the first (across the grid): the
    block edges, and inside a tiled block its tiles' edges."""
    C, FB, _, _, N, K = layout(F)
    return [t * FB for t in range(1, N * C * K) if t * FB < F]


def grid_words(lay: tuple) -> int:
    """32-bit words of a grid launch's scratch (csrc/detect_scan.cu
    `Grid`): the arrival counter and its line, two frames' parity of N
    cluster partials (4 words each), each tile's gone count, and each
    tile's gone list (FB 16-bit entries: every bin the grid owns); 1 for a
    single cluster without tiles."""
    C, FB, _, _, N, K = lay
    if N == K == 1:
        return 1
    n_tiles = N * C * K
    return 32 + 8 * N + n_tiles + (n_tiles * FB + 1) // 2


def tile_words(lay: tuple) -> int:
    """32-bit words of the tiled kernel's scratch (csrc/detect_scan.cu
    `Turn`): four for each thread of each tile, the thread's bits and
    halo sums between the block's turns on the tile; 1 without tiles."""
    C, _, T, _, N, K = lay
    return 4 * N * C * K * T if K > 1 else 1


def supports(p: DetectorParams) -> bool:
    """Shapes the kernel handles: every multiple of 128 bins (`layout`:
    above MAX_RESIDENT, tiled); a history of two rows or more (the row a
    noise update evicts was stored two or more updates before, so that
    store has completed when the row is read back); a gone table the
    per-frame emission caps can fill (detect_fast's own rule); a block of
    fewer than 2^31 samples (MAX_BLOCK_SAMPLES: 1.6 GHz at its default
    1,024 frames is 2^31, and goes to detect_fast, which counts a block's
    valid frames in Python ints). It is the JAX package's Pallas `supports`
    (detect_pallas.py:72-79) without the chunk rules (the kernel walks the
    frames one by one) and with that block limit. Any F is taken: a shape
    is refused otherwise only by the device memory its state and block
    need, and the allocation raises."""
    F = p.fft_size
    return (F % 128 == 0 and F > 0
            and p.history_size >= 2
            and p.gone_capacity <= p.frames_per_block * (E_DEL + E_SQ)
            and p.block_samples <= MAX_BLOCK_SAMPLES)


IMPLS = ("scan", "fast", "exact")


def resolve_impl(p: DetectorParams, requested: str = "auto") -> str:
    """The detector scan a pipeline runs: the JAX package's production
    resolution (detect_pallas.resolve_impl :82-89, "scan" where it says
    "pallas"): the kernel where it supports the shape, detect_fast
    otherwise, on the CPU (where "scan" runs scan_plain) as on the card.
    "exact" is detect.py's per-frame scan. Asking for "scan" on a shape
    the kernel refuses raises."""
    if requested == "auto":
        return "scan" if supports(p) else "fast"
    if requested not in IMPLS:
        raise ValueError(f"detect_impl {requested!r}: expected 'auto' or "
                         f"one of {IMPLS}")
    if requested == "scan" and not supports(p):
        raise ValueError("detector shape not supported by the scan kernel")
    return requested


def _consts(p: DetectorParams) -> dict:
    F = p.fft_size
    return dict(
        threshold=np.float32(p.threshold),
        hist_f=np.float32(p.history_size),
        enbw=np.float32(windows.BLACKMAN_ENBW),
        f2=np.float32(F) * np.float32(F),
        bin_width=np.float32(p.sample_rate) / np.float32(F),
        k_create=max(1, min(4, p.max_new_per_frame)))


def scan(mag2: torch.Tensor, state: ScanState, n_valid: int,
         p: DetectorParams) -> ScanState:
    """New state after the block of fftshifted |X|^2 rows `mag2`
    (frames_per_block, F) f32. The input state is left as it was. The
    kernel runs in the `layout(F)` it is handed (above 8192 bins a
    cluster, above 262144 a grid of clusters, above MAX_RESIDENT a grid of
    tiled blocks); a shape it does not support (`supports`), a launch the
    card refuses, and a grid it cannot hold at once, raise before anything
    runs."""
    if mag2.device.type == "cpu":
        return scan_plain(mag2, state, n_valid, p)
    if not supports(p):
        raise ValueError("detector shape not supported by the scan kernel")
    F, H, G = p.fft_size, p.history_size, p.gone_capacity
    dev = mag2.device
    _kernels.check(mag2, "mag2", torch.float32, dev,
                   (p.frames_per_block, F))
    out = state.clone()
    for name in GONE_FIELDS:
        getattr(out, name).zero_()
    state_mod.check(out, p, dev)
    c = _consts(p)
    lay = layout(F)
    blocks = lay[0] * lay[4]
    # the edge threads of a resident cluster's blocks keep the halo words
    # they add (2 x H a block); a grid meets in a zeroed scratch
    # (`grid_words`); a tiled block keeps its threads' words of each tile
    # between its turns on it (`tile_words`)
    halo = torch.empty(blocks * 2 * H if blocks > 1 and lay[5] == 1 else 1,
                       dtype=torch.float32, device=dev)
    grid = torch.zeros(grid_words(lay), dtype=torch.int32, device=dev)
    turns = torch.empty(tile_words(lay), dtype=torch.int32, device=dev)
    k = _kernels
    k.DETECT_SCAN.launch(
        dev, k.ptr(mag2), k.ptr(out.baseline_hist), k.ptr(out.baseline_sum),
        k.ptr(out.a_valid), k.ptr(out.a_id), k.ptr(out.a_start),
        k.ptr(out.a_last), k.ptr(out.a_mag), k.ptr(out.a_noise),
        k.ptr(out.mask_count),
        *[k.ptr(getattr(out, name)) for name in GONE_FIELDS],
        k.ptr(out.ints), k.ptr(out.floats), k.ptr(halo), k.ptr(grid),
        k.ptr(turns),
        F, p.frames_per_block, H, G, int(n_valid), p.burst_width_bins // 2,
        c["k_create"], int(p.max_bursts), int(p.max_burst_len),
        int(p.burst_post_len), int(p.burst_pre_len),
        float(c["threshold"]), float(c["hist_f"]), float(c["enbw"]),
        float(c["f2"]), float(c["bin_width"]), *lay)
    return out


def max_active_clusters(F: int) -> int:
    """Clusters of the kernel's `layout(F)` (2 or more blocks) that the
    current card can hold at once, asked with the launch's own attributes
    (a cluster of 16 is a non-portable size): 0 means the card cannot
    launch one; a grid of N clusters launches only where this is N or
    more. Needs the card and the built kernel."""
    import ctypes
    lib = ctypes.CDLL(str(_kernels.DETECT_SCAN.build()))
    fn = lib.detect_scan_max_clusters
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    code = fn(F, *layout(F), ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"detect_scan_max_clusters: CUDA error {code}")
    return n.value


def scan_plain(mag2: torch.Tensor, state: ScanState, n_valid: int,
               p: DetectorParams) -> ScanState:
    """The scan as tensor ops, one frame at a time (any device). Follows
    the Pallas kernel line for line; the float arithmetic is f32 in the
    same order, so baseline_sum is bit-equal to the kernel's."""
    F, H, G = p.fft_size, p.history_size, p.gone_capacity
    dev = mag2.device
    c = _consts(p)
    thr, hist_f, enbw = c["threshold"], c["hist_f"], c["enbw"]
    f2, bin_width, k_create = c["f2"], c["bin_width"], c["k_create"]
    hb = p.burst_width_bins // 2
    max_bursts = int(p.max_bursts)
    s = state.clone()
    hidx, prim, burst_id, sq_count, n_tagged, dropped, waits, _ = \
        s.ints.tolist()
    peak = np.float32(s.floats[0].item())
    bsum, hist = s.baseline_sum, s.baseline_hist
    valid, a_last, mask = s.a_valid, s.a_last, s.mask_count
    g = torch.arange(F, device=dev)
    dc = F // 2
    elig = (g >= hb) & (g < F - hb) & ~((g >= dc - 3) & (g <= dc + 3))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = []

    def emit(bins, stop):
        for b in bins.tolist():
            rows.append((int(s.a_id[b]), int(s.a_start[b]), stop,
                         int(a_last[b]), b, float(s.a_mag[b]),
                         float(s.a_noise[b])))

    def near(b):
        return (g - b).abs() <= hb

    for f in range(p.frames_per_block):
        idx = f * F
        act = idx + F <= n_valid
        mag = mag2[f]
        primed = prim >= H and act

        def noise_update():
            nonlocal prim, hidx
            ev = hist[hidx]
            bsum.copy_((bsum - (ev if prim >= H else zero)) + mag)
            hist[hidx] = mag
            prim = min(prim + 1, H)
            hidx = (hidx + 1) % H

        rel = torch.where(bsum > 0, mag / bsum, zero)
        n_act_pre = int(valid.sum())
        relm = torch.where((mask == 0) & elig, rel, zero)
        cand = torch.where(relm > thr, relm, zero)
        crt = torch.zeros(F, dtype=torch.bool, device=dev)

        if primed and n_act_pre > 0:
            nxt = torch.cat([rel[1:], zero[None]])
            prv = torch.cat([zero[None], rel[:-1]])
            dil = torch.maximum(rel, torch.maximum(nxt, prv)) > thr
            a_last.copy_(torch.where(valid & dil, idx, a_last))
            longb = valid & ((a_last - s.a_start) > p.max_burst_len)
            gone = valid & (((a_last + p.burst_post_len) <= idx) | longb)
            n_del = int(gone.sum())
            if n_del > 0:
                n_tagged += n_del
                dropped += max(n_del - E_DEL, 0)
                gbins = torch.nonzero(gone).flatten()
                emit(gbins[:E_DEL], idx)
                # release the +-half_bw mask of every gone bin
                cs = torch.cumsum(torch.cat([
                    torch.zeros(hb + 1, dtype=torch.int64, device=dev),
                    gone.long(),
                    torch.zeros(hb, dtype=torch.int64, device=dev)]), 0)
                mask -= (cs[2 * hb + 1:] - cs[:F]).int()
                valid &= ~gone
                if bool(longb.any()):
                    noise_update()

        n_acc = 0
        for _ in range(k_create):
            mt = cand.max()
            m = np.float32(mt.item())
            if not (primed and m > thr):
                break
            b = int(torch.nonzero(cand == mt)[0])
            base_at = np.float32(bsum[b].item())
            mag_db = np.float32(10.0) * np.log10(
                max(m * hist_f * enbw, np.float32(1e-30)))
            noise_db = np.float32(10.0) * np.log10(max(
                base_at / hist_f / f2 / enbw / bin_width,
                np.float32(1e-30)))
            valid[b] = True
            s.a_id[b] = burst_id
            s.a_start[b] = idx - p.burst_pre_len
            a_last[b] = idx - p.burst_pre_len
            s.a_mag[b] = float(mag_db)
            s.a_noise[b] = float(noise_db)
            crt[b] = True
            burst_id += 10
            nb = near(b)
            mask += nb.int()
            cand = torch.where(nb, zero, cand)
            peak = max(peak, mag_db)
            n_acc += 1
        if n_acc == k_create and bool((cand > thr).any()):
            waits += 1

        n_act_post = int(valid.sum())
        squelch = max_bursts > 0 and primed and n_act_post > max_bursts
        if squelch:
            sq = valid & ~crt
            n_sq = int(sq.sum())
            n_tagged += n_sq
            dropped += max(n_sq - E_SQ, 0)
            emit(torch.nonzero(sq).flatten()[:E_SQ], idx)
            valid.zero_()
            mask.zero_()
            sq_count += 3
        elif act:
            sq_count = max(sq_count - 1, 0)
        if act and sq_count >= 10:
            bsum.zero_()
            prim = 0
            sq_count = 0
        if act and (0 if squelch else n_act_post) == 0:
            noise_update()

    n = min(len(rows), G)
    for name in GONE_FIELDS:
        getattr(s, name).zero_()
    if n:
        cols = list(zip(*rows[:n]))
        for name, col in zip(GONE_FIELDS, cols):
            t = getattr(s, name)
            t[:n] = torch.tensor(col, dtype=t.dtype)
    s.ints.copy_(torch.tensor([hidx, prim, burst_id, sq_count, n_tagged,
                               dropped, waits, n], dtype=torch.int32))
    s.floats[0] = float(peak)
    return s


def frame_window(p: DetectorParams, device) -> torch.Tensor:
    """(F,) f32 Blackman window normalised by 0.42."""
    return torch.from_numpy(
        windows.blackman(p.fft_size) / np.float32(0.42)).to(device)


def spectrogram(samples: torch.Tensor, p: DetectorParams,
                window: torch.Tensor | None = None,
                n_frames: int | None = None) -> torch.Tensor:
    """(block_samples,) complex64 -> (frames_per_block, F) f32 fftshifted
    |X|^2 of the Blackman-windowed frames (`n_frames` frames: a sharded
    rank's time slice). A caller that runs many blocks passes
    `frame_window` once made: building it copies from the host, which
    waits for the device."""
    F = p.fft_size
    n_frames = p.frames_per_block if n_frames is None else n_frames
    if window is None:
        window = frame_window(p, samples.device)
    frames = samples[: n_frames * F].reshape(n_frames, F)
    spec = torch.fft.fft(frames * window[None, :])
    return torch.fft.fftshift(spec.abs() ** 2, dim=-1)


def detect_block(samples: torch.Tensor, state: ScanState, n_valid: int,
                 p: DetectorParams,
                 window: torch.Tensor | None = None) -> ScanState:
    """The detect step: spectrogram of the block, then the scan."""
    return scan(spectrogram(samples, p, window), state, n_valid, p)
