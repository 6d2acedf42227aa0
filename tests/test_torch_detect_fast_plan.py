"""The detect_fast kernel's layout and decomposition on the CPU.

`plan` (iridium_tpu_torch/dsp/detect_fast.py) at every shape the card
runs and at binshard's local widths, the split's scratch included; the
dispatch of `make_scan_fast` (the CPU runs the plain twin, a CUDA tensor
the kernel: one launch a block, or with binshard's coupling the split's
frame loop of launch A, the coupling and launch B a frame, replayed as
one CUDA graph a block); and `kernel_steps`, the kernel's decomposition
(csrc/detect_fast.cu) written as tensor ops and cut at the coupling seam
as the split cuts it: bins split into blocks and blocks into clusters,
each block's 8 largest candidate keys merged into its cluster's 8 and the
clusters' into the range's 8, per-block emission counts with their
exclusive prefix over the lower blocks, the owned active count kept as a
scalar, the mask release wherever the range has a deletion, and the live
history ring. Under the identity coupling (`kernel_model`) it is held
bit-equal to `scan_fast_plain` on every field of the state over
test_torch_detect_fast.py's scenarios, at 1, 2, 3 and 7 blocks (in
clusters of 1 and 2) and with blocks narrower than half the burst width;
over 2 and 4 bin ranges in lockstep (`split_model`) to the twin run over
the same ranges in threads whose `coupling_sum` is a barrier sum.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect_fast, detect_scan  # noqa: E402
from iridium_tpu_torch.dsp import state as st  # noqa: E402
from iridium_tpu_torch.tools import exp_fast  # noqa: E402

from test_detect import tone_capture  # noqa: E402
from test_torch_detect_fast import SCENARIOS  # noqa: E402
from test_torch_detect_scan import CPU, params, spectrogram  # noqa: E402

K_LIST = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """The model's tensors hold a few thousand elements: one intra-op
    thread runs its thousands of small operations as fast as eight, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _f32_of_key(k: int) -> float:
    return float(np.uint32(k >> 32).view(np.float32))


def _window_sums(x: torch.Tensor, hb: int) -> torch.Tensor:
    n = x.shape[0]
    cs = torch.cumsum(torch.nn.functional.pad(x, (hb + 1, hb)), 0,
                      dtype=torch.int32)
    return cs[2 * hb + 1:] - cs[:n]


def kernel_steps(mag2, state, n_valid, p, block_bins, n_bins=None,
                 id_stride=1, bin_lo=0, own_lo=0, own_hi=None, clusters=1):
    """The kernel's algorithm over blocks of `block_bins` bins (a multiple
    of its segment) in clusters of `clusters` blocks, on the CPU, cut at
    the coupling seam as the split cuts it: a generator that yields each
    active frame's pair (any_long, n_own_post) after phase A and the
    seam, takes the pair summed over the bin ranges by `send`, runs phase
    B, and returns the new ScanState."""
    F, H, G = p.fft_size, p.history_size, p.gone_capacity
    FL = n_bins if n_bins is not None else F
    own_hi = F if own_hi is None else own_hi
    hb = p.burst_width_bins // 2
    c = detect_scan._consts(p)
    thr, hist_f, enbw = (float(c["threshold"]), float(c["hist_f"]),
                         float(c["enbw"]))
    f2, bin_width = float(c["f2"]), float(c["bin_width"])
    k_create = c["k_create"]
    k_top = 2 * k_create
    _, NS = detect_fast._segments(hb, FL)
    segk, BB = FL // NS, block_bins
    assert BB % segk == 0
    nb = -(-FL // BB)
    i32, i64 = torch.int32, torch.int64
    s = state.clone()
    for name in st.GONE_FIELDS:
        getattr(s, name).zero_()
    hist, bsum, mask = s.baseline_hist, s.baseline_sum, s.mask_count
    hidx, prim, burst_id, sq, tagged, dropped, waits, _ = s.ints.tolist()
    peak = s.floats[0].clone()
    g_run = 0
    iota = torch.arange(FL)
    gbin = bin_lo + iota
    dc = F // 2
    elig = (gbin >= hb) & (gbin < F - hb) & ~((gbin >= dc - 3)
                                              & (gbin <= dc + 3))
    owned = (gbin >= own_lo) & (gbin < own_hi)
    blk = iota // BB
    rev = (0x7FFFFFFF - iota) << 1
    zero = torch.zeros(())
    spb = BB // segk                   # segments a block
    # the owned active count, kept as a scalar
    n_own_run = int((s.a_valid & owned).sum())

    def by_block(x):
        return torch.bincount(blk[x], minlength=nb)

    def exclusive(x):
        return (torch.cumsum(x, 0) - x).tolist()

    def rows(bits, counts, pre, cap, base, idx):
        """Each block's rows: ascending bins after its lower blocks'."""
        for b in range(nb):
            if counts[b] == 0 or pre[b] >= cap or base + pre[b] >= G:
                continue
            sel = torch.nonzero(bits & (blk == b)).flatten().tolist()
            for r, i in enumerate(sel, start=pre[b]):
                pos = base + r
                if r < cap and pos < G:
                    for name, v in (("g_id", s.a_id[i]),
                                    ("g_start", s.a_start[i]),
                                    ("g_stop", idx), ("g_last", s.a_last[i]),
                                    ("g_bin", bin_lo + i),
                                    ("g_mag", s.a_mag[i]),
                                    ("g_noise", s.a_noise[i])):
                        getattr(s, name)[pos] = v

    for f in range(detect_fast.active_frames(p, n_valid)):
        idx = f * F
        mag = mag2[f]
        primed = prim >= H
        valid = s.a_valid
        # ---- phase A
        rel = torch.where(bsum > 0, mag / bsum, zero)
        th = rel > thr
        nbr = torch.zeros(FL, dtype=torch.bool)
        nbr[1:] |= th[:-1]
        nbr[:-1] |= th[1:]
        if primed:
            s.a_last[valid & (th | nbr)] = idx
        lng = valid & ((s.a_last - s.a_start) > p.max_burst_len)
        gone = valid & (((s.a_last + p.burst_post_len) <= idx) | lng)
        flags = gone & primed
        emit = flags & owned
        valid &= ~flags
        cand = (rel > thr) & (mask == 0) & elig
        key = torch.where(cand, (rel.view(i32).to(i64) << 32) | rev
                          | valid.to(i64), 0)
        segkey = key.view(NS, segk).max(1).values
        per = torch.zeros(nb * spb, dtype=i64)
        per[:NS] = segkey
        per = per.view(nb, spb)
        lists = torch.zeros(nb, K_LIST, dtype=i64)
        kk = min(K_LIST, spb)
        lists[:, :kk] = per.topk(kk, 1).values
        # each cluster's 8 from its blocks' 8, then the range's from the
        # clusters' (the keys are unique, so any grouping gives the same)
        nc = -(-nb // clusters)
        cl = torch.zeros(nc * clusters, K_LIST, dtype=i64)
        cl[:nb] = lists
        cl = cl.view(nc, clusters * K_LIST).topk(K_LIST, 1).values
        top = cl.flatten().topk(min(K_LIST, nc * K_LIST)).values.tolist()
        top += [0] * (K_LIST - len(top))
        n_emit = by_block(emit)
        n_own = by_block(valid & owned)
        # the scalar less the frame's owned deletions is the count
        n_own_run -= int(n_emit.sum())
        assert n_own_run == int(n_own.sum())
        any_long = bool(lng.any())

        # ---- the seam
        bins = [0x7FFFFFFF - ((k & 0xFFFFFFFF) >> 1) for k in top]
        acc, takes, n_accepted = [], [], 0
        for j in range(K_LIST):
            a = (j < k_top and primed and top[j] != 0
                 and _f32_of_key(top[j]) > thr)
            for k in range(j):
                if acc[k] and abs(bins[j] - bins[k]) <= hb:
                    a = False
            acc.append(a)
            if a:
                if n_accepted < k_create:
                    takes.append((bins[j], top[j]))
                n_accepted += 1
        n_post = n_own_run + sum(1 for b, k in takes
                                 if not k & 1 and owned[b])
        # the coupling: the pair out, its sum over the ranges back
        long_sum, n_active = yield (int(any_long), n_post)
        force = long_sum > 0 and primed
        squelch = p.max_bursts > 0 and primed and n_active > p.max_bursts

        # ---- phase B
        n_del = int(n_emit.sum())
        n_del_rows = min(n_del, st.E_DEL)
        rows(emit, n_emit.tolist(), exclusive(n_emit), st.E_DEL, g_run, idx)
        row = hist[hidx]
        live = 1.0 if prim >= H else 0.0
        start = idx - p.burst_pre_len
        if takes:
            # the dB values as the twin forms them: over K_TOP candidates
            tb = torch.tensor([b for b, _ in takes]
                              + [0] * (k_top - len(takes)))
            tv = torch.from_numpy(np.array(
                [k >> 32 for _, k in takes] + [0] * (k_top - len(takes)),
                np.uint32).view(np.float32))
            base_at = bsum[tb]
            old_at = row[tb] * live
            base_eff = (base_at - old_at) + mag[tb] if force else base_at
            mag_db = 10.0 * torch.log10(torch.clamp(tv * hist_f * enbw,
                                                    min=1e-30))
            noise_db = 10.0 * torch.log10(torch.clamp(
                base_eff / hist_f / f2 / enbw / bin_width, min=1e-30))
            for k, (b, _) in enumerate(takes):
                s.a_id[b] = _i32(burst_id + 10 * id_stride * k)
                s.a_start[b] = start
                s.a_last[b] = start
                s.a_mag[b] = mag_db[k]
                s.a_noise[b] = noise_db[k]
                valid[b] = True
                peak = torch.maximum(peak, mag_db[k])
        if force:
            bsum.copy_((bsum - row * live) + mag)
            hist[hidx] = mag
            prim = min(prim + 1, H)
            hidx = (hidx + 1) % H
        if not squelch:
            d = torch.zeros(FL, dtype=i32)
            for b, _ in takes:
                d += ((iota - b).abs() <= hb).to(i32)
            if flags.any():
                d -= _window_sums(flags.to(i32), hb)
            mask += d
        burst_id += 10 * id_stride * len(takes)
        waits += int(n_accepted > k_create)
        n_sq = 0
        if squelch:
            # the squelch's own reduction: its rows' counts and ranks
            created = torch.zeros(FL, dtype=torch.bool)
            created[[b for b, _ in takes]] = True
            bits = valid & ~created & owned
            n_sq_b = by_block(bits)
            n_sq = int(n_sq_b.sum())
            rows(bits, n_sq_b.tolist(), exclusive(n_sq_b), st.E_SQ,
                 g_run + n_del_rows, idx)
            valid.zero_()
            mask.zero_()
        n_own_run = 0 if squelch else n_post
        g_run += n_del_rows + min(n_sq, st.E_SQ)
        tagged += n_del + n_sq
        dropped += max(n_del - st.E_DEL, 0) + max(n_sq - st.E_SQ, 0)
        sq = sq + 3 if squelch else max(sq - 1, 0)
        reset = sq >= 10
        if reset:
            prim, sq = 0, 0
        do1 = (0 if squelch else n_active) == 0
        if reset or do1:
            v = torch.zeros(FL) if reset else bsum.clone()
            if do1:
                live2 = 1.0 if prim >= H else 0.0
                v = (v - hist[hidx] * live2) + mag
                hist[hidx] = mag
                prim = min(prim + 1, H)
                hidx = (hidx + 1) % H
            bsum.copy_(v)
    s.ints = torch.tensor([hidx, prim, _i32(burst_id), sq, _i32(tagged),
                           _i32(dropped), _i32(waits), min(g_run, G)],
                          dtype=torch.int32)
    s.floats = peak.reshape(1)
    return s


def split_model(ranges):
    """`kernel_steps` over several bin ranges in lockstep, each frame's
    pairs summed: [(mag2, state, n_valid, p, block_bins, range kwargs)] ->
    the new ScanStates."""
    steps = [kernel_steps(*r[:5], **r[5]) for r in ranges]
    total = None
    while True:
        pairs, outs = [], []
        for g in steps:
            try:
                pairs.append(g.send(total))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            assert not pairs, "the ranges ran apart"
            return outs
        total = tuple(int(sum(v)) for v in zip(*pairs))


def kernel_model(*args, **kw):
    """`kernel_steps` under the identity coupling: the new ScanState."""
    return split_model([args + (kw,)])[0]


def assert_states_equal(got, want):
    """Every field of the state bit-equal (floats compared as bits)."""
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (
            field.name, torch.nonzero(a != b).flatten()[:5].tolist())


def _segment(p, FL=None):
    FL = p.fft_size if FL is None else FL
    _, NS = detect_fast._segments(p.burst_width_bins // 2, FL)
    return FL // NS


def block_widths(p, FL=None):
    """Bins a block for 1, 2, 3 and 7 blocks (whole segments), and a width
    narrower than half the burst width."""
    FL = p.fft_size if FL is None else FL
    seg = _segment(p, FL)
    out = []
    for n in (1, 2, 3, 7):
        w = -(-FL // n)
        out.append(-(-w // seg) * seg)
    narrow = seg
    while narrow * 2 < p.burst_width_bins // 2:
        narrow *= 2
    assert narrow < p.burst_width_bins // 2
    return out + [narrow]


@pytest.mark.parametrize("name,kw,make,n_blocks,at_least", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_kernel_model_bit_equal_to_twin(name, kw, make, n_blocks,
                                        at_least):
    """The model at 1, 2, 3 and 7 blocks (2 and 7 in clusters of 2, 3 in
    one of 3) and at blocks narrower than half_bw (in clusters of 4)
    gives the twin's state bit for bit, block after block."""
    jp, pp = params(**kw)
    x = make(jp)
    widths = block_widths(pp)
    assert [-(-pp.fft_size // w) for w in widths[:4]] == [1, 2, 3, 7]
    clusters = dict(zip(widths, (1, 2, 3, 2, 4)))
    s_twin = st.init_state(pp, CPU)
    s_model = {w: st.init_state(pp, CPU) for w in widths}
    tagged = 0
    for k in range(n_blocks):
        block = x[k * jp.block_samples:(k + 1) * jp.block_samples]
        mag2 = torch.from_numpy(spectrogram(jp, block))
        s_twin = detect_fast.scan_fast_plain(mag2, s_twin, len(block), pp)
        for w in widths:
            s_model[w] = kernel_model(mag2, s_model[w], len(block), pp, w,
                                      clusters=clusters[w])
            assert_states_equal(s_model[w], s_twin)
            st.rebase_(s_model[w], pp.block_samples)
        tagged += int(s_twin.n_tagged)
        st.rebase_(s_twin, pp.block_samples)
    assert tagged >= at_least


def test_kernel_model_partial_chunk_and_short_history():
    """n_valid ending mid-block (a partial last chunk, a frame cut short)
    and histories of 2 and 4 rows (chunks of 1 and 2 frames, whose two
    updates a frame evict every row of the ring): the live ring gives the
    twin's rows."""
    for H in (64, 4, 2):
        jp, pp = params(history_size=H)
        x = tone_capture(jp, [(0.02, 0.15, 50_000.0, 0.05),
                              (0.05, 0.01, -120_000.0, 0.06)])
        mag2 = torch.from_numpy(spectrogram(jp, x[:jp.block_samples]))
        n_valid = 100 * pp.fft_size + 17
        assert detect_fast.active_frames(pp, n_valid) == 100
        want = detect_fast.scan_fast_plain(mag2, st.init_state(pp, CPU),
                                           n_valid, pp)
        assert int(want.primed) == H
        for w in block_widths(pp)[::2]:
            got = kernel_model(mag2, st.init_state(pp, CPU), n_valid, pp, w)
            assert_states_equal(got, want)


def test_kernel_model_local_range_with_ownership():
    """A local bin range (bin_lo, own_lo, own_hi, id_stride 4) under the
    identity coupling, narrow blocks included: the twin's state."""
    jp, pp = params(max_bursts=4)
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.085, 0.030, -200_000.0, 0.08),
                          (0.12, 0.008, 300_000.0, 0.04),
                          (0.13, 0.015, 99_000.0, 0.06),
                          (0.16, 0.01, 150_000.0, 0.06),
                          (0.161, 0.01, -50_000.0, 0.06),
                          (0.162, 0.01, 250_000.0, 0.06)])
    mag2 = torch.from_numpy(spectrogram(jp, x[:jp.block_samples]))
    F = pp.fft_size
    halo = 2 * (pp.burst_width_bins // 2) + 1
    own = F // 2
    FL = own + 2 * halo
    for me in (0, 1):
        bin_lo = me * own - halo
        cols = torch.from_numpy((np.arange(FL) + bin_lo) % F)
        kw = dict(bin_lo=bin_lo, own_lo=me * own, own_hi=(me + 1) * own)
        s0 = st.init_state(pp, CPU, id_offset=me, n_bins=FL)
        want = detect_fast.scan_fast_plain(mag2[:, cols], s0, F * 256, pp,
                                           n_bins=FL, id_stride=4, **kw)
        assert int(want.n_tagged) > 0
        for w in block_widths(pp, FL):
            got = kernel_model(mag2[:, cols], s0, F * 256, pp, w,
                               n_bins=FL, id_stride=4, **kw)
            assert_states_equal(got, want)


# bursts one to a range of 4 (and two to a range of 2) at once, after the
# 64-frame priming: 4 active bursts, a squelch under max_bursts 3 only
# when the ranges' counts are summed; then two bursts that end naturally
QUAD = [(0.09, 0.03, -300_000.0, 0.05), (0.091, 0.03, -100_000.0, 0.05),
        (0.092, 0.03, 100_000.0, 0.05), (0.093, 0.03, 300_000.0, 0.05),
        (0.16, 0.01, 200_000.0, 0.05), (0.17, 0.01, -200_000.0, 0.05)]
SPLIT_CASES = [
    # id, ranges, config, events, valid frames (None: the block), a
    # squelch that only the summed counts reach
    ("2_ranges_mid_block_h2", 2, dict(history_size=2),
     [(0.02, 0.15, 50_000.0, 0.05), (0.05, 0.01, -120_000.0, 0.06),
      (0.09, 0.01, 120_000.0, 0.06)], 150.5, False),
    ("4_ranges", 4, {}, SCENARIOS[0][2], None, False),
    ("2_ranges_coupled_squelch", 2, dict(max_bursts=3), QUAD, None, True),
    ("4_ranges_coupled_squelch", 4, dict(max_bursts=3), QUAD, None, True),
]


@pytest.mark.parametrize("n,kw,events,frames,squelch",
                         [c[1:] for c in SPLIT_CASES],
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_model_bit_equal_to_coupled_twins(n, kw, events, frames,
                                                squelch):
    """The kernel's decomposition cut at the seam, over n bin ranges in
    lockstep with the frame's pairs summed, at the whole range in one
    block and at blocks narrower than half_bw in clusters of 2, gives the
    twins' states bit for bit, the twins run over the same ranges in
    threads coupled by a barrier sum. In the squelch cases the coupling
    changes the result: a range's state differs from its identity-coupled
    one, and squelch rows appear that no range alone makes."""
    jp, pp = params(**kw)
    x = events(jp) if callable(events) else tone_capture(jp, events)
    mag2 = torch.from_numpy(spectrogram(jp, x[:jp.block_samples]))
    n_valid = (pp.block_samples if frames is None
               else int(frames * pp.fft_size))
    ranges = exp_fast.bin_ranges(pp, mag2, n)
    FL = ranges[0][0].shape[1]
    want = exp_fast.barrier_twins(pp, ranges, n_valid, FL, n)
    widths = block_widths(pp, FL)
    for w, c in ((widths[0], 1), (widths[-1], 2)):
        got = split_model([(m, s0, n_valid, pp, w,
                            dict(r, n_bins=FL, id_stride=n, clusters=c))
                           for m, s0, r in ranges])
        for g, wt in zip(got, want):
            assert_states_equal(g, wt)
    assert sum(int(s.n_tagged) for s in want) >= 2
    if squelch:
        alone = [kernel_model(m, s0, n_valid, pp, widths[0], n_bins=FL,
                              id_stride=n, **r) for m, s0, r in ranges]
        assert any(not torch.equal(a.ints, g.ints)
                   or not torch.equal(a.a_valid, g.a_valid)
                   for a, g in zip(alone, want))
        assert exp_fast.squelch_rows(want, pp) > 0
        assert exp_fast.squelch_rows(alone, pp) == 0


# ---- plan ----

def _rate(rate, **kw):
    return DetectorConfig(sample_rate=rate, **kw).derived()


# (name, params, local bins or None): the shapes chip_smoke.py runs
PLAN_SHAPES = [
    ("10mhz_2048x8192", _rate(10_000_000, frames_per_block=2048,
                              gone_capacity=2048), None),
    ("edge_256x8192", _rate(10_000_000, history_size=64,
                            frames_per_block=256, max_new_per_frame=8,
                            gone_capacity=64, max_bursts=20), None),
    ("25mhz_1024x32768", _rate(25_000_000), None),
    ("400mhz_1024x524288", _rate(400_000_000), None),
    ("1600mhz_1024x2097152", _rate(1_600_000_000), None),
    ("3200mhz_16x4194304", _rate(3_200_000_000, frames_per_block=16,
                                 gone_capacity=64), None),
] + [
    # parallel/stream.py: own_bins + 2 halo, halo = 2 (width // 2) + 1
    (f"binshard_1mhz_world{n}", _rate(1_000_000),
     _rate(1_000_000).fft_size // n
     + 2 * (2 * (_rate(1_000_000).burst_width_bins // 2) + 1))
    for n in (1, 2, 3, 4)
] + [
    (f"binshard_10mhz_world{n}", _rate(10_000_000),
     _rate(10_000_000).fft_size // n
     + 2 * (2 * (_rate(10_000_000).burst_width_bins // 2) + 1))
    for n in (1, 2, 4)
]


@pytest.mark.parametrize("name,p,n_bins", PLAN_SHAPES,
                         ids=[s[0] for s in PLAN_SHAPES])
def test_plan_covers_the_bins(name, p, n_bins):
    FL = p.fft_size if n_bins is None else n_bins
    lay = detect_fast.plan(p, n_bins)
    assert lay.block_bins == lay.threads * lay.bpt
    assert lay.threads % 32 == 0 and 32 <= lay.threads <= 1024
    # every bin one thread's; in one block or cluster every block holds
    # bins, in a grid the last blocks may not
    C = lay.clusters
    assert lay.blocks * lay.block_bins >= FL
    assert (C - 1) * lay.block_bins < FL
    assert lay.blocks % C == 0 and C in (1, 2, 4, 8, 16)
    # one block up to 8,192 bins, then one cluster up to 262,144, then a
    # grid of clusters, each cluster resident (7 of 16, 66 of 2); 32 bins
    # a thread only in clusters of 2
    assert (C == 1) == (FL <= detect_fast.RING_BINS)
    assert lay.grid == (lay.blocks > C) == (FL > 16 * detect_fast.WIDE_BINS)
    assert lay.blocks // C <= (7 if C == 16 else 66)
    if C == 1:
        assert lay.bpt in (1, 2, 4, 8) and lay.block_bins <= 8192
    else:
        assert lay.bpt in (8, 16, 32)
        assert lay.block_bins <= {8: 8192, 16: 16384, 32: 32768}[lay.bpt]
        assert lay.bpt < 32 or (C == 2 and lay.grid)
    # the twin's segments, whole in a block
    SEG, NS = detect_fast._segments(p.burst_width_bins // 2, FL)
    assert (lay.seg, lay.ns) == (SEG, NS)
    seg = FL // lay.ns
    assert seg in (1, 4, 8, 16) and FL % seg == 0
    assert lay.block_bins % seg == 0
    # the scratch: two counter lines, a grid's slots, two flag words a
    # thread; a few MB
    n = lay.blocks // C
    assert lay.scratch_words == (2 * detect_fast.LINE_WORDS
                                 + (2 * n * detect_fast.FRAME_WORDS
                                    if n > 1 else 0)
                                 + 2 * lay.blocks * lay.threads)
    assert lay.scratch_words * 4 < 4 << 20
    # the split's after it: the pair (two int64 at an even word), the
    # scalars in two slots, the seam, a rank a thread
    assert lay.scratch_words % 2 == 0
    assert lay.split_words == (lay.scratch_words + detect_fast.PAIR_WORDS
                               + 2 * detect_fast.SCALAR_WORDS
                               + detect_fast.SEAM_WORDS
                               + lay.blocks * lay.threads)
    # a flag word holds a thread's bins
    assert lay.bpt <= 32


def test_plan_layouts_at_the_card_shapes():
    """(blocks, block bins, threads, bins a thread, clusters) at the card's
    shapes: 10 MHz one block; 25 MHz a cluster of 4; 400 MHz a grid of 4
    clusters of 16; 1.6 GHz 64 clusters of 2 wide blocks; 3.2 GHz (16
    frames) 64 clusters of 2 deep blocks of 32 bins a thread; binshard's 1 MHz
    range at world size 1 (1,106 bins) one block of 2 bins a thread, its 10
    MHz ranges at world size 4 (2,114) one block and at 1 (8,258) a cluster
    of 2."""
    assert detect_fast.plan(_rate(10_000_000))[:5] == (1, 8192, 1024, 8, 1)
    assert detect_fast.plan(_rate(25_000_000))[:5] == (4, 8192, 1024, 8, 4)
    lay = detect_fast.plan(_rate(400_000_000))
    assert lay[:5] == (64, 8192, 1024, 8, 16) and lay.grid
    lay = detect_fast.plan(_rate(1_600_000_000))
    assert lay[:5] == (128, 16384, 1024, 16, 2) and lay.grid
    lay = detect_fast.plan(_rate(3_200_000_000, frames_per_block=16,
                                 gone_capacity=64))
    assert lay[:5] == (128, 32768, 1024, 32, 2) and lay.grid
    # the 1.6 GHz block at its default 1,024 frames is 2^31 samples: the
    # scan kernel refuses it, detect_fast takes it
    p = _rate(1_600_000_000)
    assert p.block_samples == 2**31 and not detect_scan.supports(p)
    assert detect_fast.active_frames(p, 2**31) == 1024
    # binshard at 1 MHz over 4 ranks: 338 bins, segments of 1 (SEG = 2)
    lay = detect_fast.plan(_rate(1_000_000), 338)
    assert lay[:5] == (1, 352, 352, 1, 1) and lay.ns == 338
    assert (lay.scratch_words, lay.split_words) == (768, 1160)
    lay = detect_fast.plan(_rate(1_000_000), 1106)
    assert lay[:5] == (1, 1152, 576, 2, 1) and not lay.grid
    lay = detect_fast.plan(_rate(10_000_000), 8258)
    assert lay[:5] == (2, 4352, 544, 8, 2) and not lay.grid
    assert (lay.scratch_words, lay.split_words) == (2240, 3368)
    lay = detect_fast.plan(_rate(10_000_000), 2114)
    assert lay[:5] == (1, 2176, 544, 4, 1) and not lay.grid
    assert (lay.scratch_words, lay.split_words) == (1152, 1736)


def test_plan_refuses_what_it_cannot_launch():
    p = _rate(1_000_000)
    with pytest.raises(ValueError, match="bins"):
        detect_fast.plan(p, detect_fast.MAX_BINS + 1)
    with pytest.raises(ValueError, match="bins"):
        detect_fast.plan(p, 0)
    with pytest.raises(ValueError, match="history"):
        detect_fast.plan(_rate(1_000_000, history_size=1))
    # 3.2 GHz at 1,024 frames and 1.6 GHz at 2,048: frame positions past
    # int32
    with pytest.raises(ValueError, match="int32"):
        detect_fast.plan(_rate(3_200_000_000))
    with pytest.raises(ValueError, match="int32"):
        detect_fast.plan(_rate(1_600_000_000, frames_per_block=2048))
    with pytest.raises(ValueError, match="gone_capacity"):
        detect_fast.plan(_rate(1_000_000, frames_per_block=16,
                               gone_capacity=1024))
    with pytest.raises(ValueError, match="segments"):
        detect_fast.plan(p, 6)


# ---- dispatch ----

def test_dispatch_cpu_runs_the_twin(monkeypatch):
    """On the CPU `run` is scan_fast_plain; the kernel wrapper is never
    called."""
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05)])
    mag2 = torch.from_numpy(spectrogram(jp, x[:jp.block_samples]))

    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called on the CPU")
    monkeypatch.setattr(detect_fast, "scan_fast_kernel", no_kernel)
    got = detect_fast.make_scan_fast(pp)(mag2, st.init_state(pp, CPU),
                                         pp.block_samples)
    want = detect_fast.scan_fast_plain(mag2, st.init_state(pp, CPU),
                                       pp.block_samples, pp)
    assert_states_equal(got, want)


def test_dispatch_device_runs_the_kernel_and_binshard_the_split(
        monkeypatch):
    """Off the CPU (a meta tensor stands in for the card's) `run` calls the
    kernel wrapper with the range, and nothing else; with a coupling_sum
    (binshard) it calls the kernel's split (`scan_fast_split`) with the
    coupling, the range and the graphs `run` keeps, and with `graph`
    False its eager loop (`scan_fast_steps`) with the coupling and the
    range; never the twin or the one launch."""
    pp = params()[1]
    calls = []
    monkeypatch.setattr(detect_fast, "scan_fast_kernel",
                        lambda *a, **k: calls.append(("kernel", k)))
    monkeypatch.setattr(detect_fast, "scan_fast_plain",
                        lambda *a, **k: calls.append(("plain", k)))
    monkeypatch.setattr(detect_fast, "scan_fast_split",
                        lambda *a, **k: calls.append(("split", a[4:], k)))
    monkeypatch.setattr(detect_fast, "scan_fast_steps",
                        lambda *a, **k: calls.append(("steps", a[4:], k)))
    mag2 = torch.empty((pp.frames_per_block, 40), device="meta")
    detect_fast.make_scan_fast(pp, 40, id_stride=2)(
        mag2, None, 5, bin_lo=3, own_lo=4, own_hi=30)
    assert calls == [("kernel", dict(n_bins=40, id_stride=2, bin_lo=3,
                                     own_lo=4, own_hi=30))]
    calls.clear()
    csum = lambda x: x  # noqa: E731
    run = detect_fast.make_scan_fast(pp, 40, coupling_sum=csum, id_stride=2)
    for _ in range(2):
        run(mag2, None, 5, bin_lo=3, own_lo=4, own_hi=30)
    graphs = calls[0][2].pop("graphs")
    assert isinstance(graphs, detect_fast.SplitGraphs)
    assert calls[1][2].pop("graphs") is graphs
    assert calls == 2 * [("split", (csum,), dict(n_bins=40, id_stride=2,
                                                 bin_lo=3, own_lo=4,
                                                 own_hi=30))]
    calls.clear()
    run = detect_fast.make_scan_fast(pp, 40, coupling_sum=csum, id_stride=2,
                                     graph=False)
    run(mag2, None, 5, bin_lo=3, own_lo=4, own_hi=30)
    assert run.graphs is None
    assert calls == [("steps", (csum,), dict(n_bins=40, id_stride=2,
                                             bin_lo=3, own_lo=4,
                                             own_hi=30))]


class _RecordedGraph:
    """A CUDA graph (`detect_fast._captured`) off the card: runs `fn` at
    its first replay, where the card would capture it, and counts the
    replays."""
    replays = 0

    def __init__(self):
        self.captured = False

    def replay(self, fn):
        if not self.captured:
            fn()
            self.captured = True
        type(self).replays += 1


def _record_kernel(monkeypatch, lay, FL, calls):
    """The kernel's C entries recorded: the packing (checked against the
    split's plan) and the launches."""
    k = detect_fast._kernels.DETECT_FAST
    packed = []

    def call(entry, *args):
        assert entry == "detect_fast_args"
        # ..., the plan's 6 integers and the scratch's words, the split
        # flag, the buffer
        assert args[-10:-2] == (lay.blocks, lay.clusters, lay.block_bins,
                                lay.threads, lay.bpt, FL // lay.ns,
                                lay.split_words, 1)
        assert args[-1] == detect_fast.PACKED_BYTES
        packed.append(args[-2])
        calls.append(("pack", None))

    def launch(dev, buf, mode, frame):
        assert buf is packed[-1]
        calls.append(({1: "A", 2: "B"}[mode], frame))
    monkeypatch.setattr(k, "call", call)
    monkeypatch.setattr(k, "launch", launch)
    monkeypatch.setattr(detect_fast, "_captured", _RecordedGraph)
    _RecordedGraph.replays = 0


@pytest.mark.parametrize("frames", [0, 3])
def test_split_issues_a_coupling_b_per_frame(monkeypatch, frames):
    """`scan_fast_split` on meta tensors (the card's stand-in), the
    kernel's entry points recorded and the CUDA graph recorded where the
    card captures it: the block's arguments packed once, with the split's
    scratch words; then per active frame launch A, the coupling of the
    pair A returned, launch B, in that order, from the packing, once, and
    one replay; nothing for zero active frames."""
    pp = params()[1]
    F, FL = pp.fft_size, 338
    lay = detect_fast.plan(pp, FL)
    calls, pairs = [], []
    _record_kernel(monkeypatch, lay, FL, calls)

    def csum(x):
        assert x.dtype == torch.int64 and tuple(x.shape) == (2,)
        pairs.append(x)
        calls.append(("sum", len(pairs) - 1))
        return x
    mag2 = torch.empty((pp.frames_per_block, FL), device="meta")
    s0 = st.init_state(pp, "meta", n_bins=FL)
    out = detect_fast.scan_fast_split(mag2, s0, frames * F, pp, csum,
                                      n_bins=FL, id_stride=4, bin_lo=-41,
                                      own_lo=0, own_hi=256)
    assert calls == [("pack", None)] + [(step, f) for f in range(frames)
                                        for step in ("A", "sum", "B")]
    assert _RecordedGraph.replays == 1
    # the pair is one buffer of the scratch, summed in place each frame
    assert len({p.data_ptr() for p in pairs}) <= 1
    assert out.g_count.device.type == "meta"


def test_steps_issue_a_coupling_b_per_frame_from_the_host(monkeypatch):
    """`scan_fast_steps` (binshard across cards) on meta tensors, the
    kernel's entry points recorded: the block's arguments packed once,
    then per active frame launch A, the coupling of its pair, launch B,
    with no graph; each call packs anew and couples anew, and a coupling
    that returns another tensor than the pair raises."""
    pp = params()[1]
    F, FL, n_act = pp.fft_size, 338, 3
    lay = detect_fast.plan(pp, FL)
    calls = []
    _record_kernel(monkeypatch, lay, FL, calls)

    def csum(x):
        calls.append(("sum", None))
        return x
    rng = dict(n_bins=FL, id_stride=4, bin_lo=-41, own_lo=0, own_hi=256)
    mag2 = torch.empty((pp.frames_per_block, FL), device="meta")
    s0 = st.init_state(pp, "meta", n_bins=FL)
    for _ in range(2):
        out = detect_fast.scan_fast_steps(mag2, s0, n_act * F, pp, csum,
                                          **rng)
        assert out is not s0
    loop = [(step, f) for f in range(n_act) for step in ("A", "sum", "B")]
    loop = [(c, None if c == "sum" else f) for c, f in loop]
    assert calls == 2 * ([("pack", None)] + loop)
    assert _RecordedGraph.replays == 0
    with pytest.raises(ValueError, match="in place"):
        detect_fast.scan_fast_steps(mag2, s0, n_act * F, pp,
                                    lambda x: x.clone(), **rng)


def test_graph_split_couples_once_a_frame_and_reuses_its_graphs(
        monkeypatch):
    """binshard's `run` (`make_scan_fast` with a coupling) over six blocks
    on meta tensors, the CUDA graphs recorded where the card captures
    them: the first block copies its state into the graphs' state buffer
    and captures the loop (the coupling once a frame, in frame order,
    between the frame's launches A and B); the next two replay it,
    updating the buffer they returned in place; a block with another
    count of active frames captures its own, the last two counts' graphs
    are kept, so a count seen before the last two captures anew. Every
    block is one replay, every result the one buffer, and neither the twin
    nor the one launch runs. A coupling that returns another tensor than
    the pair raises."""
    pp = params()[1]
    F, FL = pp.fft_size, 338
    lay = detect_fast.plan(pp, FL)
    calls = []
    _record_kernel(monkeypatch, lay, FL, calls)

    def never(*a, **k):
        raise AssertionError("the twin or the one launch ran")
    monkeypatch.setattr(detect_fast, "scan_fast_plain", never)
    monkeypatch.setattr(detect_fast, "scan_fast_kernel", never)

    def csum(x):
        calls.append(("sum", len([c for c in calls if c[0] == "sum"])))
        return x
    rng = dict(bin_lo=-41, own_lo=0, own_hi=256)
    run = detect_fast.make_scan_fast(pp, FL, coupling_sum=csum, id_stride=4)
    mag2 = torch.empty((pp.frames_per_block, FL), device="meta")
    s0 = s = st.init_state(pp, "meta", n_bins=FL)
    outs = []
    counts = (4, 4, 4, 3, 2, 4)
    for n_act in counts:
        s = run(mag2, s, n_act * F, **rng)
        outs.append(s)
    captured = (4, 3, 2, 4)
    want = []
    for n_act in captured:
        want += [("pack", None)] + [(step, f) for f in range(n_act)
                                    for step in ("A", "B")]
    assert [c for c in calls if c[0] != "sum"] == want
    sums = [("sum", k) for k in range(sum(captured))]
    assert [c for c in calls if c[0] == "sum"] == sums
    assert calls[1:4] == [("A", 0), ("sum", 0), ("B", 0)]
    assert _RecordedGraph.replays == len(counts)
    assert len(run.graphs._graphs) == detect_fast.SplitGraphs.MAX_KEPT
    # every result is the graphs' one state buffer, not the input
    assert all(o is outs[0] for o in outs) and outs[0] is not s0

    def other(x):
        return x.clone()
    with pytest.raises(ValueError, match="in place"):
        detect_fast.make_scan_fast(pp, FL, coupling_sum=other, id_stride=4)(
            mag2, st.init_state(pp, "meta", n_bins=FL), 4 * F, **rng)


def test_binshard_builds_the_coupled_loop():
    """The sharded pipeline's bin-split mode hands detect_fast its
    all_reduce as `coupling_sum`, so on the card it runs the kernel's
    split (the twin on the CPU); the replicated mode builds it without
    one (the one launch a block on the card)."""
    import inspect
    from iridium_tpu_torch.parallel import stream
    src = inspect.getsource(stream.ShardedPipeline._build_detect)
    assert "make_scan_fast(p)" in src
    assert "coupling_sum=self._all_sum" in src


def test_state_check_takes_what_init_state_makes():
    """`state.check`, which both kernel wrappers run before a launch: it
    takes init_state's tensors (local widths too) and refuses a wrong
    dtype, shape or layout."""
    p = _rate(1_000_000)
    st.check(st.init_state(p, CPU), p, CPU)
    st.check(st.init_state(p, CPU, n_bins=338), p, CPU, 338)
    with pytest.raises(ValueError, match="baseline_hist"):
        st.check(st.init_state(p, CPU, n_bins=338), p, CPU)
    bad = st.init_state(p, CPU)
    bad.a_valid = bad.a_valid.to(torch.int32)
    with pytest.raises(ValueError, match="a_valid: dtype"):
        st.check(bad, p, CPU)
    bad = st.init_state(p, CPU)
    bad.g_mag = bad.g_mag.to(torch.int32)
    with pytest.raises(ValueError, match="g_mag: dtype"):
        st.check(bad, p, CPU)
    bad = st.init_state(p, CPU)
    bad.baseline_hist = bad.baseline_hist.t().contiguous().t()
    with pytest.raises(ValueError, match="not contiguous"):
        st.check(bad, p, CPU)
    bad = st.init_state(p, CPU)
    bad.ints = bad.ints[:7]
    with pytest.raises(ValueError, match="ints: shape"):
        st.check(bad, p, CPU)
