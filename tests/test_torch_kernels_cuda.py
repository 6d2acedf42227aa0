"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Marked `cuda`: they skip without a CUDA device. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(chip_smoke.py holds the same kernels to the same tolerances at the
production shapes.) The last test holds the pipeline's group program,
replayed as a CUDA graph, to the same program run eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch import device as device_mod  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch import _kernels  # noqa: E402
from iridium_tpu_torch.dsp import demod, downmix  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan, state as st  # noqa: E402
from iridium_tpu_torch.ops import block_gather as bg  # noqa: E402
from iridium_tpu_torch.ops import filters  # noqa: E402
from iridium_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from iridium_tpu_torch.ops import window_gather as wg  # noqa: E402
from iridium_tpu_torch.tools import exp_demod, exp_downmix  # noqa: E402
from iridium_tpu_torch.tools import exp_frontend, exp_scan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # TF32 off for the plain versions' convolutions, as the port runs them
    return device_mod.resolve("cuda")


def _planes(n, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, n)).astype(
        np.float32)).to(dev)


# Window-gather cases (starts [tile, r]) on planes of N_GATHER samples,
# each at l_win ALIGN and 2 ALIGN; tests/test_torch_frontend.py holds the
# plain gather to the JAX package's gathers on the same cases.
N_GATHER = 4 * wg.ALIGN + 64          # windows at tile 3 run past the end
GATHER_CASES = {
    # every residue of r mod 4, so every shift of the aligned loads
    "residues": [[0, 0], [0, 1], [1, 2], [1, 3], [2, 4], [0, 5], [1, 6],
                 [2, 7]],
    # the shifts of decimations 50 and 100 (12.5 and 25 MHz)
    "shifts_40_to_99": [[0, 40], [1, 41], [1, 62], [1, 99], [0, 98],
                        [2, 43]],
    "duplicated_unsorted": [[2, 5], [0, 3], [2, 5], [1, 0], [0, 3],
                            [0, 3]],
    "past_the_end": [[3, 0], [3, 37], [3, 70], [3, 99]],
}


def _gather_cases():
    rng = np.random.default_rng(8)
    many = np.stack([rng.integers(-1, 4, 300), rng.integers(0, 100, 300)],
                    1).tolist()
    cases = [pytest.param(N_GATHER, s, l_win, id=f"{name}-{l_win}")
             for name, s in GATHER_CASES.items()
             for l_win in (wg.ALIGN, 2 * wg.ALIGN)]
    return cases + [
        pytest.param(3 * wg.ALIGN + 64,
                     [[0, 0], [0, 39], [1, 1], [2, 17], [2, 39]], wg.ALIGN,
                     id="decimation_40"),
        pytest.param(N_GATHER, [], wg.ALIGN, id="B0"),
        pytest.param(N_GATHER, [[1, 3]], wg.ALIGN, id="B1"),
        # not a multiple of a block's run of the window (2,048 samples)
        pytest.param(N_GATHER, [[0, 1], [2, 6], [1, 99], [3, 2]],
                     wg.ALIGN + 4 * 37, id="ragged_run"),
        pytest.param(N_GATHER, [[0, 2], [1, 3]], 4, id="l_win_4"),
        pytest.param(N_GATHER, [[-1, 3], [-1, 99], [-2, 0], [0, 0]],
                     wg.ALIGN, id="before_the_start"),
        # more windows than the rank kernel's block, starts repeated
        pytest.param(N_GATHER, many, wg.ALIGN, id="many_windows"),
    ]


@pytest.mark.parametrize("n,starts,l_win", _gather_cases())
def test_window_gather_bit_exact(dev, n, starts, l_win):
    planes = _planes(n, 1, dev)
    starts2 = torch.tensor(starts, dtype=torch.int32,
                           device=dev).reshape(-1, 2)
    got = wg.gather(planes, starts2, l_win)
    assert got[0].shape == (len(starts), l_win)
    for a, b in zip(got, wg.gather_plain(planes, starts2, l_win)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_slice", [1, 3])
def test_class_gather_in_slices_matches_whole_batch(dev, monkeypatch,
                                                    per_slice):
    """A gather-path class batch gathered, rotated and filtered in slices
    of windows (`pipeline.GATHER_BYTES`, which bounds the rotation's
    temporaries) on the card: one window-gather launch a slice, and within
    1e-5 of the whole batch at once (the convolution may pick another
    algorithm for another batch size)."""
    from iridium_tpu_torch.runtime import pipeline as pl
    pipe = pl.Pipeline(det_cfg=DetectorConfig(sample_rate=1_000_000),
                       device=dev, burst_batch=8)
    cls = pipe.classes[0]
    assert not cls.fused and cls.batch >= 8
    rng = np.random.default_rng(5)
    n = 4 * cls.l_win
    planes = _planes(n, 5, dev)
    starts2 = torch.from_numpy(np.stack([
        rng.integers(0, (n - cls.l_win) // wg.ALIGN, cls.batch),
        rng.integers(0, cls.decim, cls.batch)], 1).astype(np.int32)).to(dev)
    ks = torch.from_numpy(rng.integers(-500, 500, cls.batch).astype(
        np.int32)).to(dev)
    whole = cls._gather_rotate(planes, starts2, ks)
    monkeypatch.setattr(pl, "GATHER_BYTES", per_slice * 8 * cls.l_win)
    before = _kernels.WINDOW_GATHER.launches
    sliced = cls._gather_rotate(planes, starts2, ks)
    assert _kernels.WINDOW_GATHER.launches - before == \
        -(-cls.batch // per_slice)
    for a, b in zip(sliced, whole):
        assert float((a - b).abs().max()) <= 1e-5


def test_fused_frontend_matches_plain(dev):
    F, D, l_win = 512, 8, 2 * wg.ALIGN
    planes = _planes(l_win + 4 * wg.ALIGN, 2, dev)
    starts2 = torch.tensor([[0, 0], [1, 7], [2, 3], [3, 5]],
                           dtype=torch.int32, device=dev)
    ks = torch.tensor([5, -250, 0, 255], dtype=torch.int32, device=dev)
    taps = torch.from_numpy(filters.lpf_taps(
        1.0, 10_000_000.0, 100_000.0, 50_000.0)).to(dev)
    ramp = ff.ramp_table(F, dev)
    for a, b in zip(ff.fused(planes, starts2, ks, taps, ramp, l_win, D),
                    ff.fused_plain(planes, starts2, ks, taps, ramp, l_win,
                                   D)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("l_win", [327_680, 1_126_400])
def test_fused_frontend_production_taps_match_plain(dev, l_win):
    """F = 8192, decimation 40, the 801 production taps, at the small
    class's window and the large class's (n_out = 28,160): windows that
    start before sample 0 and end past the stream, r = 39, k = -F/2 and
    F/2 - 1, and a batch of 5 bursts."""
    F, D = 8192, 40
    n = l_win + 3 * wg.ALIGN + 1234
    planes = _planes(n, 4, dev)
    last = (n - l_win // 2) // wg.ALIGN          # runs past the end
    starts2 = torch.tensor([[-1, 39], [0, 0], [1, 39], [last, 17], [2, 5]],
                           dtype=torch.int32, device=dev)
    ks = torch.tensor([-F // 2, F // 2 - 1, 0, 1, -1], dtype=torch.int32,
                      device=dev)
    taps = torch.from_numpy(exp_frontend.production_taps()).to(dev)
    ramp = ff.ramp_table(F, dev)
    got = ff.fused(planes, starts2, ks, taps, ramp, l_win, D)
    want = ff.fused_plain(planes, starts2, ks, taps, ramp, l_win, D)
    assert got[0].shape == (5, l_win // D)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_fused_frontend_raises_on_what_it_cannot_take(dev):
    """No fallback on the card: a decimation the shape rules refuse, and
    taps so long that the span does not fit in shared memory."""
    planes = _planes(4 * wg.ALIGN, 5, dev)
    starts2 = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    ks = torch.zeros(2, dtype=torch.int32, device=dev)
    taps = torch.from_numpy(exp_frontend.production_taps()).to(dev)
    ramp = ff.ramp_table(8192, dev)
    with pytest.raises(ValueError):
        ff.fused(planes, starts2, ks, taps, ramp, wg.ALIGN, 12)
    long_taps = torch.full((4001,), 1.0 / 4001, device=dev)
    with pytest.raises(RuntimeError):
        ff.fused(planes, starts2, ks, long_taps, ramp, wg.ALIGN, 160)


@pytest.mark.parametrize("D", [16, 32, 80, 160])
def test_fused_frontend_other_decimations_match_plain(dev, D):
    """The other decimations the shape rules take (4, 8, 20 and 40 MHz
    captures), with the 801 production taps."""
    F, l_win = 8192, 2 * wg.ALIGN
    planes = _planes(l_win + 3 * wg.ALIGN + 5, 6 + D, dev)
    starts2 = torch.tensor([[-1, 7], [0, 3], [2, 1]], dtype=torch.int32,
                           device=dev)
    ks = torch.tensor([-F // 2, 17, F // 2 - 1], dtype=torch.int32,
                      device=dev)
    taps = torch.from_numpy(exp_frontend.production_taps()).to(dev)
    ramp = ff.ramp_table(F, dev)
    for a, b in zip(ff.fused(planes, starts2, ks, taps, ramp, l_win, D),
                    ff.fused_plain(planes, starts2, ks, taps, ramp, l_win,
                                   D)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_detect_scan_matches_plain(dev):
    p = DetectorConfig(sample_rate=1_000_000, history_size=64,
                       frames_per_block=256, max_new_per_frame=8,
                       gone_capacity=64, max_bursts=20).derived()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mag2 = torch.empty((256, p.fft_size), device=dev).exponential_(
        generator=gen)
    for f0, nf, b in [(70, 20, 200), (75, 120, 600), (90, 5, 900)]:
        mag2[f0:f0 + nf, b - 1:b + 2] += 500.0
    mag2[150:200, 20:1000:30] += 800.0           # trips the squelch
    s0 = st.init_state(p, dev)
    got = detect_scan.scan(mag2, s0, p.block_samples, p)
    want = detect_scan.scan_plain(mag2, s0, p.block_samples, p)
    for name in ("a_valid", "a_id", "a_start", "a_last", "mask_count",
                 "g_id", "g_start", "g_stop", "g_last", "g_bin", "ints",
                 "baseline_sum", "baseline_hist"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("g_mag", "g_noise", "a_mag", "a_noise", "floats"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, atol=0)
    assert int(got.g_count) >= 3


def test_detect_scan_edges_match_plain(dev):
    """F = 8192 (10 MHz): bursts across the bins where thread ownership
    changes, a burst kept alive by the dilation across such an edge, an
    exact tie across one (the lower bin wins) and a squelch blast."""
    p = DetectorConfig(sample_rate=10_000_000, history_size=64,
                       frames_per_block=256, max_new_per_frame=8,
                       gone_capacity=64, max_bursts=20).derived()
    mag2 = torch.from_numpy(exp_scan.edge_spectrogram(p, seed=11)).to(dev)
    s0 = st.init_state(p, dev)
    got = detect_scan.scan(mag2, s0, p.block_samples, p)
    want = detect_scan.scan_plain(mag2, s0, p.block_samples, p)
    exp_scan.compare(got, want)
    assert int(got.squelch_count) > 0 or int(got.n_tagged) > 20
    bins = set(got.g_bin[:int(got.g_count)].tolist()) | set(
        torch.nonzero(got.a_valid).flatten().tolist())
    assert 3071 in bins and 3072 not in bins


@pytest.mark.parametrize("R,nt", [(1, 8), (8, 16), (64, 128), (256, 512)])
def test_block_gather_bit_exact(dev, R, nt):
    mt, width = 700, 640
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 + R)
    sre = torch.randn((mt, width), device=dev, generator=gen)
    sim = torch.randn((mt, width), device=dev, generator=gen)
    # windows wholly inside, starting before row 0 (one wholly before it),
    # and running past the planes' end, whose outside rows read as 0
    st = torch.tensor([0, 1, (mt - nt) // R, mt // R, -1, -(nt // R),
                       (mt - 1) // R], dtype=torch.int32, device=dev)
    got = bg.block_gather(sre, sim, st, R, nt)
    want = bg.block_gather_plain(sre, sim, st, R, nt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_block_gather_wide_rows_bit_exact(dev):
    """Rows wider than the kernel's 8 KB copy chunk go in several chunks."""
    mt, width, R, nt = 40, 2500, 2, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    sre = torch.randn((mt, width), device=dev, generator=gen)
    sim = torch.randn((mt, width), device=dev, generator=gen)
    st = torch.tensor([0, 3, 17, -2, 19], dtype=torch.int32, device=dev)
    got = bg.block_gather(sre, sim, st, R, nt)
    want = bg.block_gather_plain(sre, sim, st, R, nt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_detect_scan_lone_long_burst_at_16k_matches_plain(dev):
    """F = 16384 (12 MHz: 16 bins a thread, history words read and written
    by the threads themselves): a burst across a thread edge, longer than
    max_burst_len and alone, so the frame of its deletion runs the forced
    noise update and then the final one."""
    p = DetectorConfig(sample_rate=12_000_000, history_size=64,
                       frames_per_block=192, max_new_per_frame=8,
                       gone_capacity=64).derived()
    assert p.fft_size == 16384 and detect_scan.supports(p)
    mag2 = torch.from_numpy(exp_scan.long_burst_spectrogram(p, seed=4)).to(
        dev)
    s0 = st.init_state(p, dev)
    got = detect_scan.scan(mag2, s0, p.block_samples, p)
    want = detect_scan.scan_plain(mag2, s0, p.block_samples, p)
    exp_scan.compare(got, want)
    assert int(got.g_count) >= 1 and int(got.primed) == p.history_size


def test_group_graph_replay_matches_eager_program(dev):
    """A 10 MHz capture with one burst through the pipeline on the card
    (blocks of 64 frames, two a group, so graphs of arity 2 and 1; the
    burst falls in the last group of two): the group program through each
    arity's graphs equals it run eagerly on the same inputs, bit for bit,
    and two runs through the graphs add twice the kernel launches their
    captures recorded."""
    from iridium_tpu_torch.io import synth
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    cfg = DetectorConfig(sample_rate=10_000_000, history_size=64,
                         frames_per_block=64, gone_capacity=64)
    bits = np.random.default_rng(3).integers(0, 2, 300).astype(np.uint8)
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=137_000.0, snr_db=30.0)
    pipe = Pipeline(det_cfg=cfg, burst_batch=4, group_jobs=2, agg_blocks=2,
                    device=dev, want_llr=False)
    frames = list(pipe.run_array(cap))
    exp = synth.expected_bits(bits, "DL")
    assert any(np.array_equal(np.asarray(f["bits"][:len(exp)]), exp)
               for f in frames)
    assert sorted(pipe.graphs) == [1, 2]
    small_normal = pipe.graphs[2].parts[1]
    assert small_normal.launches[_kernels.FUSED_FRONTEND] >= 1
    # the demod loop is one kernel node, not ~130 nodes a symbol
    assert small_normal.launches[_kernels.DEMOD_LOOP] == 1
    assert small_normal.nodes < 2000
    for nb, g in pipe.graphs.items():
        route = g.parts[0]
        skips = g.scal[1:].tolist()
        eager = pipe.group_program(g.planes, g.tables, g.scal, skips)
        before = {k: k.launches for k in _kernels.KERNELS}
        replayed = pipe.group_program(g.planes, g.tables, g.scal, skips, g)
        assert torch.equal(replayed, eager)
        pipe.group_program(g.planes, g.tables, g.scal, skips, g)
        counts = replayed[6 * nb:6 * nb + 3].tolist()
        used = [route] + [c for c, n, s in zip(g.parts[1:], counts, skips)
                          if n > s]
        for k in _kernels.KERNELS:
            assert k.launches - before[k] == 2 * sum(
                c.launches.get(k, 0) for c in used)


def _bursty_spectrogram(p, dev, seed):
    """(frames_per_block, F) |X|^2 on `dev`: noise, 3-bin bursts from 8
    frames after the history is primed (one past max_burst_len where the
    block is long enough) and a comb that trips the squelch."""
    F, n, t0 = p.fft_size, p.frames_per_block, min(p.history_size + 8,
                                                     p.frames_per_block // 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mag2 = torch.empty((n, F), device=dev).exponential_(generator=gen)
    long_frames = p.max_burst_len // F + 8
    for f0, nf, b in [(t0, 20, F // 5), (t0 + 3, long_frames, F // 3),
                      (t0 + 6, 4, F // 2 + 40), (t0 + 12, 30, 3 * F // 4)]:
        mag2[f0:f0 + nf, b - 1:b + 2] += 500.0
    step = p.burst_width_bins + 2
    comb = torch.arange(p.burst_width_bins, F - p.burst_width_bins, step,
                        device=dev)
    comb = comb[(comb - F // 2).abs() > 8]
    mag2[t0 + 40:t0 + 60, comb] += 800.0
    return mag2


@pytest.mark.parametrize("cfg", [
    dict(sample_rate=1_000_000, history_size=64, frames_per_block=100),
    dict(sample_rate=10_000_000, frames_per_block=1000),
    dict(sample_rate=10_000_000, history_size=16, frames_per_block=256)])
def test_detect_scan_chunk_shapes_match_plain(dev, cfg):
    """Shapes the Pallas scan's chunk rules refuse (frames_per_block 100
    and 1000, history_size 16): the kernel walks the frames one by one and
    equals the plain scan there, from a fresh state and from a primed
    one."""
    p = DetectorConfig(max_new_per_frame=8, max_bursts=20, **cfg).derived()
    assert detect_scan.supports(p)
    s = st.init_state(p, dev)
    for seed in (1, 2):
        mag2 = _bursty_spectrogram(p, dev, seed)
        got = detect_scan.scan(mag2, s, p.block_samples, p)
        want = detect_scan.scan_plain(mag2, s, p.block_samples, p)
        exp_scan.compare(got, want)
        s = want
        st.rebase_(s, p.block_samples)
    assert int(s.n_tagged) >= 3


@pytest.mark.parametrize("rate", [25_000_000, 50_000_000])
def test_detect_scan_cluster_matches_plain(dev, rate):
    """F = 32768 and 65536, the kernel as a cluster of 4 and 8 blocks of
    8192 bins: bit-equal to the plain scan on tools/exp_scan.py's
    cluster edge block (bursts beside the DC notch on the block edge at
    F / 2, a tie and a dilation across every other edge, a squelch blast
    with emission drops) and its long-burst block (forced, then final
    noise update); then over three blocks whose state goes from the kernel
    to the plain scan and back."""
    p = DetectorConfig(sample_rate=rate, history_size=32,
                       frames_per_block=128, max_bursts=20).derived()
    assert detect_scan.clusters(p.fft_size) == p.fft_size // 8192 > 1
    assert detect_scan.supports(p)
    nv = p.block_samples
    edge = torch.from_numpy(exp_scan.cluster_edge_spectrogram(p, seed=11))
    longb = torch.from_numpy(exp_scan.long_burst_spectrogram(p, seed=4))
    blocks = [edge.to(dev), _bursty_spectrogram(p, dev, 3), longb.to(dev)]
    s0 = st.init_state(p, dev)
    for mag2 in (blocks[0], blocks[2]):
        got = detect_scan.scan(mag2, s0, nv, p)
        exp_scan.compare(got, detect_scan.scan_plain(mag2, s0, nv, p))
    # the carry: chain a runs kernel, plain, kernel and chain b plain,
    # kernel, plain, each block from its own chain's state
    runs = (detect_scan.scan, detect_scan.scan_plain)
    s_a, s_b = s0, s0
    for k, mag2 in enumerate(blocks):
        got_a = runs[k % 2](mag2, s_a, nv, p)
        got_b = runs[1 - k % 2](mag2, s_b, nv, p)
        exp_scan.compare(got_a, got_b)
        if k == 0:
            assert int(got_a.burst_dropped) > 0
        s_a, s_b = got_a, got_b
        st.rebase_(s_a, nv)
        st.rebase_(s_b, nv)
    assert int(s_a.n_tagged) > 40


# (sample rate, fft_size): shapes the kernel took up with its layout
# function (`detect_scan.layout`): 1,152 (576 threads of 2 bins), 12,288
# and 20,480 (clusters of 2 and 4 blocks of 6,144 and 5,120 bins on 768
# and 640 threads), 16,384 (2 blocks of 8,192), 131,072 (16 blocks of
# 8,192, 100 MHz) and 262,144 (16 blocks of 16,384 bins, 16 a thread: the
# wide path, 200 MHz); then the grids of clusters of 16: 393,216 (3
# clusters of 8,192-bin blocks), 524,288 (400 MHz: 4 of them), 917,632 (4
# clusters of wide blocks of 14,352 bins on 928 threads, the last 31
# idle) and 1,048,576 (800 MHz: 4 clusters of wide blocks of 16,384)
NEW_SHAPES = [(1_000_000, 1152), (12_000_000, 12288), (20_000_000, 16384),
              (20_000_000, 20480), (100_000_000, 131072),
              (200_000_000, 262144), (300_000_000, 393216),
              (400_000_000, 524288), (700_000_000, 917632),
              (800_000_000, 1048576)]


@pytest.mark.parametrize("rate,F", NEW_SHAPES,
                         ids=[str(F) for _, F in NEW_SHAPES])
def test_detect_scan_new_shapes_match_plain(dev, rate, F):
    """Bit-equal to the plain scan (tests/test_torch_scan_shapes.py holds
    that to the Pallas scan) on `exp_scan.shape_edge_spectrogram`'s rows
    from a fresh state (bursts beside the DC notch, ties and dilations
    across the block edges, a burst by the last eligible bins, squelch
    drops), then on a bursty block (a long burst) from the state the
    first block left."""
    p = DetectorConfig(sample_rate=rate, fft_size=F, history_size=32,
                       frames_per_block=128, max_bursts=20).derived()
    assert detect_scan.resolve_impl(p) == "scan"
    nv = p.block_samples
    s = st.init_state(p, dev)
    edge = torch.from_numpy(exp_scan.shape_edge_spectrogram(p, seed=11))
    for k, mag2 in enumerate((edge.to(dev), _bursty_spectrogram(p, dev, 3))):
        before = _kernels.DETECT_SCAN.launches
        got = detect_scan.scan(mag2, s, nv, p)
        assert _kernels.DETECT_SCAN.launches == before + 1
        want = detect_scan.scan_plain(mag2, s, nv, p)
        exp_scan.compare(got, want)
        if k == 0:
            assert int(got.burst_dropped) > 0
        s = want
        st.rebase_(s, nv)
    assert int(s.n_tagged) > 40


def test_detect_scan_cluster_of_16_launch_attribute(dev):
    """A cluster of 16 blocks is above the portable size of 8: the launch
    sets cudaFuncAttributeNonPortableClusterSizeAllowed, with which the
    card holds at least one such cluster of the kernel's blocks (227 KB of
    shared memory each, one an SM); so do clusters of 2 to 8. At 400 and
    800 MHz it holds every cluster of the kernel's grid at once, and at 1.6
    and 3.2 GHz every cluster of the tiled grid (7 clusters of 16)."""
    for F in (32768, 65536, 131072, 262144):
        assert detect_scan.max_active_clusters(F) >= 1, F
    assert detect_scan.layout(262144)[0] == 16
    for F in (524288, 1048576):
        assert detect_scan.max_active_clusters(F) >= \
            detect_scan.grid_clusters(F) == 4, F
    for F in (2097152, 4194304):
        assert detect_scan.tiles(F) > 1
        assert detect_scan.max_active_clusters(F) >= \
            detect_scan.grid_clusters(F) == detect_scan.MAX_GRID, F


# tiled layouts (C, FB, T, BPT, N, K) at 131,072 bins, in place of the
# resident one: one cluster of 16 blocks of 2 tiles of 4,096 bins; 2
# clusters of 2 tiles of 2,048; 3 tiles of 2,816 bins a block, the last
# tile of the grid empty and the one before it short; 512 tiles of 16 bins
# (one live thread a tile), so that a mask window (half_bw 26 bins)
# reaches over more than one tile on either side
TILED_AT_131072 = [(16, 4096, 256, 16, 1, 2), (16, 2048, 128, 16, 2, 2),
                   (16, 2816, 192, 16, 1, 3), (16, 16, 32, 16, 1, 512)]


@pytest.mark.parametrize("lay", TILED_AT_131072,
                         ids=[f"N{n}K{k}FB{fb}"
                              for _, fb, _, _, n, k in TILED_AT_131072])
def test_detect_scan_tiled_matches_plain(dev, monkeypatch, lay):
    """The tiled kernel (the layout of every F above MAX_RESIDENT) at 100
    MHz with the layout forced to tiles: bit-equal to the plain scan on
    `exp_scan.cluster_edge_spectrogram`'s rows (a tie and a dilation
    across every tile edge, bursts beside the DC notch, the squelch comb)
    from a fresh state, then on a bursty block (a long burst: the forced
    noise update) from the state the first left."""
    p = DetectorConfig(sample_rate=100_000_000, history_size=16,
                       frames_per_block=128, max_bursts=20).derived()
    assert p.fft_size == 131072
    monkeypatch.setattr(detect_scan, "layout", lambda F: lay)
    nv = p.block_samples
    s = st.init_state(p, dev)
    edge = torch.from_numpy(exp_scan.cluster_edge_spectrogram(p, seed=11))
    for k, mag2 in enumerate((edge.to(dev), _bursty_spectrogram(p, dev, 3))):
        before = _kernels.DETECT_SCAN.launches
        got = detect_scan.scan(mag2, s, nv, p)
        assert _kernels.DETECT_SCAN.launches == before + 1
        want = detect_scan.scan_plain(mag2, s, nv, p)
        exp_scan.compare(got, want)
        if k == 0:
            assert int(got.burst_dropped) > 0
        s = want
        st.rebase_(s, nv)
    assert int(s.n_tagged) > 40


def test_detect_scan_refuses_what_it_cannot_take(dev, monkeypatch):
    """400 and 800 MHz (F = 524288 and 1048576) run on the kernel's grid of
    clusters, 1.6 GHz (F = 2097152) on its tiled grid: `auto` resolves
    each to the kernel, and at 1.6 GHz (16 frames, history 16) the kernel
    is bit-equal to the plain scan. A block of 2^31 samples (1.6 GHz at
    1,024 frames), past the kernel's int32 positions, resolves to
    detect_fast, and the kernel raises on it. A grid the card
    cannot hold at once (9 clusters of 16 blocks of one SM each: 144 SMs;
    8 clusters of 16 ring blocks: 128 blocks, which fit the SM count but
    not the placement of clusters) and a layout the C side refuses (a
    cluster of 32) raise before anything runs, and nothing runs in their
    place."""
    for rate in (400_000_000, 800_000_000, 1_600_000_000):
        p = DetectorConfig(sample_rate=rate, history_size=16,
                           frames_per_block=16, gone_capacity=64).derived()
        assert detect_scan.supports(p)
        assert detect_scan.resolve_impl(p) == "scan"
        assert detect_scan.resolve_impl(p, "scan") == "scan"
    big = p
    assert big.fft_size == 2097152 and detect_scan.tiles(big.fft_size) == 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    s = st.init_state(big, dev)
    before = _kernels.DETECT_SCAN.launches
    # a noise block that primes the history, then 3-bin bursts across the
    # first tile edge and the first block edge
    for k in range(2):
        mag2 = torch.empty((16, big.fft_size), device=dev).exponential_(
            generator=gen)
        if k:
            mag2[2:9, 9375:9378] += 500.0
            mag2[4:12, 2 * 9376 - 2:2 * 9376 + 1] += 500.0
        got = detect_scan.scan(mag2, s, big.block_samples, big)
        want = detect_scan.scan_plain(mag2, s, big.block_samples, big)
        exp_scan.compare(got, want)
        s = want
        st.rebase_(s, big.block_samples)
    assert _kernels.DETECT_SCAN.launches == before + 2
    assert int(got.n_tagged) + int(got.a_valid.sum()) >= 2
    del mag2, got, want, s
    wide = DetectorConfig(sample_rate=1_600_000_000, history_size=16,
                          gone_capacity=64).derived()
    assert wide.block_samples == 2**31 and not detect_scan.supports(wide)
    assert detect_scan.resolve_impl(wide) == "fast"
    before = _kernels.DETECT_SCAN.launches
    with pytest.raises(ValueError):
        detect_scan.scan(torch.ones((1, 1), device=dev),
                         st.init_state(big, dev), wide.block_samples, wide)
    q = DetectorConfig(sample_rate=800_000_000, history_size=16,
                       frames_per_block=16, gone_capacity=64).derived()
    F = q.fft_size
    # cudaErrorCooperativeLaunchTooLarge, by block count and by placement
    for lay in ((16, 7296, 480, 16, 9, 1), (16, 8192, 1024, 8, 8, 1)):
        monkeypatch.setattr(detect_scan, "layout", lambda F, lay=lay: lay)
        assert detect_scan.max_active_clusters(F) < lay[4], lay
        with pytest.raises(RuntimeError, match="CUDA error 720:"):
            detect_scan.scan(torch.ones((16, F), device=dev),
                             st.init_state(q, dev), q.block_samples, q)
    r = DetectorConfig(sample_rate=50_000_000, history_size=16,
                       frames_per_block=16, gone_capacity=64).derived()
    monkeypatch.setattr(detect_scan, "layout",
                        lambda F: (32, F // 32, 128, 16, 1, 1))
    with pytest.raises(RuntimeError):
        detect_scan.scan(torch.ones((16, r.fft_size), device=dev),
                         st.init_state(r, dev), r.block_samples, r)
    torch.cuda.synchronize()
    assert _kernels.DETECT_SCAN.launches == before


def _on(state, dev):
    return type(state)(**{f: getattr(state, f).to(dev)
                          for f in state.__dataclass_fields__})


def test_detect_fast_on_card_matches_cpu(dev):
    """detect_fast on the card and on the CPU on the same rows (two
    blocks): integer fields, baseline sums and history bit-equal, dB
    fields rtol 1e-5."""
    from iridium_tpu_torch.dsp import detect_fast
    p = DetectorConfig(sample_rate=1_000_000, history_size=64,
                       frames_per_block=256, max_new_per_frame=8,
                       max_bursts=20).derived()
    run = detect_fast.make_scan_fast(p)
    s_card, s_cpu = st.init_state(p, dev), st.init_state(p, "cpu")
    for seed in (3, 4):
        mag2 = _bursty_spectrogram(p, dev, seed)
        s_card = run(mag2, s_card, p.block_samples)
        s_cpu = run(mag2.cpu(), s_cpu, p.block_samples)
        exp_scan.compare(s_card, _on(s_cpu, dev))
        st.rebase_(s_card, p.block_samples)
        st.rebase_(s_cpu, p.block_samples)
    assert int(s_card.n_tagged) >= 3 and int(s_card.burst_dropped) >= 1


def _fast_both(p, mag2, s, n_valid, n_bins=None, id_stride=1, **rng):
    """The detect_fast kernel (one launch) and scan_fast_plain on the same
    inputs on the card: every field of the state bit-equal
    (`exp_fast.compare_bits`). Returns the kernel's state."""
    from iridium_tpu_torch.dsp import detect_fast
    from iridium_tpu_torch.tools import exp_fast
    before = _kernels.DETECT_FAST.launches
    got = detect_fast.make_scan_fast(p, n_bins, id_stride=id_stride)(
        mag2, s, n_valid, **rng)
    want = detect_fast.scan_fast_plain(mag2, s, n_valid, p, n_bins=n_bins,
                                       id_stride=id_stride, **rng)
    torch.cuda.synchronize()
    assert _kernels.DETECT_FAST.launches == before + 1
    cmp = exp_fast.compare_bits(got, want)
    assert cmp["bit_equal"], cmp
    return got


_FAST_1MHZ = dict(sample_rate=1_000_000, history_size=64,
                  frames_per_block=256, max_bursts=20)
FAST_CASES = [
    # id, config, valid frames of each block (None: all), (clusters, grid)
    ("one_block_clamp", dict(_FAST_1MHZ, max_new_per_frame=8), None,
     (1, False)),
    ("cluster4_25mhz", dict(sample_rate=25_000_000, history_size=32,
                            frames_per_block=128, max_bursts=20), None,
     (4, False)),
    ("cluster16_200mhz_bpt16", dict(sample_rate=200_000_000,
                                    history_size=16, frames_per_block=64,
                                    max_bursts=20), None, (16, False)),
    ("cluster8_50mhz", dict(sample_rate=50_000_000, history_size=16,
                            frames_per_block=64, max_bursts=20), None,
     (8, False)),
    ("grid_800mhz_bpt16", dict(sample_rate=800_000_000, history_size=4,
                               frames_per_block=16, gone_capacity=64,
                               max_bursts=20), None, (16, True)),
    ("grid_1600mhz_pairs", dict(sample_rate=1_600_000_000, history_size=4,
                                frames_per_block=16, gone_capacity=64,
                                max_bursts=20), None, (2, True)),
    ("grid_3200mhz_bpt32", dict(sample_rate=3_200_000_000, history_size=4,
                                frames_per_block=16, gone_capacity=64,
                                max_bursts=20), None, (2, True)),
    ("partial_block", _FAST_1MHZ, 150.5, (1, False)),
    ("max_bursts_0", dict(_FAST_1MHZ, max_bursts=0), None, (1, False)),
    ("small_gone_table", dict(_FAST_1MHZ, gone_capacity=8), None,
     (1, False)),
]


@pytest.mark.parametrize("cfg,frames,layout",
                         [c[1:] for c in FAST_CASES],
                         ids=[c[0] for c in FAST_CASES])
def test_detect_fast_kernel_bit_equal_to_twin(dev, cfg, frames, layout):
    """The detect_fast kernel against its twin on the card, bit for bit,
    on two blocks in a row with `rebase_` between them: one block,
    clusters of 4, 8 and 16 blocks (16 of 16 bins a thread at 262,144),
    grids of clusters (4 of 16 at 1,048,576 bins; 64 of 2 at 2,097,152
    and at 4,194,304, 32 bins a thread, 16 frames), n_valid ending
    mid-block, max_new_per_frame above 4 (clamped), max_bursts 0 (no
    squelch), a gone table of 8 rows that fills."""
    from iridium_tpu_torch.dsp import detect_fast
    p = DetectorConfig(**cfg).derived()
    lay = detect_fast.plan(p)
    assert (lay.clusters, lay.grid) == layout
    F = p.fft_size
    n_valid = (p.block_samples if frames is None else int(frames * F))
    s, gone = st.init_state(p, dev), []
    for seed in (1, 2):
        s = _fast_both(p, _bursty_spectrogram(p, dev, seed), s, n_valid)
        gone.append(int(s.g_count))
        st.rebase_(s, p.block_samples)
    assert int(s.n_tagged) >= 3
    if cfg.get("gone_capacity") == 8:
        assert int(s.n_tagged) > 8 and max(gone) == 8
    if cfg.get("max_bursts") == 0:
        assert int(s.squelch_count) == 0


def test_detect_fast_kernel_local_range(dev):
    """Rank 1 of a 4-way 10 MHz bin split (ownership, halos, id_stride 4)
    under the identity coupling, two blocks: the twin's state bit for bit;
    a cluster's range too (rank 0 of 2 at 25 MHz, from global bin -53, a
    width of 2 mod 4 bins: rows off 16-byte boundaries)."""
    for rate, n, r in ((10_000_000, 4, 1), (25_000_000, 2, 0)):
        p = DetectorConfig(sample_rate=rate, history_size=32,
                           frames_per_block=128, max_bursts=20).derived()
        F = p.fft_size
        own, halo = F // n, 2 * (p.burst_width_bins // 2) + 1
        FL = own + 2 * halo
        bin_lo = r * own - halo
        cols = torch.from_numpy((np.arange(FL) + bin_lo) % F).to(dev)
        s = st.init_state(p, dev, id_offset=r, n_bins=FL)
        for seed in (1, 2):
            mag2 = _bursty_spectrogram(p, dev, seed)[:, cols].contiguous()
            s = _fast_both(p, mag2, s, p.block_samples, n_bins=FL,
                           id_stride=n, bin_lo=bin_lo, own_lo=r * own,
                           own_hi=(r + 1) * own)
            st.rebase_(s, p.block_samples)
        assert int(s.n_tagged) >= 1


def test_detect_fast_binshard_runs_the_split_and_refusals_raise(
        dev, monkeypatch):
    """With a coupling_sum (binshard) `run` is the kernel's split replayed
    as one CUDA graph: per active frame launch A, the coupling of its pair
    (called while the graph is captured), launch B, each replay counting
    2 launches a frame, bit-equal to the twin under the same coupling; a
    plan the C side refuses raises before anything runs, for the one
    launch and for the split."""
    from iridium_tpu_torch.dsp import detect_fast
    from iridium_tpu_torch.tools import exp_fast
    p = DetectorConfig(**_FAST_1MHZ).derived()
    mag2 = _bursty_spectrogram(p, dev, 1)
    s = st.init_state(p, dev)
    n_act = detect_fast.active_frames(p, p.block_samples)
    sums = []

    def coupling(x):
        sums.append(_kernels.DETECT_FAST.launches)
        return x
    before = _kernels.DETECT_FAST.launches
    got = detect_fast.make_scan_fast(p, coupling_sum=coupling)(
        mag2, s, p.block_samples)
    torch.cuda.synchronize()
    assert _kernels.DETECT_FAST.launches == before + 2 * n_act
    # each coupling after the frame's launch A, before its launch B
    assert sums == [before + 2 * f + 1 for f in range(n_act)]
    want = detect_fast.scan_fast_plain(mag2, s, p.block_samples, p,
                                       coupling_sum=lambda x: x)
    cmp = exp_fast.compare_bits(got, want)
    assert cmp["bit_equal"], cmp
    good = detect_fast.plan(p)
    monkeypatch.setattr(detect_fast, "plan",
                        lambda *a: good._replace(threads=good.threads + 32))
    before = _kernels.DETECT_FAST.launches
    for kw in ({}, dict(coupling_sum=lambda x: x)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            detect_fast.make_scan_fast(p, **kw)(mag2, s, p.block_samples)
    torch.cuda.synchronize()
    assert _kernels.DETECT_FAST.launches == before


SPLIT_IDENTITY_CASES = [
    # id, config, binshard's world size (None: the whole band, no halos),
    # bins a thread
    ("one_block_clamp", FAST_CASES[0][1], None, 1),
    ("cluster4_25mhz", FAST_CASES[1][1], None, 8),
    ("cluster16_200mhz_bpt16", FAST_CASES[2][1], None, 16),
    ("range_1mhz_bpt2", _FAST_1MHZ, 1, 2),
    ("grid_800mhz_bpt16", FAST_CASES[4][1], None, 16),
]


@pytest.mark.parametrize("cfg,n,bpt", [c[1:] for c in SPLIT_IDENTITY_CASES],
                         ids=[c[0] for c in SPLIT_IDENTITY_CASES])
def test_detect_fast_split_identity_equals_one_launch(dev, cfg, n, bpt):
    """The split under the identity coupling, replayed as a CUDA graph,
    against the one-launch kernel, bit for bit, on two blocks in a row
    with `rebase_` between them (the second block's replay updates in
    place the state the first returned): one block (1 MHz), clusters (25
    MHz, 4 blocks; 200 MHz, 16 of 16 bins a thread), binshard's 1 MHz
    range at world size 1 (1,106 bins with its halos: one block of 2 bins
    a thread), and a grid of 4 clusters of 16 (800 MHz; its launches
    cooperative)."""
    from iridium_tpu_torch.dsp import detect_fast
    from iridium_tpu_torch.tools import exp_fast
    p = DetectorConfig(**cfg).derived()
    n_act = detect_fast.active_frames(p, p.block_samples)
    s, FL, rng, split = st.init_state(p, dev), None, {}, None
    for seed in (1, 2):
        mag2 = _bursty_spectrogram(p, dev, seed)
        if n is not None:
            (mag2, s0, rng), = exp_fast.bin_ranges(p, mag2, n)
            if FL is None:
                s, FL = s0, mag2.shape[1]
        assert detect_fast.plan(p, FL).bpt == bpt
        if split is None:
            split = detect_fast.make_scan_fast(
                p, FL, coupling_sum=exp_fast.identity, id_stride=n or 1)
        want = detect_fast.make_scan_fast(p, FL, id_stride=n or 1)(
            mag2, s, p.block_samples, **rng)
        before = _kernels.DETECT_FAST.launches
        got = split(mag2, s, p.block_samples, **rng)
        torch.cuda.synchronize()
        assert _kernels.DETECT_FAST.launches == before + 2 * n_act
        assert (got is s) == (seed == 2)
        cmp = exp_fast.compare_bits(got, want)
        assert cmp["bit_equal"], cmp
        s = got
        st.rebase_(s, p.block_samples)
    assert int(s.n_tagged) >= 3


def _coupled_ranges(dev, n=4):
    """binshard's n ranges of a 1 MHz block of 256 frames whose summed
    count squelches and whose long burst (range 1 of 4) forces the others'
    noise update through the coupling (`exp_fast.coupled_spectrogram`)."""
    from iridium_tpu_torch.tools import exp_fast
    p = DetectorConfig(**_FAST_1MHZ).derived()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ranges = exp_fast.bin_ranges(p, exp_fast.coupled_spectrogram(p, gen), n)
    return p, ranges, (p, ranges, p.block_samples, ranges[0][0].shape[1], n)


def test_detect_fast_split_lockstep_matches_threaded_twins(dev):
    """4 ranges of 338 bins, their splits in lockstep on the card with the
    pairs summed by a tensor add, eagerly and captured as one CUDA graph,
    against 4 twins in 4 threads coupled by a barrier sum: every range's
    state bit for bit."""
    from iridium_tpu_torch.tools import exp_fast
    p, ranges, args = _coupled_ranges(dev)
    got = exp_fast.lockstep(*args)
    graph = exp_fast.lockstep(*args, graph=True)
    want = exp_fast.barrier_twins(*args)
    for g, r, w in zip(got, graph, want):
        cmp = exp_fast.compare_bits(g, w)
        assert cmp["bit_equal"], cmp
        cmp = exp_fast.compare_bits(r, g)
        assert cmp["bit_equal"], cmp
    assert sum(int(g.n_tagged) for g in got) >= 8


def test_detect_fast_split_squelch_and_force_through_the_coupling(dev):
    """The coupling reaches the kernel's phase B: with the ranges' counts
    summed, squelch rows appear that no range alone makes; with the long
    burst's flag summed too, the ranges without one take its forced noise
    update (their noise sums differ from a coupling of the counts alone).
    Each coupling is held to the threaded twins under the same one."""
    from iridium_tpu_torch.tools import exp_fast
    p, ranges, args = _coupled_ranges(dev)

    def counts_only(pairs):
        return [torch.stack([q[0], t[1]])
                for q, t in zip(pairs, exp_fast.summed(pairs))]
    res = {}
    for name, mix in (("alone", list), ("counts", counts_only),
                      ("summed", exp_fast.summed)):
        got = exp_fast.lockstep(*args, mix=mix)
        for g, w in zip(got, exp_fast.barrier_twins(*args, mix=mix)):
            cmp = exp_fast.compare_bits(g, w)
            assert cmp["bit_equal"], (name, cmp)
        res[name] = got
    assert exp_fast.squelch_rows(res["alone"], p) == 0
    assert exp_fast.squelch_rows(res["summed"], p) > 0
    assert exp_fast.squelch_rows(res["counts"], p) > 0
    # range 1 holds the long burst; the others see it only when summed
    for r in (0, 2, 3):
        assert not torch.equal(res["counts"][r].baseline_sum,
                               res["summed"][r].baseline_sum), r


def test_native_ring_reused_across_blocks(dev, tmp_path):
    """Nine blocks through the reader's ring of N_BUFFERS (3) pinned
    buffers, each copied to the card behind a device delay: a buffer
    refilled before its copy ran would corrupt the blocks on the card."""
    from iridium_tpu_torch.io import native
    bs = 1 << 16
    raw = np.random.default_rng(9).standard_normal(
        2 * (9 * bs - 100)).astype(np.float32)
    path = tmp_path / "x.cf32"
    raw.tofile(path)
    on_card, ns = [], []
    assert native.N_BUFFERS < 9
    for block, n in native.read_blocks(str(path), bs, device=dev):
        assert block.is_pinned()
        torch.cuda._sleep(2_000_000)
        on_card.append(block.to(dev, non_blocking=True))
        ns.append(n)
    torch.cuda.synchronize()
    assert ns == [bs] * 8 + [bs - 100]
    got = torch.cat(on_card).cpu().numpy()
    want = np.zeros(9 * bs, np.complex64)
    want[:len(raw) // 2] = raw.view(np.complex64)
    np.testing.assert_array_equal(got, want)


def test_sharded_world_size_1_over_nccl_matches_single_card(dev, tmp_path):
    """The sharded pipeline in this process at world size 1 over NCCL, on a
    10 MHz capture with two bursts (blocks of 64 frames): replicated detect
    (the scan kernel, the fused front-end) gives the single card's lines,
    ids included; binshard detect (detect_fast's kernel split around its
    per-frame all_reduce) gives Pipeline(detect_impl="fast")'s with the ids
    masked.
    Then `--mesh` with more ranks than cards exits 2."""
    import re
    from iridium_tpu_torch import _kernels, cli
    from iridium_tpu_torch.io import synth
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.parallel import distributed
    from iridium_tpu_torch.parallel.stream import ShardedPipeline
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    cfg = DetectorConfig(sample_rate=10_000_000, history_size=64,
                         frames_per_block=64, gone_capacity=64)
    bits = np.random.default_rng(3).integers(0, 2, 300).astype(np.uint8)
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=137_000.0, snr_db=30.0)
    synth.add_burst(cap, synth.burst_waveform(bits, 10_000_000, -1.2e6),
                    len(cap) - 700_000, snr_db=28.0)
    t0 = 1_700_000_000_000_000_000

    def lines(pipe):
        printer = RawPrinter("t1")
        return sorted(printer.format(f) for f in pipe.run_array(cap))

    def strip(ls):
        return [re.sub(r"I:\d{11}", "I:-", x) for x in ls]

    kw = dict(burst_batch=4, start_time_ns=t0, want_llr=False)
    single = lines(Pipeline(det_cfg=cfg, device=dev, **kw))
    fast = lines(Pipeline(det_cfg=cfg, device=dev, detect_impl="fast", **kw))
    assert len(single) >= 2
    made = distributed.initialize(device="cuda")
    try:
        mesh = distributed.make_mesh()
        assert (mesh.n, mesh.device.type) == (1, "cuda")
        _kernels.reset_counts()
        sp = ShardedPipeline(cfg, mesh=mesh, **kw)
        assert lines(sp) == single
        assert _kernels.DETECT_SCAN.launches > 0
        assert _kernels.FUSED_FRONTEND.launches > 0
        assert sp.timing["collectives"] > 0
        sb = ShardedPipeline(cfg, mesh=mesh, detect_mode="binshard", **kw)
        before = _kernels.DETECT_FAST.launches
        assert strip(lines(sb)) == strip(fast)
        assert sb.timing["n_collectives"] > cfg.frames_per_block
        # binshard's detect_fast is the kernel's split, two launches a frame
        assert _kernels.DETECT_FAST.launches > before
    finally:
        if made:
            distributed.shutdown()
    path = tmp_path / "cap.cf32"
    np.ascontiguousarray(cap).view(np.float32).tofile(path)
    assert cli.main(["-f", str(path),
                     "--mesh", str(torch.cuda.device_count() + 1)]) == 2


def _demod_inputs(dev, B=37, L=1918, seed=41):
    x, n, direction = exp_demod.inputs(B, L, 10.0, seed=seed)
    return tuple(torch.from_numpy(v).to(dev) for v in (x, n, direction))


@pytest.mark.parametrize("use_gardner", [True, False],
                         ids=["gardner", "no_gardner"])
def test_demod_loop_matches_plain(dev, use_gardner):
    """The demod loop kernel against `loop_plain` on the card at B = 37,
    L = 1,918, S = 205 (the 10 MHz small-normal class's frame cap and
    symbols), lengths 0, 1, 3, 4 and L among them: valid equal, the output
    within 1e-4 of each burst's peak, the corrections within rtol 1e-4,
    atol 1e-5; Demod's ok, direction, n_symbols, confidence and bits equal
    and its float fields within rtol 1e-4, atol 1e-5 (`exp_demod`'s
    limits). One launch."""
    S = 205
    x, n, direction = _demod_inputs(dev)
    want = demod.loop_plain(x, n, 10.0, S, use_gardner)
    before = _kernels.DEMOD_LOOP.launches
    got = demod.loop(x, n, 10.0, S, use_gardner)
    torch.cuda.synchronize()
    assert _kernels.DEMOD_LOOP.launches == before + 1
    exp_demod.compare_loop(got, want)
    dm = demod.Demod(S, 10.0, use_gardner, dev)
    exp_demod.compare_demod(dm.decide(*got, direction),
                            dm.decide(*want, direction))


def test_demod_on_card_launches_the_kernel_only(dev, monkeypatch):
    """`Demod` on CUDA tensors launches the kernel once a call and never
    runs `loop_plain`; a tensor the kernel cannot take raises."""
    def refuse(*args):
        raise AssertionError("loop_plain ran on the card")
    x, n, direction = _demod_inputs(dev, B=5)
    monkeypatch.setattr(demod, "loop_plain", refuse)
    for use_gardner in (True, False):
        before = _kernels.DEMOD_LOOP.launches
        out = demod.Demod(205, 10.0, use_gardner, dev)(x, n.int(), direction)
        torch.cuda.synchronize()
        assert _kernels.DEMOD_LOOP.launches == before + 1
        assert out.bits.shape == (5, 410) and out.bits.device == x.device
    with pytest.raises(ValueError):
        demod.loop(x[:, ::2], n, 10.0, 205, True)
    with pytest.raises(ValueError):
        demod.loop(x, n.int(), 10.0, 205, True)


def _bit_equal(got, want) -> dict:
    res = exp_demod.compare_loop(got, want)
    assert res["bit_equal"], res
    return res


# (B, L, S): odd L (rows not 16-byte aligned), a row of exactly one ring and
# one just over (walked through a ring of 8,192 samples), a batch whose
# rings shrink to 2,048 samples (7 bursts a block, rows of 4,441 refilled
# slot by slot), B not a multiple of the plan's bursts a block, walks that
# end long before S
DEMOD_EDGES = [(37, 1917, 205), (5, 4441, 471), (3, demod.MAX_RING, 900),
               (3, demod.MAX_RING + 1, 900), (4000, 4441, 471),
               (133, 401, 40), (1030, 1918, 205), (9, 400, 200),
               (1, 4, 8)]


@pytest.mark.parametrize("use_gardner", [True, False],
                         ids=["gardner", "no_gardner"])
@pytest.mark.parametrize("B, L, S", DEMOD_EDGES)
def test_demod_loop_bit_equal_at_edges(dev, use_gardner, B, L, S):
    """The kernel bit-equal to `loop_plain` (output, flags, corrections)
    at its plan's edges; `exp_demod.inputs` gives lengths 0, 3, 4, L and
    1 to the first five bursts and the rest lengths in [L/4, L]."""
    x, n, _ = _demod_inputs(dev, B=B, L=L, seed=B + L)
    if B == 1:
        n[0] = L
    want = demod.loop_plain(x, n, 10.0, S, use_gardner)
    before = _kernels.DEMOD_LOOP.launches
    got = demod.loop(x, n, 10.0, S, use_gardner)
    torch.cuda.synchronize()
    assert _kernels.DEMOD_LOOP.launches == before + 1
    _bit_equal(got, want)


def test_demod_loop_unaligned_rows_and_lengths(dev):
    """Rows that start 8 bytes past a 16-byte boundary (a view one sample
    into its storage) and lengths 0, 1, 3, 4 and L on every burst, in
    both modes, bit-equal."""
    B, L, S = 40, 1001, 120
    x, n, _ = _demod_inputs(dev, B=B + 1, L=L, seed=7)
    flat = x.reshape(-1)[1:1 + B * L]
    xs = flat.view(B, L)
    assert xs.data_ptr() % 16 == 8
    ns = torch.tensor([0, 1, 3, 4, L] * (B // 5), device=dev)
    for use_gardner in (True, False):
        _bit_equal(demod.loop(xs, ns, 10.0, S, use_gardner),
                   demod.loop_plain(xs, ns, 10.0, S, use_gardner))


@pytest.mark.parametrize("use_gardner", [True, False],
                         ids=["gardner", "no_gardner"])
def test_demod_loop_in_a_cuda_graph(dev, use_gardner):
    """The kernel captured into a CUDA graph, one node, replayed twice on
    new inputs copied into the captured ones: bit-equal each time."""
    B, L, S = 37, 1918, 205
    x, n, _ = _demod_inputs(dev, B=B, L=L, seed=3)
    demod.loop(x, n, 10.0, S, use_gardner)        # loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        got = demod.loop(x, n, 10.0, S, use_gardner)
    # one node: the kernel
    assert _kernels.graph_nodes(g.raw_cuda_graph()) == 1
    g.instantiate()
    for seed in (11, 12):
        x2, n2, _ = _demod_inputs(dev, B=B, L=L, seed=seed)
        x.copy_(x2)
        n.copy_(n2)
        g.replay()
        torch.cuda.synchronize()
        _bit_equal(got, demod.loop_plain(x, n, 10.0, S, use_gardner))


def test_demod_loop_refuses_another_plan(dev):
    """The C entry refuses any plan but `demod.plan`'s."""
    x, n, _ = _demod_inputs(dev, B=5)
    p = demod.plan(5, x.shape[1], 205, True)
    out = torch.empty((5, 205, 2), device=dev)
    valid = torch.empty((5, 205), dtype=torch.uint8, device=dev)
    total = torch.empty(5, device=dev)
    k = _kernels
    for bad in (p._replace(bursts=p.bursts + 1), p._replace(ring=p.ring // 2),
                p._replace(chunk=p.chunk // 2), p._replace(threads=32)):
        with pytest.raises(RuntimeError):
            k.DEMOD_LOOP.launch(dev, k.ptr(x), x.shape[1], k.ptr(n), 5, 205,
                                10.0, 5.0, 10, 1, bad.bursts, bad.ring,
                                bad.chunk, bad.threads, k.ptr(out),
                                k.ptr(valid), k.ptr(total))


def _downmix_inputs(dev, B, L, seed):
    """`exp_downmix.inputs` on the card (x, xf, dec_len, shift_dec,
    frame_len, start, u, corr), with the downmix's taps."""
    return tuple(torch.from_numpy(v).to(dev) for v in exp_downmix.inputs(
        B, L, seed, exp_downmix.cfo_total())) + (exp_downmix.taps(dev),)


def _downmix_both(x, xf, dl, sd, fl, st, u, corr, t, fns):
    """(xd, filt, xr) of `fns` = (noise_box, frame_rrc) or their plain
    versions; stage 1 reads xf from start."""
    return fns[0](x, dl, sd, t["noise"], t["box"]) + (
        fns[1](xf, st, fl, u, corr, t["rrc"], exp_downmix.cfo_total()),)


KERNEL_FNS = (downmix.noise_box, downmix.frame_rrc)
PLAIN_FNS = (downmix.noise_box_plain, downmix.frame_rrc_plain)


# (B, L): the 10 MHz small-normal class (1,024 x 8,172), B = 1, B not a
# multiple of anything the grid uses, L odd (rows not 16-byte aligned), L
# under one tile, one tile exactly and one sample over, L shorter than the
# LPF and the box filter
DOWNMIX_EDGES = [(1024, 8172), (1, 8172), (37, 3001), (5, 1024), (3, 1025),
                 (7, 300), (4, 19), (3, 1)]


@pytest.mark.parametrize("B, L", DOWNMIX_EDGES)
def test_downmix_fir_bit_equal_to_plain(dev, B, L):
    """Both launches bit-equal to `noise_box_plain` and `frame_rrc_plain`
    (xd, filt, xr; torch.equal), on `exp_downmix.inputs`: lengths 0, 1,
    19, 20, 24, 25, 26 and L among dec_len and frame_len, shift_dec > 0
    and past dec_len; where the batch has the rows, a start past the row,
    a frame past the row's end, u at -+cfo_total / 2 and corr 0. Two
    launches."""
    args = _downmix_inputs(dev, B, L, seed=B + L)
    want = _downmix_both(*args, PLAIN_FNS)
    before = _kernels.DOWNMIX_FIR.launches
    got = _downmix_both(*args, KERNEL_FNS)
    torch.cuda.synchronize()
    assert _kernels.DOWNMIX_FIR.launches == before + 2
    res = exp_downmix.compare(got, want)
    assert res["bit_equal"], res


def test_downmix_fir_in_a_cuda_graph(dev):
    """Both launches captured into a CUDA graph (two nodes), replayed on
    new inputs copied into the captured ones: bit-equal each time."""
    B, L = 37, 3001
    args = _downmix_inputs(dev, B, L, seed=1)
    _downmix_both(*args, KERNEL_FNS)               # loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        got = _downmix_both(*args, KERNEL_FNS)
    assert _kernels.graph_nodes(g.raw_cuda_graph()) == 2
    g.instantiate()
    for seed in (2, 3):
        for a, b in zip(args[:8], _downmix_inputs(dev, B, L, seed)[:8]):
            a.copy_(b)
        g.replay()
        torch.cuda.synchronize()
        res = exp_downmix.compare(got, _downmix_both(*args, PLAIN_FNS))
        assert res["bit_equal"], res


def test_downmix_on_card_launches_the_kernel_only(dev, monkeypatch):
    """`Downmix` on CUDA tensors launches the kernel twice a call and never
    runs the plain versions or `fir_valid_small`, and gives the values it
    gives with them."""
    from iridium_tpu_torch.config import DownmixConfig
    p = DetectorConfig(sample_rate=10_000_000).derived()
    dm = downmix.Downmix(p, DownmixConfig().derived(p), 8172, 1918, dev)
    B = 6
    x, sd = (_downmix_inputs(dev, B, 8172, seed=5)[i] for i in (0, 3))
    ext = torch.tensor([0, 900, 4_000, 120_000, 200_000, 327_680],
                       dtype=torch.int32, device=dev)
    bins = torch.full((B,), p.fft_size // 2, dtype=torch.int32, device=dev)
    with monkeypatch.context() as m:
        for name in ("noise_box_plain", "frame_rrc_plain", "rrc_plain",
                     "fir_valid_small"):
            m.setattr(downmix, name, _refuse(name))
        before = _kernels.DOWNMIX_FIR.launches
        got = dm(x, ext, bins, sd.int())
        torch.cuda.synchronize()
        assert _kernels.DOWNMIX_FIR.launches == before + 2
    with monkeypatch.context() as m:
        m.setattr(downmix, "noise_box", downmix.noise_box_plain)
        m.setattr(downmix, "frame_rrc", downmix.frame_rrc_plain)
        want = dm(x, ext, bins, sd.int())
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def _refuse(name):
    def refuse(*args):
        raise AssertionError(f"{name} ran on the card")
    return refuse


def test_downmix_fir_refuses_what_it_cannot_take(dev):
    """The wrappers raise on a wrong dtype, device, shape or contiguity,
    on more than 64 taps and on a 2 cfo_total that is no power of two up
    to 2^24 (the C entry refuses them too)."""
    x, xf, dl, sd, fl, st, u, corr, t = _downmix_inputs(dev, 5, 300, seed=9)
    nb = lambda *a: downmix.noise_box(*a)  # noqa: E731
    good = (x, dl, sd, t["noise"], t["box"])
    bad = [
        (x.to(torch.complex128),) + good[1:],
        (x[:, ::2],) + good[1:],
        (x[None],) + good[1:],
        (x, dl.int(), sd, t["noise"], t["box"]),
        (x, dl[:4], sd, t["noise"], t["box"]),
        (x, dl.cpu(), sd, t["noise"], t["box"]),
        (x, dl, sd, t["noise"].double(), t["box"]),
        (x, dl, sd, t["noise"], torch.ones(65, device=dev)),
        (x, dl, sd, t["noise"][:0], t["box"]),
        (x, dl, sd, t["noise"], torch.ones(2, 4, device=dev)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            nb(*args)
    total = exp_downmix.cfo_total()
    good = (xf, st, fl, u, corr, t["rrc"], total)
    for i, v in [(0, xf.real.contiguous()), (2, fl.float()),
                 (1, st.int()), (3, u[:4]), (4, corr.double()),
                 (4, corr.cpu()), (5, torch.ones(65, device=dev)),
                 (5, t["rrc"][::2]), (6, 3000), (6, 0), (6, 1 << 24)]:
        with pytest.raises(ValueError):
            downmix.frame_rrc(*good[:i], v, *good[i + 1:])
    out = torch.empty_like(x)
    k = _kernels
    many = torch.ones(65, device=dev)
    for stage, n_a, n_b, tt in ((0, 65, 20, 0), (0, 25, 65, 0),
                                (1, 65, 0, 8192), (2, 25, 0, 8192),
                                (0, 0, 20, 0), (1, 51, 0, 6000),
                                (1, 51, 0, 0), (1, 51, 0, 1 << 25)):
        with pytest.raises(RuntimeError):
            k.DOWNMIX_FIR.launch(dev, stage, k.ptr(x), 5, 300, k.ptr(dl),
                                 k.ptr(sd), k.ptr(u), k.ptr(corr), tt,
                                 k.ptr(many), n_a, k.ptr(many), n_b,
                                 k.ptr(out), k.ptr(out))
