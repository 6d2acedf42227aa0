"""The scan kernel's grid of clusters (F > 262,144: 400-800 MHz) and its
tiled grid (F > 1,835,008: 1.6 GHz and up) on the CPU: its layout
(`detect_scan.layout`'s fifth and sixth fields, N clusters of 16 blocks
of K tiles) owns every bin once, and the port's 400 MHz Pipeline, whose scan
resolves to the kernel (`scan_plain` on the CPU), gives the JAX
Pipeline's RAW lines.

The JAX Pipeline on the CPU runs detect_fast, whose segment maxima place
same-frame secondary creations otherwise than the argmax walk; the
capture's bursts are single and far apart in bin and time, where the two
walks agree. RAW lines are equal field for field, the frequency within 1
Hz (`test_torch_pipeline.check_lines`); payload bits exact. The blocks
are short (16 frames of 524,288 bins, history 16) and the bursts' limits
shortened (max_burst_len 1.4 M samples, burst_post_len 1.6 M,
burst_pre_len 131,072: windows of 3.8 M samples against the derived 45 M)
so that memory stays small: the test peaks at ~5.3 GB resident, most of
it the JAX Pipeline's group program, which holds ~3.5 GB at this F even
on a capture with no burst.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

from test_torch_pipeline import T0, check_lines  # noqa: E402
from test_torch_scan_shapes import owners  # noqa: E402

# 400 MHz with short blocks and short bursts
WIDE = dict(sample_rate=400_000_000, frames_per_block=16, history_size=16,
            max_burst_len=1_400_000, burst_post_len=1_600_000,
            burst_pre_len=131_072, gone_capacity=64, max_new_per_frame=8)


@pytest.mark.parametrize("F", [262272, 270336, 393216, 524288, 917504,
                               917632, 1048576, 1835008, 1835136, 2097152,
                               3000064, 4194304])
def test_grid_layout_gives_every_bin_one_thread(F):
    """Above one cluster: N clusters of 16 blocks, of at most 8,192 bins
    (8 a thread) up to 7 clusters (917,504), of at most 16,384 (16 a
    thread) above, up to MAX_RESIDENT; above it (1,835,136: the first F
    above; 1.6 GHz; 3,000,064; 3.2 GHz) 7 clusters of 16 blocks of K >= 2
    tiles of at most 16,384 bins, 16 a thread. Walked thread by thread,
    every bin is one thread's, every block and every tile holds bins, a
    block's tiles are contiguous and ascending, and the tiles' edges fall
    where the layout says."""
    C, FB, T, BPT, N, K = detect_scan.layout(F)
    assert C == 16 and 3 <= N <= detect_scan.MAX_GRID
    assert (K > 1) == (F > detect_scan.MAX_RESIDENT)
    assert K == 1 or (N == detect_scan.MAX_GRID and BPT == 16
                      and FB <= detect_scan.BLOCK_BINS
                      and K == -(-F // detect_scan.MAX_RESIDENT))
    if K == 1:
        assert (BPT, FB <= 8192) == ((8, True) if F <= 917504
                                     else (16, False))
    assert T % 32 == 0 and FB <= T * BPT < FB + 32 * BPT
    own = owners(F)
    assert (own >= 0).all()
    assert sorted(set(own[:, 0])) == list(range(N * C))
    assert sorted(set(own[:, 2])) == list(range(N * C * K))
    # bins ascend with the tile, and a block's tiles are its K in a row
    assert (np.diff(own[:, 2]) >= 0).all()
    assert (own[:, 2] // K == own[:, 0]).all()
    assert detect_scan.block_edges(F) == [t * FB for t in range(1, N * C * K)]
    assert detect_scan.grid_clusters(F) == N and detect_scan.tiles(F) == K
    assert detect_scan.grid_words(detect_scan.layout(F)) == \
        32 + 8 * N + N * C * K + (N * C * K * FB + 1) // 2
    assert detect_scan.tile_words(detect_scan.layout(F)) == \
        (4 * N * C * K * T if K > 1 else 1)


def test_grid_layouts_at_400_and_800_mhz():
    """400 MHz: 4 clusters of 16 ring blocks of 8,192 bins; 800 MHz: 4
    clusters of 16 wide blocks of 16,384; one cluster below; above
    MAX_RESIDENT (7 clusters of 16 wide blocks) the tiled grid: 1.6 GHz 7
    clusters of 16 blocks of 2 tiles of 9,376 bins (608 threads), 3.2 GHz
    of 3 tiles of 12,496 (800 threads)."""
    assert detect_scan.layout(524288) == (16, 8192, 1024, 8, 4, 1)
    assert detect_scan.layout(1048576) == (16, 16384, 1024, 16, 4, 1)
    assert detect_scan.layout(262144) == (16, 16384, 1024, 16, 1, 1)
    assert detect_scan.MAX_RESIDENT == 7 * 16 * 16384
    assert detect_scan.grid_words(detect_scan.layout(262144)) == 1
    assert detect_scan.layout(detect_scan.MAX_RESIDENT) == \
        (16, 16384, 1024, 16, 7, 1)
    assert detect_scan.layout(2097152) == (16, 9376, 608, 16, 7, 2)
    assert detect_scan.layout(4194304) == (16, 12496, 800, 16, 7, 3)


def wideband_capture(p, seed=5):
    """Three blocks of 400 MHz noise with three DL bursts of 100-bit
    payloads after the detector's priming (the first block), far apart in
    bin (-150, +0.137 and +120 MHz) and in time, the second across the
    boundary of blocks 2 and 3, at 0-3 dB a sample (~25 dB after the
    input filter and the decimation by 1,600; at 10 dB or more the skirt
    of the straddling burst 27 bins from its peak passes the threshold in
    its first frame: a same-frame secondary creation, where the two walks
    differ). Returns the capture and the payloads."""
    rng = np.random.default_rng(seed)
    block = p.block_samples
    # synth.noise's unit-variance planes, made in f32 (no complex128 copy)
    cap = rng.standard_normal(6 * block, dtype=np.float32).view(np.complex64)
    cap *= np.float32(0.01 / np.sqrt(2))
    plan = [(block + block // 5, -150e6), (2 * block - 900_000, 137_000.0),
            (2 * block + block // 2, 120e6)]
    bursts = []
    for start, off in plan:
        bits = rng.integers(0, 2, 108).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, p.sample_rate, off),
                        start, snr_db=float(rng.uniform(0.0, 3.0)))
        bursts.append(bits[:100])
    return cap, bursts


def test_400mhz_pipeline_matches_jax():
    """The port's Pipeline at 400 MHz (F = 524,288, decimation 1,600: the
    window-gather path) resolves its scan to the kernel and, on the CPU,
    gives the JAX Pipeline's RAW lines, every payload bit-exact."""
    p = DetectorConfig(**WIDE).derived()
    assert p.fft_size == 524288
    cap, bursts = wideband_capture(p)
    kw = dict(burst_batch=4, group_jobs=1, agg_blocks=4, start_time_ns=T0)
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**WIDE), **kw)
    jframes = list(jpipe.run_array(cap))
    want = [JaxRawPrinter().format(f) for f in jframes]
    pipe = Pipeline(det_cfg=DetectorConfig(**WIDE), device="cpu", **kw)
    assert pipe.detect_impl == "scan"
    assert not any(c.fused for c in pipe.classes)
    frames = list(pipe.run_array(cap))
    check_lines([RawPrinter().format(f) for f in frames], want)
    assert len(frames) == len(bursts)
    for f, jf in zip(frames, jframes):
        np.testing.assert_array_equal(f["bits"], jf["bits"])
    for bits in bursts:
        exp = synth.expected_bits(bits, "DL")
        assert any(np.array_equal(np.asarray(f["bits"])[:len(exp)], exp)
                   for f in frames)
    assert pipe.stats.n_detected == jpipe.stats.n_detected
    assert pipe.stats.n_ok == jpipe.stats.n_ok

