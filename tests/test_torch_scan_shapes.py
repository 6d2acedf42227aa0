"""The scan kernel's layout at every shape it takes, and the plain scan
(iridium_tpu_torch/dsp/detect_scan.py `scan_plain`, which the card tests
hold the kernel to bit for bit) against the JAX package's Pallas scan in
interpret mode at the shapes the kernel took up last: 1,152 in one block
(576 threads of 2 bins), 12,288 and 20,480 as clusters of 2 and 4 blocks
of 6,144 and 5,120 bins (768 and 640 threads of 8), 131,072 (100 MHz) as
a cluster of 16 blocks of 8,192, and 524,288 (400 MHz) as a grid of 4
such clusters.

Both scans get the same |X|^2 rows, so the comparison isolates the state
machine; the tolerances are `check_states`' (test_torch_detect_scan.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iridium_tpu.dsp import detect_fast  # noqa: E402
from iridium_tpu_torch import convert  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan, state as st  # noqa: E402
from iridium_tpu_torch.tools import exp_scan  # noqa: E402

from test_torch_detect_scan import (CPU, check_states,  # noqa: E402
                                    jax_state_dict, pallas_scan, params)

POW2 = {1 << k for k in range(7, 19)}


def owners(F: int) -> np.ndarray:
    """(F, 3) [block, thread, tile] of every bin under `layout(F)`, walked
    from the threads' side: each thread of each block (of every cluster
    of the grid) lists its BPT bins of each of the block's K tiles (tile
    counted across the grid)."""
    C, FB, T, BPT, N, K = detect_scan.layout(F)
    own = np.full((F, 3), -1)
    for r in range(N * C):
        for t in range(r * K, (r + 1) * K):
            lo, hi = t * FB, min((t + 1) * FB, F)
            for i in range(T):
                b0 = lo + i * BPT
                if b0 >= hi:
                    continue
                assert b0 + BPT <= hi, (F, r, t, i)
                assert (own[b0:b0 + BPT] == -1).all(), (F, r, t, i)
                own[b0:b0 + BPT] = (r, i, t)
    return own


def test_layout_at_every_multiple_of_128():
    """Every F = 128 k up to MAX_RESIDENT (1,835,008): C in {1, 2, 4, 8, 16} (a
    cluster only above 8,192 bins: blocks of at most 8,192 bins, 8 a
    thread, up to 131,072; above it 16 blocks of 16 bins a thread; above
    262,144 a grid of N = 3-7 clusters of 16 blocks, of 8 bins a thread up
    to 917,504 and of 16 above), whole warps of at most 1,024 threads,
    fewer than a warp of them idle, and the blocks' bins covering [0, F)
    with none left empty. (Whether a block's shared memory fits is the C
    entry's check; the card tests launch the largest layouts.)"""
    for F in range(128, detect_scan.MAX_RESIDENT + 1, 128):
        C, FB, T, BPT, N, K = detect_scan.layout(F)
        assert K == 1, F
        assert C in (1, 2, 4, 8, 16) and (C == 1) == (F <= 8192), F
        assert (N > 1) == (F > 262144) and N <= detect_scan.MAX_GRID, F
        assert N == 1 or C == 16, F
        assert BPT in (1, 2, 4, 8, 16), F
        assert C == 1 or BPT == (8 if F <= 131072 or 262144 < F <= 917504
                                 else 16), F
        assert BPT == 16 or FB <= detect_scan.RING_BINS, F
        assert T % 32 == 0 and 32 <= T <= 1024, F
        assert FB % BPT == 0 and FB <= T * BPT < FB + 32 * BPT, F
        assert N * C * FB >= F > (N * C - 1) * FB, F
        if F in POW2 and 1024 <= F <= 8192:
            # the power-of-two sizes keep 1,024 threads (10 MHz: 8 bins)
            assert (C, T, BPT) == (1, 1024, F // 1024)
    assert detect_scan.layout(16384) == (2, 8192, 1024, 8, 1, 1)
    assert detect_scan.layout(32768) == (4, 8192, 1024, 8, 1, 1)
    assert detect_scan.layout(65536) == (8, 8192, 1024, 8, 1, 1)
    assert detect_scan.layout(131072) == (16, 8192, 1024, 8, 1, 1)
    assert detect_scan.layout(262144) == (16, 16384, 1024, 16, 1, 1)
    assert detect_scan.layout(524288) == (16, 8192, 1024, 8, 4, 1)
    assert detect_scan.layout(1048576) == (16, 16384, 1024, 16, 4, 1)
    assert detect_scan.tiles(detect_scan.MAX_RESIDENT + 128) == 2
    for F in (0, 100, 1000, detect_scan.MAX_RESIDENT + 64):
        with pytest.raises(ValueError):
            detect_scan.layout(F)


@pytest.mark.parametrize("F", [1152, 3072, 4224, 12288, 20480, 24576,
                               16512, 131072, 262016, 262144])
def test_layout_gives_every_bin_one_thread(F):
    """Walked thread by thread, the layout owns each bin exactly once: the
    odd sizes of the configurations, a cluster whose blocks end in idle
    threads (16,512: 4 blocks of 4,128 bins on 544 threads of 8) and one
    whose last block is short (262,016: 15 blocks of 16,384 and one of
    16,256)."""
    own = owners(F)
    assert (own >= 0).all()
    C, FB, T, BPT, N, K = detect_scan.layout(F)
    assert N == K == 1
    assert detect_scan.block_edges(F) == [r * FB for r in range(1, C)]
    assert sorted(set(own[:, 0])) == list(range(C))


@pytest.mark.parametrize("rate,F,frames", [
    (1_000_000, 1152, 128), (12_000_000, 12288, 128),
    (20_000_000, 20480, 128), (100_000_000, 131072, 128),
    (400_000_000, 524288, 128)])
def test_new_shapes_match_pallas(rate, F, frames):
    """The plain scan against the Pallas scan on
    `exp_scan.shape_edge_spectrogram`'s rows: bursts beside the DC notch
    (the mask of one holds the other back until its release), a tie and a
    dilation across a thread edge or, in a cluster, across every block
    edge (at 524,288 the DC edge and two others are cluster edges of the
    grid), a burst by the last eligible bins, and a squelch comb with
    emission drops (the plain scan and the Pallas scan drop the same).
    (128 frames: the rows need 80 after the 32-row history is primed. A
    grid's 63 block edges hold 65 bursts at once, which max_bursts 20
    would squelch before the DC pair is emitted: there it is 100, which
    the comb still trips.)"""
    jp, pp = params(sample_rate=rate, fft_size=F, history_size=32,
                    frames_per_block=frames,
                    max_bursts=20 if F <= 262144 else 100)
    assert pp.fft_size == jp.fft_size == F and detect_scan.supports(pp)
    assert detect_scan.resolve_impl(pp) == "scan"
    mag2 = exp_scan.shape_edge_spectrogram(pp, seed=11)
    sj = pallas_scan(jp)(jnp.asarray(mag2), detect_fast.init_state(jp),
                         jnp.int32(jp.block_samples))
    sp = detect_scan.scan(torch.from_numpy(mag2), st.init_state(pp, CPU),
                          pp.block_samples, pp)
    got = convert.state_to_numpy(sp)
    check_states(got, jax_state_dict(sj))
    bins = got["g_bin"][:int(got["g_count"])].tolist()
    dc = F // 2
    low = [i for i, b in enumerate(bins) if dc - 6 <= b < dc - 3]
    high = [i for i, b in enumerate(bins) if dc + 3 < b <= dc + 6]
    assert low and high
    assert got["g_start"][high[0]] + pp.burst_pre_len >= \
        got["g_stop"][low[0]]
    # the lower bin of each edge's tie wins; the ties at all edges end in
    # one frame, whose emissions stop at E_DEL (the rest are dropped)
    edges = [e for e in detect_scan.block_edges(F) if e != dc]
    assert not any(e in bins for e in edges)
    assert sum(e - 1 in bins for e in edges) >= min(len(edges), st.E_DEL)
    assert int(got["burst_dropped"]) > 0
