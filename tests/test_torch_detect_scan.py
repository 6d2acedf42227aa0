"""The port's detector scan (iridium_tpu_torch/dsp/detect_scan.py) against
the JAX package's Pallas scan (iridium_tpu/dsp/detect_pallas.py, in
interpret mode on the CPU), on the scenarios of test_detect_pallas.py.

Both scans get the SAME |X|^2 rows (computed once with JAX), so the
comparison isolates the state machine: ids, starts, stops, lasts, bins
and counters exact; mag/noise dB rtol 1e-5 (log10 differs in the last
ulp between libraries); baseline_sum rtol 1e-6 (the update order is the
same, so it is bit-equal in practice). The detect step (window + FFT +
|X|^2) is compared separately, where two FFT libraries sum differently.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iridium_tpu.dsp import detect, detect_fast, detect_pallas  # noqa: E402
from iridium_tpu.ops import windows as jwindows  # noqa: E402
from iridium_tpu_torch import convert  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan, state as st  # noqa: E402
from iridium_tpu_torch.tools import exp_scan  # noqa: E402

from test_detect import tone_capture  # noqa: E402

CPU = torch.device("cpu")
SMALL = dict(sample_rate=1_000_000, history_size=64, frames_per_block=256,
             burst_capacity=32, max_new_per_frame=8, gone_capacity=64)


def params(**kw):
    """(JAX params, port params) of test_detect.small_params."""
    from iridium_tpu.config import DetectorConfig as JaxConfig
    cfg = dict(SMALL, **kw)
    return JaxConfig(**cfg).derived(), DetectorConfig(**cfg).derived()


@functools.lru_cache(maxsize=None)
def pallas_scan(p):
    return detect_pallas.make_scan_pallas(p, interpret=True)


def spectrogram(p, block):
    F = p.fft_size
    window = jwindows.blackman(F) / np.float32(0.42)
    frames = jnp.asarray(block[:p.frames_per_block * F]).reshape(-1, F)
    spec = jnp.fft.fft(frames * jnp.asarray(window)[None, :])
    return np.asarray(jnp.fft.fftshift(
        (jnp.abs(spec) ** 2).astype(jnp.float32), axes=-1))


def jax_state_dict(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def check_states(got: dict, want: dict, bsum_rtol=1e-6, hist_atol=0.0):
    """got/want: FastState-named numpy dicts (`want` as the JAX scan
    returns it; `got` oldest-first)."""
    n = int(want["g_count"])
    assert int(got["g_count"]) == n
    for k in ("g_id", "g_start", "g_stop", "g_last", "g_bin"):
        np.testing.assert_array_equal(got[k][:n], want[k][:n], err_msg=k)
    for k in ("g_mag", "g_noise", "a_mag", "a_noise"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("a_valid", "a_id", "a_start", "a_last", "mask_count",
              "primed", "burst_id", "squelch_count", "n_tagged",
              "burst_dropped", "create_waits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["baseline_sum"], want["baseline_sum"],
                               rtol=bsum_rtol)
    np.testing.assert_allclose(np.roll(want["baseline_hist"],
                                       -int(want["hist_idx"]), axis=0),
                               got["baseline_hist"], rtol=bsum_rtol,
                               atol=hist_atol)
    np.testing.assert_allclose(got["peak_signal_db"],
                               want["peak_signal_db"], rtol=1e-5)


def run_both(jp, pp, x, n_blocks=1, n_valid=None):
    """Block by block through both scans on the same |X|^2; compares the
    full states after every block. Returns the port's gone rows (absolute
    sample indices) and its final state."""
    run = pallas_scan(jp)
    sj = detect_fast.init_state(jp)
    sp = st.init_state(pp, CPU)
    rows = []
    for k in range(n_blocks):
        block = x[k * jp.block_samples:(k + 1) * jp.block_samples]
        nv = len(block) if n_valid is None else n_valid
        mag2 = spectrogram(jp, block)
        sj = run(jnp.asarray(mag2), sj, jnp.int32(nv))
        sp = detect_scan.scan(torch.from_numpy(mag2), sp, nv, pp)
        got = convert.state_to_numpy(sp)
        check_states(got, jax_state_dict(sj))
        base = k * jp.block_samples
        for i in range(int(got["g_count"])):
            rows.append(dict(id=int(got["g_id"][i]),
                             start=int(got["g_start"][i]) + base,
                             stop=int(got["g_stop"][i]) + base,
                             bin=int(got["g_bin"][i])))
        sj = detect.rebase_state(sj, jp.block_samples)
        st.rebase_(sp, pp.block_samples)
    return rows, sp


def test_multi_burst():
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.085, 0.030, -200_000.0, 0.08),
                          (0.12, 0.008, 300_000.0, 0.04),
                          (0.13, 0.015, 99_000.0, 0.06)])
    rows, _ = run_both(jp, pp, x)
    assert len(rows) == 4


def test_multiblock_carry():
    jp, pp = params()
    x = tone_capture(jp, [(0.10, 0.02, 150_000.0, 0.05),
                          (0.255, 0.02, -150_000.0, 0.05),
                          (0.30, 0.01, 250_000.0, 0.05)], n_blocks=2)
    rows, _ = run_both(jp, pp, x, n_blocks=2)
    assert len(rows) == 3


def test_long_burst():
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.15, 50_000.0, 0.05)])
    rows, _ = run_both(jp, pp, x)
    assert len(rows) >= 2          # split at max_burst_len


def test_squelch():
    jp, pp = params(max_bursts=4, max_new_per_frame=4)
    n = jp.block_samples
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * np.float32(0.01 / np.sqrt(2))
    i0 = int(0.1 * jp.sample_rate)
    x[i0:i0 + 20000] += (0.5 * (rng.standard_normal(20000)
                                + 1j * rng.standard_normal(20000))
                         ).astype(np.complex64)
    run_both(jp, pp, x)


def test_squelch_overflow_drop_accounting():
    jp, pp = params(max_bursts=20, max_new_per_frame=8, burst_capacity=64)
    bw_hz = jp.sample_rate / jp.fft_size
    t_blast, t_end = 0.16, 0.165
    events = []
    for i in range(20):
        f = -420_000.0 + i * 42_000.0
        if abs(f) < 5 * bw_hz:
            f += 6 * bw_hz
        events.append((0.10 + 0.002 * i, t_end - (0.10 + 0.002 * i),
                       f, 0.06))
    for i in range(4):
        events.append((t_blast, t_end - t_blast,
                       431_000.0 + i * 12_000.0, 0.06))
    x = tone_capture(jp, events)
    rows, sp = run_both(jp, pp, x)
    assert int(sp.n_tagged) - len(rows) >= 4
    assert int(sp.burst_dropped) >= 4


def test_mass_deletion_mask_release():
    jp, pp = params(max_new_per_frame=8, burst_capacity=64)
    freqs = [-300_000.0 + i * 52_000.0 for i in range(12)]
    freqs = [f if abs(f) > 8_000 else f + 26_000.0 for f in freqs]
    wave1 = [(0.10 + 0.002 * i, 0.160 - (0.10 + 0.002 * i), f, 0.06)
             for i, f in enumerate(freqs)]
    wave2 = [(0.22 + 0.002 * i, 0.020, f, 0.06)
             for i, f in enumerate(freqs)]
    x = tone_capture(jp, wave1 + wave2, n_blocks=2)
    rows, _ = run_both(jp, pp, x, n_blocks=2)
    w1_end = int(0.165 * jp.sample_rate)
    assert len([r for r in rows if r["start"] > w1_end]) >= 12


def test_eof_partial_block():
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.12, 0.015, -200_000.0, 0.06)])
    n_valid = int(0.60 * jp.block_samples)
    xb = np.concatenate([x[:n_valid],
                         np.zeros(jp.block_samples - n_valid,
                                  np.complex64)])
    rows, _ = run_both(jp, pp, xb, n_valid=n_valid)
    assert len(rows) >= 1


def test_detect_step_matches_pallas_detect_block():
    """Window + FFT + |X|^2 + fftshift + scan, each package end to end.
    The FFTs differ in summation order: baseline_sum gets rtol 1e-5, and
    the history rows an absolute 1e-6 (bins near zero carry the FFT's
    absolute error, ~4e-9 here, as a large relative one)."""
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.12, 0.015, -200_000.0, 0.06)])
    det = detect_pallas.make_detect_block_pallas(jp, interpret=True)
    sj = det(jnp.asarray(x), detect_fast.init_state(jp), jnp.int32(len(x)))
    sp = detect_scan.detect_block(torch.from_numpy(x),
                                  st.init_state(pp, CPU), len(x), pp)
    check_states(convert.state_to_numpy(sp), jax_state_dict(sj),
                 bsum_rtol=1e-5, hist_atol=1e-6)
    assert int(sp.g_count) == 2


def test_state_handover_jax_to_port():
    """Block 1 in the JAX Pallas scan, block 2 in the port after
    convert.state_from_numpy: the same gone tables as JAX throughout."""
    jp, pp = params()
    x = tone_capture(jp, [(0.10, 0.02, 150_000.0, 0.05),
                          (0.255, 0.02, -150_000.0, 0.05),
                          (0.30, 0.01, 250_000.0, 0.05)], n_blocks=2)
    bs = jp.block_samples
    run = pallas_scan(jp)
    m1, m2 = spectrogram(jp, x[:bs]), spectrogram(jp, x[bs:])
    sj1 = run(jnp.asarray(m1), detect_fast.init_state(jp), jnp.int32(bs))
    sj1 = detect.rebase_state(sj1, bs)
    sj2 = run(jnp.asarray(m2), sj1, jnp.int32(bs))

    d1 = jax_state_dict(sj1)
    sp1 = convert.state_from_numpy(d1, CPU)
    back = convert.state_to_numpy(sp1)
    for k, v in d1.items():
        want = np.roll(v, -int(d1["hist_idx"]), 0) \
            if k == "baseline_hist" else v
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    sp2 = detect_scan.scan(torch.from_numpy(m2), sp1, bs, pp)
    check_states(convert.state_to_numpy(sp2), jax_state_dict(sj2))
    assert int(sp2.g_count) >= 1


def test_edges_and_tie_at_10mhz():
    """F = 8192: bursts across the bins where the CUDA scan's thread
    ownership changes (multiples of 8 and of F / 8), one kept alive by the
    +-1-bin dilation across such an edge, an exact tie across one (the
    lower bin wins) and a squelch blast; the plain scan that the card
    tests trust is held to the Pallas scan on exactly these rows."""
    jp, pp = params(sample_rate=10_000_000, history_size=32,
                    frames_per_block=96, max_bursts=20)
    mag2 = exp_scan.edge_spectrogram(pp, seed=11)
    sj = pallas_scan(jp)(jnp.asarray(mag2), detect_fast.init_state(jp),
                         jnp.int32(jp.block_samples))
    sp = detect_scan.scan(torch.from_numpy(mag2), st.init_state(pp, CPU),
                          pp.block_samples, pp)
    got = convert.state_to_numpy(sp)
    check_states(got, jax_state_dict(sj))
    bins = set(got["g_bin"][:int(got["g_count"])].tolist()) | set(
        np.flatnonzero(got["a_valid"]).tolist())
    assert 3071 in bins and 3072 not in bins
    assert int(got["burst_dropped"]) > 0


def test_lone_long_burst_at_16k():
    """F = 16384 (12 MHz, 16 bins a CUDA thread): a burst across a thread
    edge, longer than max_burst_len and alone, so the frame of its
    long-burst deletion runs the forced noise update and then the final
    one; the plain scan is held to the Pallas scan on these rows."""
    jp, pp = params(sample_rate=12_000_000, history_size=32,
                    frames_per_block=128)
    assert pp.fft_size == 16384
    mag2 = exp_scan.long_burst_spectrogram(pp, seed=4)
    sj = pallas_scan(jp)(jnp.asarray(mag2), detect_fast.init_state(jp),
                         jnp.int32(jp.block_samples))
    sp = detect_scan.scan(torch.from_numpy(mag2), st.init_state(pp, CPU),
                          pp.block_samples, pp)
    got = convert.state_to_numpy(sp)
    check_states(got, jax_state_dict(sj))
    # the first deletion is the long burst, at a bin beside the edge
    assert int(got["g_count"]) >= 1
    assert abs(int(got["g_bin"][0]) - pp.fft_size // 4) <= 1
    assert int(got["g_last"][0]) - int(got["g_start"][0]) > pp.max_burst_len


@pytest.mark.parametrize("rate,rows", [
    (25_000_000, "edge"), (25_000_000, "long_burst"),
    (50_000_000, "edge"), (50_000_000, "long_burst")])
def test_cluster_shapes_match_pallas(rate, rows):
    """F = 32768 and 65536, which the CUDA kernel runs as a cluster of 4
    and 8 blocks of 8192 bins: the plain scan that the card tests hold
    the cluster kernel to is held to the Pallas scan here. The edge rows
    put bursts beside the DC notch on the edge at F / 2 (the mask of one
    crosses it and holds the other back until its release), an exact tie
    across each other edge (the lower bin wins) kept alive across it by
    the dilation, and a squelch comb with emission drops; the long-burst
    rows a lone burst past max_burst_len (forced, then final noise update),
    across the block edge at F / 4."""
    jp, pp = params(sample_rate=rate, history_size=32, frames_per_block=128,
                    max_bursts=20)
    F, dc = pp.fft_size, pp.fft_size // 2
    assert F == rate // 25_000_000 * 32768 and detect_scan.supports(pp)
    if rows == "edge":
        mag2 = exp_scan.cluster_edge_spectrogram(pp, seed=11)
    else:
        mag2 = exp_scan.long_burst_spectrogram(pp, seed=4)
    sj = pallas_scan(jp)(jnp.asarray(mag2), detect_fast.init_state(jp),
                         jnp.int32(jp.block_samples))
    sp = detect_scan.scan(torch.from_numpy(mag2), st.init_state(pp, CPU),
                          pp.block_samples, pp)
    got = convert.state_to_numpy(sp)
    check_states(got, jax_state_dict(sj))
    bins = got["g_bin"][:int(got["g_count"])].tolist()
    if rows == "long_burst":
        assert abs(bins[0] - F // 4) <= 1
        assert int(got["g_last"][0]) - int(got["g_start"][0]) > \
            pp.max_burst_len
        return
    # both bursts beside the notch, the upper one after the lower's release
    low = [i for i, b in enumerate(bins) if dc - 6 <= b < dc - 3]
    high = [i for i, b in enumerate(bins) if dc + 3 < b <= dc + 6]
    assert low and high
    assert got["g_start"][high[0]] + pp.burst_pre_len >= \
        got["g_stop"][low[0]]
    for e in range(detect_scan.BLOCK_BINS, F, detect_scan.BLOCK_BINS):
        if e != dc:
            assert e - 1 in bins and e not in bins
    assert int(got["burst_dropped"]) > 0
