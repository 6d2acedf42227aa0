"""The port's detect_fast (iridium_tpu_torch/dsp/detect_fast.py) against the
JAX package's detect_fast on the scenarios of test_detect_fast.py, its
state interchange with the port's plain scan (test_detect_pallas.py's
test_pallas_state_interchangeable_with_fast), and the bin-split mode of
detect_fast and detect.py (local bin ranges coupled by the per-frame sum
hook) against one range over all bins.

Both functions get the same |X|^2 rows (computed once with JAX), and the
whole state is compared after every block with test_torch_detect_scan's
`check_states`: ids, starts, stops, lasts, bins, the burst table, the mask
and the counters exact; dB fields rtol 1e-5 (log10 differs in the last ulp
between libraries); baseline sums and history rows rtol 1e-6 (the same f32
operations in the same order, bit-equal in practice).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu.dsp import detect as jdetect  # noqa: E402
from iridium_tpu.dsp import detect_fast as jfast  # noqa: E402
from iridium_tpu_torch import convert  # noqa: E402
from iridium_tpu_torch.dsp import (detect, detect_fast,  # noqa: E402
                                   detect_scan)
from iridium_tpu_torch.dsp import state as st  # noqa: E402

from test_detect import tone_capture  # noqa: E402
from test_torch_detect_scan import (CPU, SMALL, check_states,  # noqa: E402
                                    jax_state_dict, params, spectrogram)


@functools.lru_cache(maxsize=None)
def _jax_fast(jp):
    return jax.jit(jfast.make_scan_fast(jp))


def jax_fast(jp):
    # burst_capacity does not enter detect_fast: one compile serves every
    # scenario that differs from the default only in it
    return _jax_fast(dataclasses.replace(
        jp, burst_capacity=SMALL["burst_capacity"]))


def _blast_events(jp):
    """test_detect_fast.py's 20 staggered tones and a 4-tone blast."""
    bw_hz = jp.sample_rate / jp.fft_size
    events = []
    for i in range(20):
        f = -420_000.0 + i * 42_000.0
        if abs(f) < 5 * bw_hz:
            f += 6 * bw_hz
        events.append((0.10 + 0.002 * i, 0.165 - (0.10 + 0.002 * i), f,
                       0.06))
    events += [(0.16, 0.005, 431_000.0 + i * 12_000.0, 0.06)
               for i in range(4)]
    return tone_capture(jp, events)


def _wideband_blast(jp):
    n = jp.block_samples
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * np.float32(0.01 / np.sqrt(2))
    i0 = int(0.1 * jp.sample_rate)
    x[i0:i0 + 20000] += (0.5 * (rng.standard_normal(20000)
                                + 1j * rng.standard_normal(20000))
                         ).astype(np.complex64)
    return x


def _mass_deletion(jp):
    freqs = [-300_000.0 + i * 52_000.0 for i in range(12)]
    freqs = [f if abs(f) > 8_000 else f + 26_000.0 for f in freqs]
    wave1 = [(0.10 + 0.002 * i, 0.160 - (0.10 + 0.002 * i), f, 0.06)
             for i, f in enumerate(freqs)]
    wave2 = [(0.22 + 0.002 * i, 0.020, f, 0.06) for i, f in enumerate(freqs)]
    return tone_capture(jp, wave1 + wave2, n_blocks=2)


# (name, config overrides, capture, blocks, gone rows at least)
SCENARIOS = [
    ("multi_burst", {}, lambda jp: tone_capture(jp, [
        (0.08, 0.010, 100_000.0, 0.05), (0.085, 0.030, -200_000.0, 0.08),
        (0.12, 0.008, 300_000.0, 0.04), (0.13, 0.015, 99_000.0, 0.06)]),
     1, 4),
    ("multiblock_carry", {}, lambda jp: tone_capture(jp, [
        (0.10, 0.02, 150_000.0, 0.05), (0.255, 0.02, -150_000.0, 0.05),
        (0.30, 0.01, 250_000.0, 0.05)], n_blocks=2), 2, 3),
    ("long_burst", {}, lambda jp: tone_capture(
        jp, [(0.08, 0.15, 50_000.0, 0.05)]), 1, 2),
    ("squelch", dict(max_bursts=4, max_new_per_frame=4), _wideband_blast,
     1, 1),
    ("squelch_overflow", dict(max_bursts=20, max_new_per_frame=8,
                              burst_capacity=64), _blast_events, 1, 16),
    ("mass_deletion", dict(max_new_per_frame=8, burst_capacity=64),
     _mass_deletion, 2, 12),
]


def run_fast(jp, pp, x, n_blocks):
    """Block by block through both functions; full states compared after
    every block. Returns the port's gone rows and final state."""
    run_j, run_p = jax_fast(jp), detect_fast.make_scan_fast(pp)
    sj, sp = jfast.init_state(jp), st.init_state(pp, CPU)
    rows = []
    for k in range(n_blocks):
        block = x[k * jp.block_samples:(k + 1) * jp.block_samples]
        mag2 = spectrogram(jp, block)
        sj = run_j(jnp.asarray(mag2), sj, jnp.int32(len(block)))
        sp = run_p(torch.from_numpy(mag2), sp, len(block))
        got = convert.state_to_numpy(sp)
        check_states(got, jax_state_dict(sj))
        rows += gone_rows(sp, k * jp.block_samples)
        sj = jdetect.rebase_state(sj, jp.block_samples)
        st.rebase_(sp, pp.block_samples)
    return rows, sp


def gone_rows(state, base):
    n = int(state.g_count)
    return [dict(id=int(state.g_id[i]), start=int(state.g_start[i]) + base,
                 stop=int(state.g_stop[i]) + base,
                 last=int(state.g_last[i]) + base, bin=int(state.g_bin[i]),
                 mag=float(state.g_mag[i]), noise=float(state.g_noise[i]))
            for i in range(n)]


@pytest.mark.parametrize("name,kw,make,n_blocks,at_least", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_fast_matches_jax_fast(name, kw, make, n_blocks, at_least):
    jp, pp = params(**kw)
    rows, sp = run_fast(jp, pp, make(jp), n_blocks)
    assert len(rows) >= at_least
    if name == "squelch_overflow":
        # the squelch frame flags 20 bursts: 16 emit, the rest are counted
        assert int(sp.n_tagged) - len(rows) >= 4
        assert int(sp.burst_dropped) >= 4


def _scan_plain_block(pp):
    def run(mag2, state, n_valid):
        return detect_scan.scan_plain(mag2, state, n_valid, pp)
    return run


@pytest.mark.parametrize("order", ["fast_then_scan", "scan_then_fast"])
def test_state_interchangeable_with_scan_plain(order):
    """A stream switches scans between blocks: the gone rows equal those of
    detect_fast on both blocks (ids, starts, stops, lasts and bins exact;
    dB rtol 1e-5)."""
    jp, pp = params()
    x = tone_capture(jp, [(0.10, 0.02, 150_000.0, 0.05),
                          (0.255, 0.02, -150_000.0, 0.05),
                          (0.30, 0.01, 250_000.0, 0.05)], n_blocks=2)
    fast = detect_fast.make_scan_fast(pp)
    plain = _scan_plain_block(pp)
    runs = {"both_fast": (fast, fast), "fast_then_scan": (fast, plain),
            "scan_then_fast": (plain, fast)}
    out = {}
    for key in ("both_fast", order):
        s, rows = st.init_state(pp, CPU), []
        for k, run in enumerate(runs[key]):
            block = x[k * pp.block_samples:(k + 1) * pp.block_samples]
            s = run(torch.from_numpy(spectrogram(jp, block)), s, len(block))
            rows += gone_rows(s, k * pp.block_samples)
            st.rebase_(s, pp.block_samples)
        out[key] = sorted(rows, key=lambda r: r["id"])
    want, got = out["both_fast"], out[order]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("id", "start", "stop", "last", "bin"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose([g["mag"], g["noise"]],
                                   [w["mag"], w["noise"]], rtol=1e-5)


def run_bin_split(pp, mag2_blocks, impl, n=2):
    """The bin-split mode of the JAX package's parallel/stream.py on the
    CPU: `n` bin ranges of fft_size / n owned bins and a halo of one mask
    width (+1) each side (wrapping, as its ring exchange does), each run
    in a thread, the per-frame coupling sums taken across the threads.
    Returns every range's gone rows (absolute samples) and n_tagged."""
    import threading
    F, bs = pp.fft_size, pp.block_samples
    own, halo = F // n, 2 * (pp.burst_width_bins // 2) + 1
    FL = own + 2 * halo
    barrier = threading.Barrier(n)
    slots = [None] * n
    out = [None] * n

    def shard(me):
        def coupling_sum(x):
            slots[me] = x
            barrier.wait()
            total = sum(slots)
            barrier.wait()
            return total

        bin_lo = me * own - halo
        cols = torch.from_numpy((np.arange(FL) + bin_lo) % F)
        kw = dict(bin_lo=bin_lo, own_lo=me * own, own_hi=(me + 1) * own)
        if impl == "fast":
            run = detect_fast.make_scan_fast(pp, FL, coupling_sum, n)
            s = st.init_state(pp, CPU, id_offset=me, n_bins=FL)
        else:
            step = detect.make_frame_step(pp, global_sum=coupling_sum,
                                          n_bins=FL, id_stride=n, **kw)
            s = detect.init_state(pp, CPU, n_bins=FL, id_offset=me)
            idxs = np.arange(pp.frames_per_block) * F
        rows = []
        for k, mag2 in enumerate(mag2_blocks):
            local = mag2[:, cols]
            if impl == "fast":
                s = run(local, s, bs, **kw)
            else:
                s = detect.run_state_machine(local, idxs, idxs + F <= bs,
                                             s, step)
            rows += gone_rows(s, k * bs)
            st.rebase_(s, bs)
        out[me] = (rows, int(s.n_tagged))

    threads = [threading.Thread(target=shard, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return ([r for rows, _ in out for r in rows],
            sum(tagged for _, tagged in out))


@pytest.mark.parametrize("impl", ["fast", "exact"])
def test_bin_split_matches_one_range(impl):
    """Two bin ranges coupled through the per-frame sum hook give the gone
    rows of one range over all bins (ids aside: each range numbers its
    bursts from its own offset with a stride of two), on bursts in both
    ranges and across a block boundary."""
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.085, 0.030, -200_000.0, 0.08),
                          (0.12, 0.008, 300_000.0, 0.04),
                          (0.255, 0.02, -150_000.0, 0.05)], n_blocks=2)
    mags = [torch.from_numpy(spectrogram(jp, x[k * jp.block_samples:
                                               (k + 1) * jp.block_samples]))
            for k in range(2)]
    rows, tagged = run_bin_split(pp, mags, impl)
    if impl == "fast":
        run, s = detect_fast.make_scan_fast(pp), st.init_state(pp, CPU)
    else:
        det = detect.make_frame_step(pp)
        s = detect.init_state(pp, CPU)
    want = []
    for k, mag2 in enumerate(mags):
        if impl == "fast":
            s = run(mag2, s, pp.block_samples)
        else:
            idxs = np.arange(pp.frames_per_block) * pp.fft_size
            s = detect.run_state_machine(
                mag2, idxs, idxs + pp.fft_size <= pp.block_samples, s, det)
        want += gone_rows(s, k * pp.block_samples)
        st.rebase_(s, pp.block_samples)

    def key(r):
        return (r["start"], r["bin"])
    got, want = sorted(rows, key=key), sorted(want, key=key)
    assert len(got) == len(want) == 4 and tagged == int(s.n_tagged)
    assert {r["bin"] < pp.fft_size // 2 for r in got} == {True, False}
    for g, w in zip(got, want):
        for k in ("start", "stop", "last", "bin"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose([g["mag"], g["noise"]],
                                   [w["mag"], w["noise"]], rtol=1e-5)
