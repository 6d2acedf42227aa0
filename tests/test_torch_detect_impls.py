"""The port's other detector scans and how a pipeline picks one:

- detect.py (the exact per-frame scan) against the JAX package's detect.py
  on the scenarios of test_detect.py, on the same |X|^2 rows: gone rows,
  the burst table, the mask and the counters exact; dB fields rtol 1e-5;
  baseline sums and history rows rtol 1e-6;
- `detect_scan.resolve_impl` and `Pipeline(detect_impl=...)`: the kernel
  where it takes the shape (every F the Pallas scan takes, tiled above
  MAX_RESIDENT: 1.6 and 3.2 GHz included), detect_fast otherwise, and
  every detector configuration the JAX Pipeline accepts builds;
- the port's Pipeline with detect_fast against the JAX Pipeline on the CPU
  (which resolves to detect_fast) on a capture whose bursts make
  same-frame secondary creations: the RAW lines equal field for field,
  the frequency within 1 Hz.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.dsp import detect as jdetect  # noqa: E402
from iridium_tpu.dsp import detect_pallas  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect, detect_scan  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

from test_detect import tone_capture  # noqa: E402
from test_fused_group import multi_burst_capture  # noqa: E402
from test_torch_detect_scan import CPU, params, spectrogram  # noqa: E402
from test_torch_fused_group import T0, TINY  # noqa: E402
from test_torch_pipeline import check_lines  # noqa: E402


@functools.lru_cache(maxsize=None)
def jax_exact(jp):
    step = jdetect.make_frame_step(jp)
    return jax.jit(lambda m, idxs, act, s: jdetect.run_state_machine(
        m, idxs, act, s, step))


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


# (name, config overrides, capture, blocks, valid samples of the block)
SCENARIOS = [
    ("single_burst", {}, lambda jp: tone_capture(
        jp, [(0.10, 0.02, 123_456.0, 0.05)]), 1, None),
    ("multi_burst_overlapping", {}, lambda jp: tone_capture(jp, [
        (0.08, 0.010, 100_000.0, 0.05), (0.085, 0.030, -200_000.0, 0.08),
        (0.12, 0.008, 300_000.0, 0.04), (0.13, 0.015, 99_000.0, 0.06)]),
     1, None),
    ("long_burst_split", {}, lambda jp: tone_capture(
        jp, [(0.08, 0.15, 50_000.0, 0.05)]), 1, None),
    ("multi_block_carry", {}, lambda jp: tone_capture(jp, [
        (0.10, 0.02, 150_000.0, 0.05), (0.255, 0.02, -150_000.0, 0.05),
        (0.30, 0.01, 250_000.0, 0.05)], n_blocks=2), 2, None),
    ("partial_final_block", {}, lambda jp: tone_capture(
        jp, [(0.10, 0.02, 123_456.0, 0.05)]), 1, 200 * 1024 + 17),
    ("squelch_wideband_blast", dict(max_bursts=4), _wideband_blast, 1, None),
]

TABLE = ("a_valid", "a_id", "a_start", "a_last", "a_bin", "mask_count")
SCALARS = ("hist_idx", "primed", "burst_id", "squelch_count", "n_tagged",
           "g_count")


def check_exact(sp, sj):
    n = int(sj.g_count)
    for k in SCALARS:
        assert int(getattr(sp, k)) == int(getattr(sj, k)), k
    for k in ("g_id", "g_start", "g_stop", "g_last", "g_bin"):
        np.testing.assert_array_equal(getattr(sp, k).numpy()[:n],
                                      np.asarray(getattr(sj, k))[:n], k)
    for k in TABLE:
        np.testing.assert_array_equal(getattr(sp, k).numpy(),
                                      np.asarray(getattr(sj, k)), k)
    for k in ("g_mag", "g_noise", "a_mag", "a_noise", "peak_signal_db"):
        np.testing.assert_allclose(getattr(sp, k).numpy(),
                                   np.asarray(getattr(sj, k)), rtol=1e-5,
                                   err_msg=k)
    for k in ("baseline_sum", "baseline_hist"):
        np.testing.assert_allclose(getattr(sp, k).numpy(),
                                   np.asarray(getattr(sj, k)), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name,kw,make,n_blocks,n_valid", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_exact_matches_jax_exact(name, kw, make, n_blocks, n_valid):
    jp, pp = params(**kw)
    x = make(jp)
    bs, F = jp.block_samples, jp.fft_size
    if n_valid is not None:
        x = np.concatenate([x[:n_valid], np.zeros(bs - n_valid,
                                                  np.complex64)])
    run_j, step = jax_exact(jp), detect.make_frame_step(pp)
    sj, sp = jdetect.init_state(jp), detect.init_state(pp, CPU)
    idxs = np.arange(jp.frames_per_block, dtype=np.int32) * F
    for k in range(n_blocks):
        nv = bs if n_valid is None else n_valid
        act = idxs + F <= nv
        mag2 = spectrogram(jp, x[k * bs:(k + 1) * bs])
        sj = run_j(jnp.asarray(mag2), jnp.asarray(idxs), jnp.asarray(act),
                   sj)
        sp = detect.run_state_machine(torch.from_numpy(mag2.copy()), idxs,
                                      act, sp, step)
        check_exact(sp, sj)
        sj = jdetect.rebase_state(sj, bs)
        sp = detect.rebase_state(sp, bs)
    assert int(sp.burst_id) > 0


def test_detect_block_matches_run_state_machine():
    """make_detect_block (window, FFT, |X|^2, the frames before n_valid)
    gives the state of the frame loop on the JAX rows, within the FFTs'
    float differences."""
    jp, pp = params()
    x = tone_capture(jp, [(0.08, 0.010, 100_000.0, 0.05),
                          (0.12, 0.015, -200_000.0, 0.06)])
    n_valid = 200 * jp.fft_size
    got = detect.make_detect_block(pp)(torch.from_numpy(x),
                                       detect.init_state(pp, CPU), n_valid)
    idxs = np.arange(jp.frames_per_block) * jp.fft_size
    want = detect.run_state_machine(
        torch.from_numpy(spectrogram(jp, x).copy()), idxs,
        idxs + jp.fft_size <= n_valid, detect.init_state(pp, CPU),
        detect.make_frame_step(pp))
    assert int(got.g_count) == int(want.g_count) == 2
    for k in ("g_id", "g_start", "g_stop", "g_bin", "a_valid", "ints"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


# detector configurations the JAX Pipeline accepts, with the scan the port
# resolves them to
CONFIGS = [
    (dict(sample_rate=10_000_000, frames_per_block=2048,
          gone_capacity=2048), "scan"),
    (dict(sample_rate=25_000_000), "scan"),
    (dict(sample_rate=24_000_000, frames_per_block=64, history_size=16),
     "scan"),
    (dict(sample_rate=10_000_000, frames_per_block=100), "scan"),
    (dict(sample_rate=10_000_000, frames_per_block=1000), "scan"),
    (dict(sample_rate=1_000_000, history_size=16), "scan"),
]


@pytest.mark.parametrize("cfg,impl", CONFIGS)
def test_every_jax_config_builds(cfg, impl):
    JaxPipeline(det_cfg=JaxDetConfig(**cfg))
    p = DetectorConfig(**cfg).derived()
    assert detect_scan.resolve_impl(p) == impl
    pipe = Pipeline(det_cfg=DetectorConfig(**cfg), device="cpu")
    assert pipe.detect_impl == impl
    if impl == "fast":
        with pytest.raises(ValueError):
            detect_scan.resolve_impl(p, "scan")
    with pytest.raises(ValueError):
        detect_scan.resolve_impl(p, "pallas")


@pytest.mark.parametrize("cfg", [
    dict(sample_rate=10_000_000, frames_per_block=2048, gone_capacity=2048),
    dict(sample_rate=20_000_000), dict(sample_rate=25_000_000),
    dict(sample_rate=40_000_000), dict(sample_rate=50_000_000),
    dict(sample_rate=1_000_000), dict(sample_rate=100_000_000),
    dict(sample_rate=200_000_000),
    dict(sample_rate=10_000_000, fft_size=1152),
    dict(sample_rate=10_000_000, fft_size=3072),
    dict(sample_rate=10_000_000, fft_size=4224),
    dict(sample_rate=25_000_000, fft_size=12288),
    dict(sample_rate=25_000_000, fft_size=20480),
    dict(sample_rate=30_000_000, fft_size=24576)])
def test_scan_wherever_jax_runs_its_pallas_scan(cfg):
    """Each configuration the JAX package derives at 1-200 MHz (F = 1024
    to 262144), and the library's fft_size at sizes that are no power of
    two, goes through its Pallas scan on its chip
    (detect_pallas.resolve_impl): the port resolves it to its scan kernel
    too, not to detect_fast."""
    jp = JaxDetConfig(**cfg).derived()
    pp = DetectorConfig(**cfg).derived()
    assert pp.fft_size == jp.fft_size and detect_pallas.supports(jp)
    assert detect_scan.resolve_impl(pp) == "scan"
    assert detect_scan.resolve_impl(pp, "scan") == "scan"


def test_scan_refuses_above_a_cluster_of_16():
    """Above one cluster of 16 blocks (F > 262144) the kernel runs as a
    grid of clusters up to MAX_RESIDENT (400 and 800 MHz: F = 524288 and
    1048576) and above it as a grid of tiled blocks (1.6 GHz: F = 2097152,
    2 tiles a block; 3.2 GHz: F = 4194304, 3): every one of them, which
    the JAX package runs through its Pallas scan, resolves to the kernel,
    and so does asking for it, at 1,024 frames a block and at 1.6 and 3.2
    GHz at 256. At their default 1,024 frames those two are blocks of 2^31
    and 2^32 samples, past the kernel's int32 positions: `auto` gives
    detect_fast there, and asking for the kernel raises."""
    for rate, F, tiles, frames in ((400_000_000, 524288, 1, 1024),
                                   (800_000_000, 1048576, 1, 1024),
                                   (1_600_000_000, 2097152, 2, 256),
                                   (3_200_000_000, 4194304, 3, 256)):
        jp = JaxDetConfig(sample_rate=rate, frames_per_block=frames).derived()
        pp = DetectorConfig(sample_rate=rate,
                            frames_per_block=frames).derived()
        assert pp.fft_size == jp.fft_size == F and detect_pallas.supports(jp)
        assert detect_scan.supports(pp) and detect_scan.tiles(F) == tiles
        assert detect_scan.resolve_impl(pp) == "scan"
        assert detect_scan.resolve_impl(pp, "scan") == "scan"
        if frames < 1024:
            dflt = DetectorConfig(sample_rate=rate).derived()
            assert dflt.block_samples >= 2**31
            assert not detect_scan.supports(dflt)
            assert detect_scan.resolve_impl(dflt) == "fast"
            with pytest.raises(ValueError):
                detect_scan.resolve_impl(dflt, "scan")


@pytest.mark.parametrize("rate", [1_600_000_000, 3_200_000_000])
@pytest.mark.parametrize("cfg", [
    dict(), dict(frames_per_block=256), dict(frames_per_block=16,
                                             history_size=16),
    dict(frames_per_block=100), dict(history_size=2, frames_per_block=64),
    dict(frames_per_block=16, gone_capacity=16 * 24 + 1),
    dict(frames_per_block=16, history_size=1)])
def test_resolve_agrees_with_pallas_above_the_resident_grid(rate, cfg):
    """At 1.6 and 3.2 GHz (tiled) `resolve_impl("auto")` takes the kernel
    wherever `detect_pallas.supports` takes the shape, and also where only
    its chunk rules refuse it (frames_per_block 100, a history of 2, as at
    every F); a gone table larger than the emission caps can fill, or a
    history of one row, goes to detect_fast on both sides. The one shape
    the Pallas scan takes and the kernel does not is a block of 2^31
    samples or more (the default 1,024 frames: 2^31 and 2^32 samples),
    past the kernel's int32 positions: it goes to detect_fast, and asking
    for the kernel raises, so that a Pipeline refuses it when it is
    made."""
    jp = JaxDetConfig(sample_rate=rate, **cfg).derived()
    pp = DetectorConfig(sample_rate=rate, **cfg).derived()
    assert pp.fft_size == jp.fft_size > detect_scan.MAX_RESIDENT
    pallas = detect_pallas.supports(jp)
    fits = pp.block_samples < 2**31
    kernel = (pp.history_size >= 2 and fits
              and pp.gone_capacity <= pp.frames_per_block * (8 + 16))
    assert detect_scan.supports(pp) == kernel
    assert not pallas or detect_scan.supports(pp) or not fits
    assert fits == bool(cfg)
    assert detect_scan.resolve_impl(pp) == ("scan" if kernel else "fast")
    if not kernel:
        with pytest.raises(ValueError):
            detect_scan.resolve_impl(pp, "scan")


def test_fast_pipeline_matches_jax_pipeline():
    """Up to four creations a frame on six placed bursts: the JAX Pipeline
    on the CPU runs detect_fast, whose segment-maxima candidates place
    same-frame secondary creations otherwise than the scan kernel's argmax
    walk (the port's default here gives other burst ids). The port's
    detect_fast gives the JAX lines."""
    kw = dict(burst_batch=4, agg_blocks=4, group_jobs=2)
    cap = multi_burst_capture()
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**TINY), start_time_ns=T0,
                        **kw)
    assert jpipe.detect_impl == "fast"
    jframes = list(jpipe.run_array(cap))
    want = [JaxRawPrinter("t").format(f) for f in jframes]
    lines = {}
    for impl in ("fast", "auto"):
        pipe = Pipeline(det_cfg=DetectorConfig(**TINY), start_time_ns=T0,
                        device="cpu", detect_impl=impl, **kw)
        frames = list(pipe.run_array(cap))
        lines[pipe.detect_impl] = [RawPrinter("t").format(f) for f in frames]
        if impl == "fast":
            for f, jf in zip(frames, jframes):
                np.testing.assert_array_equal(f["bits"], jf["bits"])
            assert pipe.stats.n_detected == jpipe.stats.n_detected
            assert pipe.stats.n_ok == jpipe.stats.n_ok
    check_lines(lines["fast"], want)
    assert lines["scan"] != lines["fast"]
