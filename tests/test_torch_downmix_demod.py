"""The port's downmix chain and demodulator (iridium_tpu_torch/dsp/) against
the JAX package's (iridium_tpu/dsp/downmix.py `from_dec`, dsp/demod.py)
on the same inputs: synthetic burst windows rotated and decimated once by
the JAX conv path, then the same decimated windows through both downmix
chains, and the same downmixed frames through both demodulators.

Integer fields (ok, direction, start_dec, n_samples, n_symbols,
confidence, bits) must be exact. Float fields get rtol 1e-4: the two
packages' FFTs (fine CFO, sync correlation) and complex reductions sum in
different orders, which moves values at the 1e-6 level; the sample planes
get an absolute 1e-4 of the frame's peak, where near-zero samples carry
that error as a large relative one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.config import DownmixConfig as JaxDmConfig  # noqa: E402
from iridium_tpu.dsp import demod as jdemod  # noqa: E402
from iridium_tpu.dsp import downmix as jdownmix  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig, DownmixConfig  # noqa: E402
from iridium_tpu_torch.dsp import demod, downmix  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402

CPU = torch.device("cpu")
DET = dict(sample_rate=10_000_000, frames_per_block=512, burst_capacity=64,
           gone_capacity=128, max_new_per_frame=8)
L_WIN = 327_680                 # the pipeline's small window at 10 MHz
# (direction, offset Hz, SNR dB, burst start in the window, ext_len,
#  shift_dec): DL bursts, a lead-shifted one, a simplex-band one, an UL
#  burst (UW-rejected like the reference), noise only, too short
CASES = [("DL", 137_000.0, 30.0, 20_000, 260_000, 0),
         ("DL", -220_000.0, 18.0, 30_000, 280_000, 100),
         ("DL", 4_200_000.0, 28.0, 25_000, 270_000, 0),
         ("UL", 50_000.0, 30.0, 20_000, 260_000, 0),
         (None, 300_000.0, 0.0, 20_000, 260_000, 0),
         ("DL", -50_000.0, 30.0, 1_000, 3_000, 0)]


@pytest.fixture(scope="module")
def setup():
    jp = JaxDetConfig(**DET).derived()
    jdmp = JaxDmConfig().derived(jp)
    pp = DetectorConfig(**DET).derived()
    pdmp = DownmixConfig().derived(pp)
    F, fs = jp.fft_size, jp.sample_rate
    dec_cap = (L_WIN - 801) // jdmp.decimation + 1
    frame_cap = jdmp.max_frame_samples
    rng = np.random.default_rng(11)
    xs, bins, ext, sd = [], [], [], []
    for i, (direc, off, snr, start, el, shift) in enumerate(CASES):
        x = synth.noise(L_WIN, seed=100 + i)
        if direc is not None:
            bits = rng.integers(0, 2, 300).astype(np.uint8)
            synth.add_burst(x, synth.burst_waveform(bits, fs, off, direc),
                            start, snr)
        xs.append(x)
        bins.append(F // 2 + int(round(off * F / fs)))
        ext.append(el)
        sd.append(shift)
    xs = np.stack(xs)
    bins, ext, sd = (np.asarray(v, np.int32) for v in (bins, ext, sd))
    dm_one = jdownmix.make_downmix_one(jp, jdmp, L_WIN, frame_cap,
                                       dec_cap=dec_cap, fir_mode="conv")
    dec = dm_one.rotate_decimate(jnp.asarray(xs),
                                 jnp.asarray(bins - F // 2))
    dec = np.asarray(dec)
    jout = dm_one.from_dec(jnp.asarray(dec), jnp.asarray(ext),
                           jnp.asarray(bins), jnp.asarray(sd))
    jout = jax.tree_util.tree_map(np.asarray, jout)
    port = downmix.Downmix(pp, pdmp, dec_cap, frame_cap, CPU)
    pout = port(torch.from_numpy(dec), torch.from_numpy(ext),
                torch.from_numpy(bins), torch.from_numpy(sd))
    return dict(jdmp=jdmp, jout=jout, pout=pout,
                max_symbols=jdmp.max_symbols)


def test_make_consts_equal():
    jdmp = JaxDmConfig().derived(JaxDetConfig(**DET).derived())
    pdmp = DownmixConfig().derived(DetectorConfig(**DET).derived())
    want, got = jdownmix.make_consts(jdmp), downmix.make_consts(pdmp)
    assert want._fields == got._fields
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


def test_downmix_matches_jax(setup):
    jout, pout = setup["jout"], setup["pout"]
    for name in ("ok", "direction", "start_dec", "n_samples"):
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      getattr(jout, name), err_msg=name)
    # only the too-short window fails the downmix; the demod rejects the
    # UL and noise-only ones
    assert list(jout.ok) == [True] * 5 + [False]
    np.testing.assert_allclose(pout.fine_offset.numpy(), jout.fine_offset,
                               rtol=1e-4, atol=1e-6)
    # uw_corr is a sub-sample offset in [-0.5, 0.5] from a quadratic fit
    # to three correlation values: held to 1e-4 of a sample
    np.testing.assert_allclose(pout.uw_corr.numpy(), jout.uw_corr,
                               rtol=1e-4, atol=1e-4)
    got, want = pout.samples.numpy(), jout.samples
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("use_gardner", [True, False])
def test_demod_matches_jax(setup, use_gardner):
    jdmp, jout = setup["jdmp"], setup["jout"]
    S, sps = setup["max_symbols"], jdmp.samples_per_symbol
    want = jax.vmap(jdemod.make_demod(S, sps, use_gardner))(
        jnp.asarray(jout.samples), jnp.asarray(jout.n_samples),
        jnp.asarray(jout.direction))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = demod.Demod(S, sps, use_gardner)(
        torch.from_numpy(jout.samples), torch.from_numpy(jout.n_samples),
        torch.from_numpy(jout.direction))
    for name in ("ok", "direction", "n_symbols", "confidence", "bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    for name in ("level", "total_phase", "llr"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if use_gardner:
        # the two clean DL bursts and the simplex one verify their UW
        assert list(want.ok[:3]) == [True, True, True]
