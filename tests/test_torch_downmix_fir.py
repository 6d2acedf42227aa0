"""The downmix chain's small FIRs with their masks (the port's
dsp/downmix.py `noise_box_plain` and `rrc_plain`, the FIRs of the plain
versions of csrc/downmix_fir.cu) against the JAX package's `_fir_same_c`,
`_fir_valid_f` and the masks of `downmix_from_dec`
(iridium_tpu/dsp/downmix.py:132-164, :399-412, :459-460) on the same
numpy rows, bit for bit: both run the FIRs as shifted f32 adds in tap
order. The one step that is not a FIR, |xd|^2, is PyTorch's (hypotf, as on
the card) in the port and XLA's complex abs in the JAX package, which on
the CPU rounds differently in ~35% of samples (up to an ulp): so the box
filter is held bit-equal to JAX's `_fir_valid_f` over the port's |xd|^2,
and within rtol 1e-6 of the JAX chain with its own |xd|^2. The rows (odd
L) cover shift_dec > 0, dec_len < 25 (the LPF skipped), dec_len < 20 (no
box output), nothing kept, dec_len past the row, and frame_len 0,
negative, short and full. The kernel's stage 1, `frame_rrc_plain` (the
frame gather, its mask, the fine rotation, the RRC), against the JAX
steps of `downmix_from_dec` (:431-460) on the same numpy rows, starts
(past the row too), bins u (at +-cfo_total / 2 too) and fractions corr
(0 too): the two frameworks' CPU cos and sin may part in the last bit,
so within rtol 1e-4 and atol 1e-4 x the rows' peak (the tolerance
`test_downmix_with_leads_matches_jax` uses for samples). Then the whole
`Downmix` against the JAX `from_dec` on bursts behind alignment leads
(shift_dec > 0) and short windows, with test_torch_downmix_demod.py's
tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.config import DownmixConfig as JaxDmConfig  # noqa: E402
from iridium_tpu.dsp import downmix as jdownmix  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig, DownmixConfig  # noqa: E402
from iridium_tpu_torch.dsp import downmix  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402

CPU = torch.device("cpu")
DET = dict(sample_rate=10_000_000, frames_per_block=512, burst_capacity=64,
           gone_capacity=128, max_new_per_frame=8)
L = 3001                        # odd: rows not 16-byte aligned on the card
# (name, dec_len, shift_dec, frame_len)
ROWS = [("full", L, 0, L),
        ("shifted", 2500, 300, 1234),
        ("shift_1", L, 1, 26),
        ("lpf_skipped_24", 24, 0, 25),
        ("lpf_on_25", 25, 0, 24),
        ("shifted_26", 26, 3, 20),
        ("no_box_19", 19, 0, 19),
        ("box_20", 20, 0, 1),
        ("empty", 0, 0, 0),
        ("one", 1, 0, -3),
        ("shift_past_len", 1000, 1200, 999),
        ("shift_at_len_minus_1", 1500, 1499, 2),
        ("past_the_row", L + 100, 7, L + 100)]
IDS = [r[0] for r in ROWS]


def _consts():
    jdmp = JaxDmConfig().derived(JaxDetConfig(**DET).derived())
    return jdownmix.make_consts(jdmp)


def _jax_noise_box(c):
    noise, box = np.asarray(c.noise_taps), np.asarray(c.box_taps)
    iota = jnp.arange(L)

    def one(x, dec_len, shift_dec):
        # downmix_from_dec :399-412
        keep = (iota < dec_len) & (iota >= shift_dec)
        dec_full = jnp.where(keep, x, 0.0)
        nl = jdownmix._fir_same_c(dec_full, noise)
        xd = jnp.where(dec_len - len(noise) + 1 > 0, nl, dec_full)
        xd = jnp.where(keep, xd, 0.0)
        mag2 = jnp.abs(xd) ** 2
        filt = jdownmix._fir_valid_f(jnp.pad(mag2, (0, len(box) - 1)), box)
        return xd, filt
    return jax.vmap(one)


def _jax_box(c):
    box = np.asarray(c.box_taps)
    return jax.vmap(lambda mag2: jdownmix._fir_valid_f(
        jnp.pad(mag2, (0, len(box) - 1)), box))


def _jax_rrc(c):
    rrc = np.asarray(c.rrc_taps)
    iota = jnp.arange(L)

    def one(xf, frame_len):
        # downmix_from_dec :459-460
        xf = jnp.where(iota < frame_len, xf, 0.0)
        return jdownmix._fir_same_c(xf, rrc)
    return jax.vmap(one)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(16)
    B = len(ROWS)
    x = (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L))
         ).astype(np.complex64)
    xf = (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L))
          ).astype(np.complex64)
    dec_len, shift_dec, frame_len = (np.array([r[i] for r in ROWS])
                                     for i in (1, 2, 3))
    c = _consts()
    jxd, jfilt = _jax_noise_box(c)(jnp.asarray(x), jnp.asarray(dec_len),
                                   jnp.asarray(shift_dec))
    jxr = _jax_rrc(c)(jnp.asarray(xf), jnp.asarray(frame_len))
    # the box filter over the port's |xd|^2 (torch's abs is np.hypot)
    jxd = np.asarray(jxd)
    jbox = _jax_box(c)(jnp.asarray(np.hypot(jxd.real, jxd.imag) ** 2))
    t = dict(noise=torch.from_numpy(c.noise_taps),
             box=torch.from_numpy(c.box_taps),
             rrc=torch.from_numpy(c.rrc_taps))
    args_nb = (torch.from_numpy(x), torch.from_numpy(dec_len),
               torch.from_numpy(shift_dec), t["noise"], t["box"])
    args_rrc = (torch.from_numpy(xf), torch.from_numpy(frame_len), t["rrc"])
    pxd, pfilt = downmix.noise_box_plain(*args_nb)
    pxr = downmix.rrc_plain(*args_rrc)
    return dict(jax=(jxd, np.asarray(jbox), np.asarray(jxr)),
                jax_own_abs=np.asarray(jfilt),
                port=(pxd.numpy(), pfilt.numpy(), pxr.numpy()),
                args_nb=args_nb, args_rrc=args_rrc, x=x)


def test_consts_are_the_kernels_sizes():
    c = _consts()
    assert (len(c.noise_taps), len(c.box_taps), len(c.rrc_taps)) == (
        25, 20, 51)
    assert max(map(len, (c.noise_taps, c.box_taps, c.rrc_taps))) <= (
        downmix.MAX_TAPS)
    assert downmix.MAX_TAPS == jdownmix._SMALL_FIR_MAX


@pytest.mark.parametrize("i", range(len(ROWS)), ids=IDS)
def test_noise_box_plain_bit_equal_to_jax(rows, i):
    (jxd, jfilt, _), (pxd, pfilt, _) = rows["jax"], rows["port"]
    assert pxd.dtype == np.complex64 and pfilt.dtype == np.float32
    assert np.array_equal(pxd[i], jxd[i])
    assert np.array_equal(pfilt[i], jfilt[i])
    np.testing.assert_allclose(pfilt[i], rows["jax_own_abs"][i], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("i", range(len(ROWS)), ids=IDS)
def test_rrc_plain_bit_equal_to_jax(rows, i):
    assert np.array_equal(rows["port"][2][i], rows["jax"][2][i])


def test_rows_exercise_the_masks(rows):
    """The edges are what the rows say: the LPF ran on 'lpf_on_25' and not
    on 'lpf_skipped_24', nothing is kept where shift_dec >= dec_len, the
    lead is zero, the box output is zero past the kept samples, and a
    frame of length 0 or less filters to zero."""
    (xd, filt, xr), x = rows["port"], rows["x"]
    i = IDS.index
    assert np.array_equal(xd[i("lpf_skipped_24")][:24],
                          x[i("lpf_skipped_24")][:24])
    assert not np.array_equal(xd[i("lpf_on_25")][:25],
                              x[i("lpf_on_25")][:25])
    for name in ("empty", "shift_past_len"):
        assert not xd[i(name)].any() and not filt[i(name)].any()
    assert not xd[i("shifted")][:300].any() and xd[i("shifted")][300]
    assert not filt[i("no_box_19")][19:].any()
    assert not xr[i("empty")].any() and not xr[i("one")].any()
    assert xr[i("box_20")][:26].all() and not xr[i("box_20")][26:].any()


def test_cpu_wrappers_are_the_plain_versions(rows, frames):
    xd, filt = downmix.noise_box(*rows["args_nb"])
    assert torch.equal(xd, torch.from_numpy(rows["port"][0]))
    assert torch.equal(filt, torch.from_numpy(rows["port"][1]))
    xr = downmix.frame_rrc(*frames["args"])
    assert torch.equal(xr, torch.from_numpy(frames["port"]))


# frame rows for stage 1: (name, start, frame_len, u, corr); H is
# cfo_total / 2, u's ends (downmix: u in [-H, H))
H = 2048
FRAME_ROWS = [("full", 0, L, 5, 0.3),
              ("mid", 700, 1500, -37, -0.41),
              ("u_plus_half", 100, 2800, H, 0.49),
              ("u_minus_half", 260, 2700, -H, -0.5),
              ("corr_0", 50, 2000, 12, 0.0),
              ("u_0_corr_0", 3, 2990, 0, 0.0),
              ("frame_past_the_row", 2000, L, 7, 0.1),
              ("start_past_the_row", L + 50, L, 3, 0.2),
              ("short", 2990, 11, -1, 0.25),
              ("empty", 0, 0, 1, 0.5),
              ("negative_len", 10, -5, 2, -0.2)]
FRAME_IDS = [r[0] for r in FRAME_ROWS]


def _jax_frame_rrc(c, cfo_total):
    """downmix_from_dec :431-435 (gather, mask), :451-456 (rotate) and
    :458-460 (mask, RRC), per row."""
    rrc = np.asarray(c.rrc_taps)
    iota = jnp.arange(L, dtype=jnp.int32)
    pad_to = -(-(2 * L + 256) // 128) * 128

    def one(xd, start, frame_len, u, corr):
        xf = jdownmix._shift_take(jnp.pad(xd, (0, pad_to - L)), start, L)
        xf = jnp.where(iota < frame_len, xf, 0.0)
        two_total = 2 * cfo_total
        mfine = jnp.mod(u * iota, two_total).astype(jnp.float32)
        frac = (corr * iota.astype(jnp.float32)) / two_total
        angf = (-2.0 * np.pi) * (mfine / two_total + frac)
        xf = xf * jax.lax.complex(jnp.cos(angf), jnp.sin(angf))
        xf = jnp.where(iota < frame_len, xf, 0.0)
        return jdownmix._fir_same_c(xf, rrc)
    return jax.vmap(one)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(20)
    B = len(FRAME_ROWS)
    xd = (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L))
          ).astype(np.complex64)
    start, frame_len, u = (np.array([r[i] for r in FRAME_ROWS], np.int64)
                           for i in (1, 2, 3))
    corr = np.array([r[4] for r in FRAME_ROWS], np.float32)
    jdmp = JaxDmConfig().derived(JaxDetConfig(**DET).derived())
    cfo_total = jdmp.cfo_fft_total
    assert cfo_total == 2 * H
    c = jdownmix.make_consts(jdmp)
    jxr = _jax_frame_rrc(c, cfo_total)(
        jnp.asarray(xd), jnp.asarray(start, jnp.int32),
        jnp.asarray(frame_len, jnp.int32), jnp.asarray(u, jnp.int32),
        jnp.asarray(corr))
    args = (torch.from_numpy(xd), torch.from_numpy(start),
            torch.from_numpy(frame_len), torch.from_numpy(u),
            torch.from_numpy(corr), torch.from_numpy(c.rrc_taps), cfo_total)
    return dict(jax=np.asarray(jxr),
                port=downmix.frame_rrc_plain(*args).numpy(), args=args)


@pytest.mark.parametrize("i", range(len(FRAME_ROWS)), ids=FRAME_IDS)
def test_frame_rrc_plain_matches_jax(frames, i):
    got, want = frames["port"], frames["jax"]
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got[i], want[i], rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_frame_rows_exercise_the_masks(frames):
    """Nothing of a frame past its length, past the row or from a start
    past the row; every sample up to 25 past a frame that the row holds;
    u = 0 and corr = 0 turn nothing (the frame's RRC is `rrc_plain`'s)."""
    xr, (xd, start, frame_len, *_, taps, _) = frames["port"], frames["args"]
    i = FRAME_IDS.index
    for name in ("start_past_the_row", "empty", "negative_len"):
        assert not xr[i(name)].any()
    assert xr[i("short")][:11 + 25].all() and not xr[i("short")][36:].any()
    # the frame from 2,000 ends at the row's end, 1,001 samples on
    assert xr[i("frame_past_the_row")][:1001 + 25].all()
    assert not xr[i("frame_past_the_row")][1001 + 25:].any()
    b = i("u_0_corr_0")
    s = int(start[b])
    shifted = torch.zeros_like(xd[b:b + 1])
    shifted[0, :L - s] = xd[b, s:]
    want = downmix.rrc_plain(shifted, frame_len[b:b + 1], taps)
    assert torch.equal(torch.from_numpy(xr[b:b + 1]), want)


# Downmix with alignment leads: (start of the burst in the decimated row,
# dec_len, shift_dec); a DL burst of 300 bits (~1,900 samples) in each
DEC_CAP = 3000
LEAD_CASES = [(200, 2900, 0), (250, 2900, 37), (400, 2990, 100),
              (300, DEC_CAP, 250), (100, 2800, 120), (0, 24, 5),
              (0, 19, 3), (0, 0, 0)]


@pytest.fixture(scope="module")
def leads():
    jp = JaxDetConfig(**DET).derived()
    jdmp = JaxDmConfig().derived(jp)
    pp = DetectorConfig(**DET).derived()
    pdmp = DownmixConfig().derived(pp)
    F, decim = jp.fft_size, jdmp.decimation
    l_ext = (DEC_CAP - 1) * decim + len(jdownmix.make_consts(jdmp)
                                        .input_taps)
    frame_cap = jdmp.max_frame_samples
    rng = np.random.default_rng(61)
    B = len(LEAD_CASES)
    dec = np.zeros((B, DEC_CAP), np.complex64)
    for b, (start, _, _) in enumerate(LEAD_CASES):
        dec[b] = synth.noise(DEC_CAP, seed=200 + b)
        bits = rng.integers(0, 2, 300).astype(np.uint8)
        w = synth.burst_waveform(bits, 250_000, 3_000.0 * (b - 3), "DL")
        synth.add_burst(dec[b], w[:DEC_CAP - start], start, 30.0)
    # ext_len so that (ext_len - in_ntaps + 1) // decim is dec_len
    ext = np.array([d * decim + 800 for _, d, _ in LEAD_CASES], np.int32)
    sd = np.array([s for _, _, s in LEAD_CASES], np.int32)
    bins = np.full(B, F // 2, np.int32)
    dm_one = jdownmix.make_downmix_one(jp, jdmp, l_ext, frame_cap,
                                       dec_cap=DEC_CAP, fir_mode="conv")
    jout = dm_one.from_dec(jnp.asarray(dec), jnp.asarray(ext),
                           jnp.asarray(bins), jnp.asarray(sd))
    jout = jax.tree_util.tree_map(np.asarray, jout)
    port = downmix.Downmix(pp, pdmp, DEC_CAP, frame_cap, CPU)
    pout = port(torch.from_numpy(dec), torch.from_numpy(ext),
                torch.from_numpy(bins), torch.from_numpy(sd))
    return jout, pout


def test_downmix_with_leads_matches_jax(leads):
    jout, pout = leads
    for name in ("ok", "direction", "start_dec", "n_samples"):
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      getattr(jout, name), err_msg=name)
    # the bursts behind a lead start at or after it; the short windows
    # fail the downmix
    assert list(jout.ok) == [True] * 5 + [False] * 3
    assert (jout.start_dec >= np.array([s for _, _, s in LEAD_CASES])).all()
    np.testing.assert_allclose(pout.fine_offset.numpy(), jout.fine_offset,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pout.uw_corr.numpy(), jout.uw_corr,
                               rtol=1e-4, atol=1e-4)
    got, want = pout.samples.numpy(), jout.samples
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
