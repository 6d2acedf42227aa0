"""The downmix chain's steps around its FIRs (the port's dsp/downmix.py
twins of csrc/downmix_chain.cu: `burst_start_plain`, `cfo_peak_plain`,
`sync_input_plain`, `sync_products_plain`, `sync_extract_plain`) against
the JAX package's steps of `downmix_from_dec`
(iridium_tpu/dsp/downmix.py: the ok terms :394-397, the burst start
:410-429 and the CFO gather and window :431-441; the CFO peak :442-449;
the sync input and template products :463-467; the sync peaks, phase
align and extraction :469-531), composed here per row from the JAX
module's own `_shift_take`, `_pick1`, `_quad_interp` and jnp, on the same
numpy inputs. Integer fields must be exact; floats get rtol 1e-4 and atol
1e-4 of the peak (the tolerances of `test_downmix_matches_jax`: the two
frameworks' CPU complex products and magnitudes part in the last bit).
The rows hit the edges: flen 0 and 1, no hit, a start past the row,
frames of length 0 or below, a CFO peak at either end and at the
half-way bin, ties, a zero spectrum and a zero correlation, search
spans of 0, 1 and 2, UL over DL, uw_start below 0 and at frame_len, the
simplex and normal bands, an extraction past the row. Then `Downmix`
on the CPU goes through each wrapper by its module global.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu import iridium as jiridium  # noqa: E402
from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.config import DownmixConfig as JaxDmConfig  # noqa: E402
from iridium_tpu.dsp import downmix as jdownmix  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig, DownmixConfig  # noqa: E402
from iridium_tpu_torch.dsp import downmix  # noqa: E402

CPU = torch.device("cpu")
DET = dict(sample_rate=10_000_000, frames_per_block=512, burst_capacity=64,
           gone_capacity=128, max_new_per_frame=8)
L = 3001                        # odd: rows not 16-byte aligned on the card
FRAME_CAP = 1918
RTOL = 1e-4


def _close(got, want, name):
    """Within rtol 1e-4 and atol 1e-4 of the peak of `want`."""
    want = np.asarray(want)
    peak = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * peak,
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jp = JaxDetConfig(**DET).derived()
    jdmp = JaxDmConfig().derived(jp)
    pp = DetectorConfig(**DET).derived()
    dm = downmix.Downmix(pp, DownmixConfig().derived(pp), L, FRAME_CAP, CPU)
    return dict(jp=jp, jdmp=jdmp, c=jdownmix.make_consts(jdmp), dm=dm,
                k=dm.chain)


# ---- burst_start: (name, dec_len, shift_dec, ext_len past the minimum,
# stretch start or None) ----
START_ROWS = [("full", L, 0, 5, 400),
              ("lead", 2600, 120, 0, 60),
              ("lead_inside_burst", 2800, 900, 3, 300),
              ("flen_0", 19, 0, 0, 0),
              ("flen_1", 20, 0, 0, 0),
              ("flen_2_short", 21, 0, 0, None),
              ("empty", 0, 0, 0, None),
              ("start_past_the_row", L, L + 5, 0, 100),
              ("lead_past_dec_len", 1500, 1600, 0, 100),
              ("window_short", 2000, 50, -1, 100),
              ("zeros", 2900, 0, 0, "zeros"),
              ("late_burst", L, 0, 0, 2950),
              ("start_late_not_ok", 1000, 0, 0, 950)]
START_IDS = [r[0] for r in START_ROWS]


@pytest.fixture(scope="module")
def starts(setup):
    k, c = setup["k"], setup["c"]
    rng = np.random.default_rng(21)
    B = len(START_ROWS)
    x = ((rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L)))
         / 4).astype(np.complex64)
    dec_len, shift, ext = (np.zeros(B, np.int64) for _ in range(3))
    for b, (_, d, s, e, at) in enumerate(START_ROWS):
        dec_len[b], shift[b] = d, s
        # ext_len just past the decimation's minimum (or just short, -1,
        # of the window check behind the lead)
        ext[b] = (d * k.decim + 800 + e if e >= 0
                  else s * k.decim + 99)
        if at == "zeros":
            x[b] = 0
        elif at is not None:
            x[b, at:] *= 10
    args = (torch.from_numpy(x), torch.from_numpy(dec_len),
            torch.from_numpy(shift), setup["dm"].noise_taps,
            setup["dm"].box_taps)
    xd, filt = downmix.noise_box_plain(*args)
    targs = (xd, filt, torch.from_numpy(ext), torch.from_numpy(dec_len),
             torch.from_numpy(shift), setup["dm"].cfo_win, k)
    port = downmix.burst_start_plain(*targs)
    jout = _jax_burst_start(setup)(
        jnp.asarray(xd.numpy()), jnp.asarray(filt.numpy()),
        jnp.asarray(ext, jnp.int32), jnp.asarray(dec_len, jnp.int32),
        jnp.asarray(shift, jnp.int32))
    return dict(port=[t.numpy() for t in port],
                jax=[np.asarray(v) for v in jout], args=targs)


def _jax_burst_start(setup):
    """downmix_from_dec :394-397 (ok), :410-429 (start), :431-441 (the
    frame gather, its mask, the CFO samples squared and windowed), with
    the CFO FFT's zero padding."""
    jdmp, c = setup["jdmp"], setup["c"]
    decim, cfo_n, cfo_total = (jdmp.decimation, jdmp.cfo_fft_size,
                               jdmp.cfo_fft_total)
    box_ntaps = len(c.box_taps)
    box_half = (box_ntaps - 1) // 2
    cfo_win = np.asarray(c.cfo_window)
    iota_dec = jnp.arange(L, dtype=jnp.int32)
    iota_cfo = jnp.arange(cfo_n, dtype=jnp.int32)
    pad_to = -(-(2 * L + 256) // 128) * 128

    def one(xd, filt, ext_len, dec_len, shift_dec):
        ok = ext_len - shift_dec * decim >= 100
        ok &= dec_len - shift_dec >= 100
        flen = jnp.maximum(dec_len - box_ntaps + 1, 0)
        fmask = iota_dec < flen
        filt_m = jnp.where(fmask, filt, -jnp.inf)
        thr = jdownmix.START_THRESHOLD * jnp.max(filt_m)
        hit = fmask & (filt >= thr)
        first = jnp.where(jnp.any(hit), jnp.argmax(hit).astype(jnp.int32),
                          flen)
        start = jnp.where(
            first > shift_dec,
            jnp.maximum(first + box_half - jdmp.pre_start_samples,
                        shift_dec),
            shift_dec)
        start = jnp.where(flen > 0, start, shift_dec)
        ok &= start < dec_len - 100
        frame_len = dec_len - start
        xf = jdownmix._shift_take(jnp.pad(xd, (0, pad_to - L)), start, L)
        xf = jnp.where(iota_dec < frame_len, xf, 0.0)
        ncfo = jnp.minimum(cfo_n, frame_len)
        z = xf[:cfo_n]
        z = jnp.where(iota_cfo < ncfo, z * z * cfo_win, 0.0)
        return start, frame_len, ok, jnp.pad(z, (0, cfo_total - cfo_n))
    return jax.vmap(one)


@pytest.mark.parametrize("i", range(len(START_ROWS)), ids=START_IDS)
def test_burst_start_plain_matches_jax(starts, i):
    (ps, pf, pok, pz), (js, jf, jok, jz) = starts["port"], starts["jax"]
    assert (int(ps[i]), int(pf[i]), bool(pok[i])) == (
        int(js[i]), int(jf[i]), bool(jok[i]))
    assert pz.dtype == np.complex64 and pz.shape == jz.shape
    _close(pz[i], jz[i], "z")


def test_burst_start_rows_exercise_the_edges(starts):
    """No hit below flen 0 (the start at the lead); a start past the row
    gives no CFO samples; no start before the lead; the
    window check and the late start fail ok; the zero row hits at once."""
    (start, frame_len, ok, z), args = starts["port"], starts["args"]
    i = START_IDS.index
    shift = args[4].numpy()
    for name in ("flen_0", "empty", "start_past_the_row"):
        assert start[i(name)] == shift[i(name)], name
    for name in ("empty", "start_past_the_row"):
        assert not z[i(name)].any(), name
    # no box output: the start stays at 0 and the CFO takes the 19 samples
    # (the window's first is 0)
    assert z[i("flen_0")][1:19].all() and not z[i("flen_0")][19:].any()
    assert frame_len[i("start_past_the_row")] < 0
    # never before the lead, which zeroes a burst's first part
    assert (start >= shift).all() and start[i("lead_inside_burst")] > 900
    assert start[i("zeros")] == 0 and not z[i("zeros")].any()
    assert ok[i("full")] and ok[i("lead")]
    for name in ("window_short", "start_late_not_ok", "flen_1", "empty"):
        assert not ok[i(name)], name
    assert z[i("full")][:256].all() and not z[i("full")][256:].any()


# ---- cfo_peak: (name, the row's form) ----
PEAK_ROWS = ["random", "peak_at_0", "peak_at_end", "peak_at_half",
             "peak_below_half", "tie", "zeros", "tiny"]


@pytest.fixture(scope="module")
def peaks(setup):
    n = setup["jdmp"].cfo_fft_total
    rng = np.random.default_rng(22)
    spec = ((rng.standard_normal((len(PEAK_ROWS), n))
             + 1j * rng.standard_normal((len(PEAK_ROWS), n)))
            ).astype(np.complex64)
    at = dict(peak_at_0=0, peak_at_end=n - 1, peak_at_half=n // 2,
              peak_below_half=n // 2 - 1)
    for b, name in enumerate(PEAK_ROWS):
        if name in at:
            spec[b, at[name]] = 40 + 30j
        elif name == "tie":
            spec[b, 700] = spec[b, 300] = 50 - 20j
        elif name == "zeros":
            spec[b] = 0
        elif name == "tiny":
            spec[b] *= 1e-6
    port = downmix.cfo_peak_plain(torch.from_numpy(spec))

    def one(s):
        # downmix_from_dec :441-449
        p = jnp.abs(s) ** 2
        idx = jnp.argmax(p).astype(jnp.int32)
        u = jnp.where(idx >= n // 2, idx - n, idx)
        interior = (idx > 0) & (idx < n - 1)
        a = jdownmix._pick1(p, jnp.clip(idx - 1, 0, n - 1))
        b_ = jdownmix._pick1(p, idx)
        g = jdownmix._pick1(p, jnp.clip(idx + 1, 0, n - 1))
        corr = jnp.where(interior, jdownmix._quad_interp(a, b_, g), 0.0)
        return u, corr, (u.astype(jnp.float32) + corr) / n / 2.0
    jout = jax.vmap(one)(jnp.asarray(spec))
    return dict(port=[t.numpy() for t in port],
                jax=[np.asarray(v) for v in jout], n=n)


@pytest.mark.parametrize("i", range(len(PEAK_ROWS)), ids=PEAK_ROWS)
def test_cfo_peak_plain_matches_jax(peaks, i):
    (pu, pc, pf), (ju, jc, jf) = peaks["port"], peaks["jax"]
    assert int(pu[i]) == int(ju[i])
    assert pc.dtype == np.float32 and pf.dtype == np.float32
    _close(pc[i], jc[i], "corr")
    _close(pf[i], jf[i], "fine_offset")


def test_cfo_peak_rows_exercise_the_edges(peaks):
    """The ends give no interpolation, the half-way bin is -n/2, a tie and
    a zero spectrum take the first index, a peak whose denominator is
    under the guard (|spec|^2 ~1e-12) interpolates to 0."""
    (u, corr, _), n = peaks["port"], peaks["n"]
    i = PEAK_ROWS.index
    assert u[i("peak_at_0")] == 0 and corr[i("peak_at_0")] == 0
    assert u[i("peak_at_end")] == -1 and corr[i("peak_at_end")] == 0
    assert u[i("peak_at_half")] == -n // 2
    assert u[i("peak_below_half")] == n // 2 - 1
    assert u[i("tie")] == 300 and u[i("zeros")] == 0
    assert corr[i("zeros")] == 0
    assert corr[i("tiny")] == 0


# ---- the sync input and the template products ----
SYNC_LENS = [L, 840, 839, 2, 1, 0, -7, 500]


@pytest.fixture(scope="module")
def sync_in(setup):
    jdmp, c = setup["jdmp"], setup["c"]
    cap, n = jdmp.sync_search_len, jdmp.corr_fft_size
    rng = np.random.default_rng(23)
    B = len(SYNC_LENS)
    xr = (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L))
          ).astype(np.complex64)
    frame_len = np.array(SYNC_LENS, np.int64)
    port = downmix.sync_input_plain(torch.from_numpy(xr),
                                    torch.from_numpy(frame_len), cap, n)
    iota = jnp.arange(cap, dtype=jnp.int32)

    def one(x, fl):
        # downmix_from_dec :463-464, with the forward FFT's zero padding
        search_len = jnp.minimum(cap, fl)
        fwd_in = jnp.where(iota < search_len, x[:cap], 0.0)
        return jnp.pad(fwd_in, (0, n - cap))
    jin = np.asarray(jax.vmap(one)(jnp.asarray(xr),
                                   jnp.asarray(frame_len, jnp.int32)))
    fwd = (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
           ).astype(np.complex64)
    prod = downmix.sync_products_plain(
        torch.from_numpy(fwd), setup["dm"].dl_fft, setup["dm"].ul_fft)
    # :466-467's products
    jprod = np.stack([np.asarray(jnp.asarray(fwd) * c.dl_sync_fft),
                      np.asarray(jnp.asarray(fwd) * c.ul_sync_fft)])
    return dict(port=port.numpy(), jax=jin, prod=prod.numpy(), jprod=jprod,
                cap=cap, n=n)


def test_sync_input_plain_matches_jax(sync_in):
    got, want = sync_in["port"], sync_in["jax"]
    assert got.dtype == np.complex64 and got.shape == (len(SYNC_LENS),
                                                       sync_in["n"])
    np.testing.assert_array_equal(got, want)
    # nothing past the search span, nothing of a frame of length <= 0
    for b, fl in enumerate(SYNC_LENS):
        kept = max(min(fl, sync_in["cap"]), 0)
        assert got[b, :kept].all() and not got[b, kept:].any()


def test_sync_products_plain_matches_jax(sync_in):
    got, want = sync_in["prod"], sync_in["jprod"]
    assert got.dtype == np.complex64 and got.shape == want.shape
    for t in range(2):
        _close(got[t], want[t], "products")


# ---- sync_extract: (name, frame_len, form of the correlations, center
# bin's offset from F / 2 in bins, start) ----
EXTRACT_ROWS = [("dl", L - 300, "dl", 0, 300),
                ("ul", 2500, "ul", 100, 80),
                ("simplex", L - 200, "dl", 3500, 200),
                ("normal_high", 2900, "dl", 3000, 10),
                ("search_0", 0, "dl", 0, 0),
                ("search_neg", -12, "dl", 0, 40),
                ("search_1", 1, "dl", 0, 9),
                ("search_2", 2, "dl", 0, 9),
                ("zeros", 2000, "zeros", 0, 500),
                ("peak_at_0", 2500, "at0", 0, 33),
                ("peak_at_end", 2500, "at_end", 0, 33),
                ("uw_start_negative", 2500, "early", 0, 33),
                ("uw_start_at_len", 300, "late", 0, 20),
                ("short_for_min", 2000, "late", 0, 12),
                ("past_the_row", 2990, "late", -200, 1)]
EXTRACT_IDS = [r[0] for r in EXTRACT_ROWS]
# rows shorter than a frame from the furthest uw_start, so that extractions
# run past the row's end
L_X = 1200


@pytest.fixture(scope="module")
def extracts(setup):
    jp, jdmp, c, k = setup["jp"], setup["jdmp"], setup["c"], setup["k"]
    cap, n, F = jdmp.sync_search_len, jdmp.corr_fft_size, jp.fft_size
    rng = np.random.default_rng(24)
    B = len(EXTRACT_ROWS)
    cc = ((rng.standard_normal((2, B, n)) + 1j * rng.standard_normal(
        (2, B, n))) / 4).astype(np.complex64)
    xr = (rng.standard_normal((B, L_X)) + 1j * rng.standard_normal(
        (B, L_X))).astype(np.complex64)
    frame_len, bins, start = (np.zeros(B, np.int64) for _ in range(3))
    for b, (_, fl, form, dbin, st) in enumerate(EXTRACT_ROWS):
        frame_len[b], bins[b], start[b] = fl, F // 2 + dbin, st
        dl_at = {"dl": 500, "at0": 0, "at_end": cap - 1, "early": 3,
                 "late": 839}.get(form)
        if form == "ul":
            cc[1, b, 420] = 9 + 4j
        elif form == "zeros":
            cc[:, b] = 0
        if dl_at is not None:
            cc[0, b, dl_at] = 6 - 8j
    ok = np.ones(B, bool)
    fine = rng.uniform(-0.3, 0.3, B).astype(np.float32)
    targs = (torch.from_numpy(cc), torch.from_numpy(xr),
             torch.from_numpy(start), torch.from_numpy(frame_len),
             torch.from_numpy(ok), torch.from_numpy(bins),
             torch.from_numpy(fine), k)
    port = downmix.sync_extract_plain(*targs)
    jout = _jax_sync_extract(setup)(
        jnp.asarray(cc[0]), jnp.asarray(cc[1]), jnp.asarray(xr),
        jnp.asarray(start, jnp.int32), jnp.asarray(frame_len, jnp.int32),
        jnp.asarray(ok), jnp.asarray(bins - F // 2, jnp.int32),
        jnp.asarray(fine))
    return dict(port=port, jax=[np.asarray(v) for v in jout], args=targs)


def _jax_sync_extract(setup):
    """downmix_from_dec :468-531, per row, from the two correlations."""
    jp, jdmp, c = setup["jp"], setup["jdmp"], setup["c"]
    cap, n = jdmp.sync_search_len, jdmp.corr_fft_size
    sps = float(jdmp.samples_per_symbol)
    dl_pre_off = int(jiridium.PREAMBLE_LENGTH_SHORT * sps)
    ul_pre_off = int(32 * sps)
    iota_corr = jnp.arange(n, dtype=jnp.int32)
    pad_to2 = -(-(L_X + FRAME_CAP + 256) // 128) * 128

    def one(dl_c, ul_c, xr, start, frame_len, ok, k, fine_offset):
        search_len = jnp.minimum(cap, frame_len)
        smask = iota_corr < search_len

        def peak(cc):
            pm = jnp.where(smask, jnp.abs(cc) ** 2, -1.0)
            off = jnp.argmax(pm).astype(jnp.int32)
            return off, jdownmix._pick1(pm, off)

        off_dl, max_dl = peak(dl_c)
        off_ul, max_ul = peak(ul_c)
        is_dl = max_dl >= max_ul
        off = jnp.where(is_dl, off_dl, off_ul)
        cc = jnp.where(is_dl, dl_c, ul_c)
        corr_val = jdownmix._pick1(cc, off)
        interior = (off > 0) & (off < search_len - 1)
        pa = jnp.abs(jdownmix._pick1(cc, jnp.clip(off - 1, 0, n - 1))) ** 2
        pb = jnp.abs(corr_val) ** 2
        pg = jnp.abs(jdownmix._pick1(cc, jnp.clip(off + 1, 0, n - 1))) ** 2
        uw_corr = jnp.where(interior, jdownmix._quad_interp(pa, pb, pg),
                            0.0)
        sync_len = jnp.where(is_dl, c.dl_sync_len, c.ul_sync_len)
        pre_off = jnp.where(is_dl, dl_pre_off, ul_pre_off)
        uw_start = off - sync_len + 1 + pre_off
        ok &= (uw_start >= 0) & (uw_start < frame_len)
        cmag = jnp.abs(corr_val)
        pc = jnp.where(cmag > 0, jnp.conj(corr_val / cmag),
                       np.complex64(1.0))
        xa = xr * pc
        cf = (jp.center_frequency + k.astype(jnp.float32) / jp.fft_size
              * jp.sample_rate + fine_offset * jdmp.output_sample_rate)
        simplex = cf > jiridium.SIMPLEX_FREQUENCY_MIN
        max_len = jnp.where(
            simplex, np.int32(int(jiridium.MAX_FRAME_LENGTH_SIMPLEX * sps)),
            np.int32(int(jiridium.MAX_FRAME_LENGTH_NORMAL * sps)))
        min_len = jnp.where(
            simplex, np.int32(int(jiridium.MIN_FRAME_LENGTH_SIMPLEX * sps)),
            np.int32(int(jiridium.MIN_FRAME_LENGTH_NORMAL * sps)))
        available = frame_len - uw_start
        ok &= available >= min_len
        n_samples = jnp.minimum(available, max_len)
        out = jdownmix._shift_take(jnp.pad(xa, (0, pad_to2 - L_X)),
                                   jnp.clip(uw_start, 0, L_X), FRAME_CAP)
        out = jnp.where(np.arange(FRAME_CAP) < n_samples, out, 0.0)
        return (out, jnp.where(ok, n_samples, 0), ok,
                jnp.where(is_dl, jdownmix.DIR_DL, jdownmix.DIR_UL),
                start, fine_offset, uw_corr)
    return jax.vmap(one)


@pytest.mark.parametrize("i", range(len(EXTRACT_ROWS)), ids=EXTRACT_IDS)
def test_sync_extract_plain_matches_jax(extracts, i):
    port, jout = extracts["port"], extracts["jax"]
    for name in ("n_samples", "ok", "direction", "start_dec"):
        j = jout[port._fields.index(name)]
        assert getattr(port, name)[i].item() == j[i].item(), name
    for name in ("n_samples", "direction", "start_dec"):
        assert getattr(port, name).dtype == torch.int32
    _close(port.uw_corr[i].numpy(), jout[6][i], "uw_corr")
    assert np.array_equal(port.fine_offset.numpy(), jout[5])
    got, want = port.samples.numpy(), jout[0]
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got[i], want[i], rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_sync_extract_rows_exercise_the_edges(extracts):
    """UL where its peak is higher, the simplex band's longer frames, no
    search span gives the first fill (DL, offset 0), a zero correlation's
    phase is 1, the ends give no interpolation, uw_start below 0 and at
    frame_len fail ok, the extraction stops at the row's end."""
    out, (cc, xr, *_, k) = extracts["port"], extracts["args"]
    i = EXTRACT_IDS.index
    assert out.direction[i("ul")] == 1 and out.direction[i("dl")] == 0
    assert out.ok[i("dl")] and out.ok[i("ul")] and out.ok[i("simplex")]
    assert out.n_samples[i("simplex")] > out.n_samples[i("dl")]
    assert out.n_samples[i("normal_high")] == out.n_samples[i("dl")]
    for name in ("search_0", "search_neg", "search_1", "search_2",
                 "uw_start_negative", "uw_start_at_len", "short_for_min",
                 "zeros"):
        assert not out.ok[i(name)] and out.n_samples[i(name)] == 0, name
    for name in ("peak_at_0", "peak_at_end", "search_1", "search_2"):
        assert out.uw_corr[i(name)] == 0, name
    # a zero correlation (uw_start < 0: from 0) turns nothing: the
    # samples are xr's, up to the row's end
    b = i("zeros")
    n = min(L_X, k.max_len[1])
    assert torch.equal(out.samples[b, :n], xr[b, :n])
    assert not out.samples[b, n:].any()
    b = i("past_the_row")
    assert out.ok[b]
    assert 0 < int(torch.count_nonzero(out.samples[b])) < out.n_samples[b]


def test_downmix_goes_through_the_wrappers(setup, monkeypatch):
    """`Downmix.forward` on the CPU calls each step's wrapper by its module
    global, once a call, and the CPU wrappers are the twins."""
    dm = setup["dm"]
    rng = np.random.default_rng(25)
    B = 4
    x = ((rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L)))
         / 4).astype(np.complex64)
    x[:, 500:2500] *= 20
    i32 = torch.int32
    args = (torch.from_numpy(x),
            torch.tensor([L * 40 + 800, 60_000, 30_000, 900], dtype=i32),
            torch.tensor([4096, 4100, 5000, 4096], dtype=i32),
            torch.tensor([0, 30, 0, 0], dtype=i32))
    want = dm(*args)
    calls = []
    names = ("noise_box", "burst_start", "cfo_peak", "frame_rrc_sync",
             "sync_products", "sync_extract")
    for name in names:
        plain = getattr(downmix, name + "_plain")

        def wrapped(*a, name=name, plain=plain):
            calls.append(name)
            return plain(*a)
        monkeypatch.setattr(downmix, name, wrapped)
    got = dm(*args)
    assert calls == list(names)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


# (B, L) of every class batch of the 10 MHz, 400 MHz and 1.6 GHz decodes
# (tools/exp_downmix_chain.py `class_shapes`)
CLASS_BATCHES = [(1024, 8172), (96, 8172), (48, 28140), (32, 4749),
                 (24, 4749), (24, 28160), (32, 4679), (24, 4679),
                 (24, 28144)]


@pytest.mark.parametrize("B, L", CLASS_BATCHES)
def test_plan_gives_every_class_batch_a_layout(B, L):
    """Each class batch gets a cluster whose blocks reach the 132 SMs (or
    the largest the plan picks, 4), a staged part of filt that covers the
    row in 16-byte
    copies, and shared memory within a block's 232,448 bytes; stage 1's
    rows (the CFO FFT's 4,096) the same cluster."""
    p = downmix.plan(B, L)
    assert p.cluster in downmix.CLUSTERS
    assert (B * p.cluster >= downmix.SMS
            or p.cluster == downmix.DEFAULT_MAX_CLUSTER)
    assert p.cluster == 1 or B * p.cluster // 2 < downmix.SMS
    assert p.part % 4 == 0 and p.part * p.cluster >= L
    assert p.part - 4 < -(-L // p.cluster)
    assert p.smem == 4 * (p.part + 4) <= 232_448
    assert downmix.plan(B, 4096).cluster == p.cluster


def test_plan_refuses_what_the_kernel_does_not_take():
    """A cluster other than 1, 2, 4 or 8; a row whose part overflows a
    block's shared memory at a cluster of 8; no rows of nothing. A row too
    long for one block goes over a cluster."""
    for c in (0, 3, 16):
        with pytest.raises(ValueError):
            downmix.plan(10, 1000, cluster=c)
    with pytest.raises(ValueError):
        downmix.plan(1, 8 * 57_856 + 1)
    with pytest.raises(ValueError):
        downmix.plan(4, 0)
    with pytest.raises(ValueError):
        downmix.plan(200, 60_000, cluster=1)
    assert downmix.plan(200, 60_000).cluster == 2
    assert downmix.plan(1, 8 * 57_852).cluster == 8
    assert downmix.plan(0, 100).cluster == downmix.DEFAULT_MAX_CLUSTER


def test_chain_elsewhere_launches_the_kernel_only(setup, monkeypatch):
    """Tensors that are not on the CPU go to the kernel, one launch each
    with the C entry's counts and `plan`'s layout last, and never to the
    twins."""
    calls = []
    monkeypatch.setattr(downmix._kernels.DOWNMIX_CHAIN, "launch",
                        lambda device, *a: calls.append(a))
    monkeypatch.setattr(downmix._kernels, "ptr", lambda t: 0)
    for name in ("burst_start", "cfo_peak", "sync_products",
                 "sync_extract"):
        monkeypatch.setattr(downmix, name + "_plain", None)
    meta, k = torch.device("meta"), setup["k"]
    B, Lm = 40, 5000
    lay = downmix.plan(B, Lm)

    def e(dtype, *shape):
        return torch.empty(shape or (B,), dtype=dtype, device=meta)
    c64, i64 = torch.complex64, torch.int64
    downmix.burst_start(e(c64, B, Lm), e(torch.float32, B, Lm), e(i64),
                        e(i64), e(i64), e(torch.float32, 256), k)
    downmix.cfo_peak(e(c64, B, k.cfo_total))
    downmix.sync_products(e(c64, B, k.corr_n), e(c64, k.corr_n),
                          e(c64, k.corr_n))
    downmix.sync_extract(e(c64, 2, B, k.corr_n), e(c64, B, Lm), e(i64),
                         e(i64), e(torch.bool), e(i64), e(torch.float32), k)
    stages = [a[0] for a in calls]
    assert stages == [0, 1, 2, 3]
    counts = [(a[4], a[6], a[8]) for a in calls]
    assert counts == [(10, 7, 1), (4, 1, 0), (4, 0, 0), (13, 13, 4)]
    assert list(calls[0][5])[-2:] == [lay.cluster, lay.part]
    assert list(calls[1][5]) == [downmix.plan(B, k.cfo_total).cluster]
    assert list(calls[3][5])[-1] == lay.cluster
