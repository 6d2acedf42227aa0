"""The port's burst front-end (iridium_tpu_torch/ops/window_gather.py and
fused_frontend.py) against the JAX package's Pallas kernels in interpret
mode and the float64 oracle of test_fused_frontend.py.

The window gather is a copy: bit-exact against both JAX gathers. The
fused front-end sums its FIR in another order than the TPU kernel's
bf16x3 dots and the oracle's float64, so it is held at test_fused_
frontend.py's tolerance (rtol 2e-4, atol 2e-3) on the valid outputs.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iridium_tpu.ops import fused_frontend as jff  # noqa: E402
from iridium_tpu.ops import window_gather as jwg  # noqa: E402
from iridium_tpu_torch.ops import filters  # noqa: E402
from iridium_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from iridium_tpu_torch.ops import window_gather as wg  # noqa: E402

from test_fused_frontend import D, F, L_WIN, NTAPS, oracle  # noqa: E402
from test_torch_kernels_cuda import GATHER_CASES, N_GATHER  # noqa: E402

CPU = torch.device("cpu")


def _stream(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _planes(stream):
    return torch.from_numpy(np.stack([stream.real, stream.imag]).copy())


@pytest.mark.parametrize("l_blocks,n,starts", [
    (1, 3 * wg.ALIGN, [[0, 0], [1, 0]]),
    (1, 3 * wg.ALIGN, [[0, 1], [1, 1]]),
    (1, 3 * wg.ALIGN, [[0, 39], [1, 39]]),
    (2, 5 * wg.ALIGN, [[0, 0], [0, 39], [1, 1], [2, 17], [1, 39], [0, 20]]),
    (1, 3 * wg.ALIGN + 64, [[2, 39], [2, 0]]),      # spill past the end
])
def test_window_gather_bit_exact(l_blocks, n, starts):
    l_win = l_blocks * wg.ALIGN
    stream = _stream(n, seed=l_blocks)
    starts2 = np.array(starts, np.int32)
    s = jnp.asarray(stream)
    planes = jwg.stream_planes(s)
    p_re, p_im = jwg.make_window_gather(l_win, interpret=True)(
        planes[0], planes[1], jnp.asarray(starts2))
    x_re, x_im = jwg.gather_windows_xla(
        jnp.pad(s, (0, wg.MAX_SHIFT + 128)), jnp.asarray(starts2), l_win)
    got = wg.gather(_planes(stream), torch.from_numpy(starts2), l_win)
    for g, pw, xw in zip(got, (p_re, p_im), (x_re, x_im)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(pw))
        np.testing.assert_array_equal(g.numpy(), np.asarray(xw))


@functools.lru_cache(maxsize=None)
def _jax_case_windows(l_win):
    """Every GATHER_CASES window at `l_win` through the Pallas gather in
    interpret mode and the XLA gather, in one call each (one compile per
    l_win), on the N_GATHER-sample stream with zeros after it: the windows
    that run past its end read zeros there, as the port's do."""
    stream = _stream(N_GATHER, seed=7)
    padded = jnp.asarray(np.concatenate(
        [stream, np.zeros(2 * wg.ALIGN + 128, np.complex64)]))
    starts2 = jnp.asarray(np.concatenate(
        [np.array(s, np.int32) for s in GATHER_CASES.values()]))
    planes = jwg.stream_planes(padded)
    pallas = jwg.make_window_gather(l_win, interpret=True)(
        planes[0], planes[1], starts2)
    xla = jwg.gather_windows_xla(padded, starts2, l_win)
    first, rows = 0, {}
    for name, s in GATHER_CASES.items():
        rows[name] = slice(first, first + len(s))
        first += len(s)
    return stream, rows, [np.asarray(a) for a in (*pallas, *xla)]


@pytest.mark.parametrize("l_win", [wg.ALIGN, 2 * wg.ALIGN])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_window_gather_fine_shifts_bit_exact(case, l_win):
    """The plain gather against both JAX gathers at the shifts the card's
    aligned loads take apart: r at every residue mod 4, r from 40 to 99,
    duplicated and unsorted starts, windows past the end of the planes."""
    stream, rows, (p_re, p_im, x_re, x_im) = _jax_case_windows(l_win)
    starts2 = torch.tensor(GATHER_CASES[case], dtype=torch.int32)
    got = wg.gather(_planes(stream), starts2, l_win)
    sl = rows[case]
    for g, pw, xw in zip(got, (p_re[sl], p_im[sl]), (x_re[sl], x_im[sl])):
        np.testing.assert_array_equal(g.numpy(), pw)
        np.testing.assert_array_equal(g.numpy(), xw)
    ends = (starts2[:, 0] * wg.ALIGN + starts2[:, 1] + l_win).tolist()
    assert (max(ends) > N_GATHER) == (case == "past_the_end")


def test_fused_plain_matches_pallas_and_oracle():
    taps = filters.lpf_taps(1.0, 10_000_000.0, 100_000.0, 50_000.0)
    assert len(taps) == NTAPS
    cases = [(0, 0, 7), (1, 3, -100), (0, 7, 250), (2, 1, 0), (1, 5, -255)]
    stream = _stream(L_WIN + 4 * wg.ALIGN, seed=3)
    starts2 = np.array([[t, r] for t, r, _ in cases], np.int32)
    ks = np.array([k for _, _, k in cases], np.int32)

    s = jnp.asarray(stream)
    planes = jwg.stream_planes(s)
    fn = jff.make_fused_frontend(L_WIN, F, D, np.asarray(taps),
                                 interpret=True)
    j_re, j_im = fn(jff.stack_planes(planes[0], planes[1]),
                    jnp.asarray(starts2), jff.make_ramp_table(F)(
                        jnp.asarray(ks)))
    assert ff.supports(F, D, L_WIN)
    got_re, got_im = ff.fused(_planes(stream), torch.from_numpy(starts2),
                              torch.from_numpy(ks), torch.from_numpy(taps),
                              ff.ramp_table(F, CPU), L_WIN, D)
    got = got_re.numpy() + 1j * got_im.numpy()
    jax_out = np.asarray(j_re) + 1j * np.asarray(j_im)
    n_cmp = (L_WIN - NTAPS) // D
    for i, (t, r, k) in enumerate(cases):
        want = oracle(stream, t, r, k, np.asarray(taps))
        np.testing.assert_allclose(got[i, :n_cmp], want[:n_cmp],
                                   rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(got[i, :n_cmp], jax_out[i, :n_cmp],
                                   rtol=2e-4, atol=2e-3)


def test_ramp_table_matches_jax():
    ks = np.array([-256, -3, 0, 1, 255], np.int32)
    want = np.asarray(jff.make_ramp_table(F)(jnp.asarray(ks)))
    ramp = ff.ramp_table(F, CPU).numpy()
    m = (ks.astype(np.int64)[:, None] * np.arange(F)) % F
    got = np.stack([ramp[0][m], ramp[1][m]], 1).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize("F,L", [(64, 40), (64, 64), (64, 200),
                                 (128, 1000)])
def test_rotate_decimate_by_ramp_period(F, L):
    """`rotate_decimate` builds the ramp index for one period of F samples
    and broadcasts it (so that a 400 MHz batch of 45 M-sample windows
    needs no (B, L) int64 index): bit-equal to the rotation indexed
    sample by sample, for windows shorter than, equal to and longer than
    a period, with and without a remainder, and for negative bins."""
    rng = np.random.default_rng(3)
    B, decim = 5, 8
    x_re = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    x_im = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    ks = torch.tensor([0, 1, -3, F // 2 - 1, 2 * F + 5], dtype=torch.int32)
    ramp = ff.ramp_table(F, torch.device("cpu"))
    taps = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    n_out = (L - 7) // decim + 1
    got = ff.rotate_decimate(x_re, x_im, ks, ramp, taps, decim, n_out)
    mm = (ks.long()[:, None] % F) * (torch.arange(L) % F)[None, :] % F
    c, s = ramp[0][mm], ramp[1][mm]
    y = torch.stack([x_re * c - x_im * s, x_re * s + x_im * c])
    want = torch.nn.functional.conv1d(
        y.reshape(2 * B, 1, L), taps.reshape(1, 1, -1),
        stride=decim).reshape(2, B, -1)[:, :, :n_out]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("per_slice", [1, 3, 4])
def test_class_gathers_windows_in_slices(monkeypatch, per_slice):
    """A class batch of the gather path whose windows would gather more
    than GATHER_BYTES at once runs in slices of windows (the 1.6 GHz large
    class: 24 windows of 180 M samples), each gathered, rotated and
    filtered alone, so that the rotation's temporaries are bounded too:
    bit-equal to the batch at once, in slices of one window, and of
    several windows that do and do not divide the batch."""
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.runtime import pipeline as pl
    pipe = pl.Pipeline(det_cfg=DetectorConfig(sample_rate=1_000_000),
                       device="cpu", burst_batch=8)
    cls = pipe.classes[0]
    assert not cls.fused and cls.batch >= 8
    rng = np.random.default_rng(5)
    n = 4 * cls.l_win
    planes = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    starts2 = torch.from_numpy(np.stack([
        rng.integers(0, (n - cls.l_win) // wg.ALIGN, cls.batch),
        rng.integers(0, cls.decim, cls.batch)], 1).astype(np.int32))
    ks = torch.from_numpy(rng.integers(-500, 500, cls.batch).astype(np.int32))
    whole = cls._gather_rotate(planes, starts2, ks)
    monkeypatch.setattr(pl, "GATHER_BYTES", per_slice * 8 * cls.l_win)
    sliced = cls._gather_rotate(planes, starts2, ks)
    assert torch.equal(sliced[0], whole[0]) and torch.equal(sliced[1], whole[1])
