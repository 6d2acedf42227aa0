"""The fused front-end kernel's arithmetic, emulated on the CPU.

csrc/fused_frontend.cu runs the decimating FIR as TF32 tensor-core
products over a Toeplitz tap matrix (outputs in groups of N = 8):
    out[8s + c] = sum_k Y[s][k] T[k][c],  Y[s][k] = y[8 D s + k],
    T[k][c] = taps[k - D c],
with each operand split as hi (low 13 mantissa bits cleared) and
lo = cvt.rna.tf32(x - hi), and hi*hi + (hi*lo + lo*hi) summed in f32.
Products of two TF32 values are exact in f32, so f32 matrix products of
the split parts reproduce the kernel's terms. At the production taps the
split stays within 1e-5 of `fused_plain` (the tolerance chip_smoke.py and
the card tests hold the kernel to), and a single TF32 pass does not: the
tolerance tells the two apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from iridium_tpu_torch.ops import window_gather as wg  # noqa: E402
from iridium_tpu_torch.tools import exp_frontend  # noqa: E402

F, D = 8192, 40
MAX_ERR = 1e-5


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & -8192).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    i = x.view(torch.int32).long() & 0xFFFFFFFF
    r = ((i + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


def toeplitz_operands(planes, starts2, ks, taps, ramp, l_win):
    """Y (2, B, n_out / 8, K) rotated Hankel rows and T (K, 8)."""
    ntaps = taps.shape[0]
    n_out = l_win // D
    K = (7 * D + ntaps + 7) // 8 * 8
    span = (n_out // 8 - 1) * 8 * D + K
    idx, inside = wg._window_index(planes, starts2, span)
    x_re = torch.where(inside, planes[0][idx], 0.0)
    x_im = torch.where(inside, planes[1][idx], 0.0)
    n = torch.arange(span) % F
    mm = (ks.long()[:, None] % F) * n[None, :] % F
    c, s = ramp[0][mm], ramp[1][mm]
    y = torch.stack([x_re * c - x_im * s, x_re * s + x_im * c])
    k = torch.arange(K)[:, None] - D * torch.arange(8)[None, :]
    T = torch.where((k >= 0) & (k < ntaps), taps[k.clamp(0, ntaps - 1)],
                    torch.zeros(()))
    return y.unfold(2, K, 8 * D), T


def three_pass(Y, T):
    yh, th = tf32_hi(Y), tf32_hi(T)
    yl, tl = tf32_rna(Y - yh), tf32_rna(T - th)
    return yh @ th + (yh @ tl + yl @ th)


def one_pass(Y, T):
    return tf32_rna(Y) @ tf32_rna(T)


def _inputs():
    rng = np.random.default_rng(21)
    l_win = 2 * wg.ALIGN
    n = l_win + 3 * wg.ALIGN + 77
    planes = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    starts2 = torch.tensor([[-1, 39], [0, 0], [1, 17], [3, 39], [2, 5]],
                           dtype=torch.int32)
    ks = torch.tensor([-F // 2, F // 2 - 1, 0, 1, 2999], dtype=torch.int32)
    taps = torch.from_numpy(exp_frontend.production_taps())
    return planes, starts2, ks, taps, ff.ramp_table(F, torch.device("cpu")), \
        l_win


def test_tf32_split_parts():
    x = torch.tensor([1.0, -1.0 / 3.0, 3.14159265, 1e-3, -7.5e4, 0.0])
    hi = tf32_hi(x)
    lo = tf32_rna(x - hi)
    assert torch.equal(hi, tf32_rna(hi))          # hi is a TF32 value
    assert bool(((x - hi).abs() <= x.abs() * 2.0**-10).all())
    assert bool(((x - (hi + lo)).abs() <= x.abs() * 2.0**-21).all())
    # ties round away from zero
    one_tie = torch.tensor([1.0 + 2.0**-11]).view(torch.int32)
    assert tf32_rna(one_tie.view(torch.float32)).item() == 1.0 + 2.0**-10


@pytest.mark.parametrize("form,within", [(three_pass, True),
                                         (one_pass, False)])
def test_tf32_forms_against_plain(form, within):
    planes, starts2, ks, taps, ramp, l_win = _inputs()
    want = ff.fused_plain(planes, starts2, ks, taps, ramp, l_win, D)
    Y, T = toeplitz_operands(planes, starts2, ks, taps, ramp, l_win)
    got = form(Y, T).reshape(2, starts2.shape[0], -1)
    err = max(float((got[i] - want[i]).abs().max()) for i in range(2))
    assert (err <= MAX_ERR) == within, err


def test_toeplitz_form_in_f32_is_the_fir():
    """The Hankel x Toeplitz regrouping itself (no TF32 split) is the
    FIR: within f32 rounding of `fused_plain`."""
    planes, starts2, ks, taps, ramp, l_win = _inputs()
    want = ff.fused_plain(planes, starts2, ks, taps, ramp, l_win, D)
    Y, T = toeplitz_operands(planes, starts2, ks, taps, ramp, l_win)
    got = (Y @ T).reshape(2, starts2.shape[0], -1)
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-6)
