"""Fused burst front-end: window gather + coarse-CFO rotate + decimating
FIR in one pass over the stream.

For burst b with window start w0 = tile * ALIGN + r (ops/window_gather.py)
and bin offset k:
    y[n]   = x[w0 + n] * ramp[(k * n) mod F]
    out[m] = sum_u taps[u] * y[m * decim + u],    m < l_win // decim
where ramp[m] = exp(-2*pi*i * m / F), computed as cos/sin of the f32 angle
(-2*pi/F) * m (the values of iridium_tpu/ops/fused_frontend.py
make_ramp_table :65-79). Outputs whose taps reach past the window read
the stream beyond it, as the TPU kernel does; the caller keeps only the
first dec_cap outputs, which lie inside the window.

`fused` launches csrc/fused_frontend.cu on CUDA planes and runs
`fused_plain` on CPU planes; `fused_plain` gathers, rotates and runs a
strided convolution. The kernel runs the FIR as 3xTF32 tensor-core
products (f32-grade: within 1e-5 of `fused_plain` at the production
shapes, where a single TF32 pass is ~1e-4 off).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .window_gather import ALIGN, TILE, _window_index

def supports(fft_size: int, decim: int, l_win: int) -> bool:
    """The shapes the fused path takes (iridium_tpu/ops/fused_frontend.py
    supports :54); the pipeline gathers windows otherwise."""
    return (fft_size % TILE == 0 and decim % 8 == 0
            and l_win % ALIGN == 0 and ALIGN % (TILE * decim) == 0)


def ramp_table(fft_size: int, device: torch.device) -> torch.Tensor:
    """(2, F) f32 cos and sin of (-2*pi/F) * m, m in [0, F)."""
    ang = torch.arange(fft_size, dtype=torch.float32, device=device) \
        * float(np.float32(-2.0 * np.pi / fft_size))
    return torch.stack([torch.cos(ang), torch.sin(ang)])


def rotate_decimate(x_re: torch.Tensor, x_im: torch.Tensor,
                    ks: torch.Tensor, ramp: torch.Tensor,
                    taps: torch.Tensor, decim: int, n_out: int):
    """Rotate (B, L) windows by their exact-integer-phase ramps and run
    the valid strided FIR: (B, n_out) f32 real and imaginary outputs,
    out[m] = sum_u taps[u] * y[m * decim + u].

    The ramp index (k n) mod F repeats every F samples: it is built for
    one period, (B, min(L, F)), and broadcast over the window's whole
    periods and its remainder, and each product goes straight into the
    FIR's input, so the rotation holds one (B, L) temporary beside its
    input and output (a 400 MHz large-class batch, 24 windows of 45 M
    samples, is 4.3 GB a plane). The products and their sums are the
    elementwise x_re c - x_im s and x_re s + x_im c, rounded as ever."""
    B, L = x_re.shape
    F = ramp.shape[1]
    n = torch.arange(min(L, F), device=x_re.device)
    mm = (ks.long()[:, None] % F) * n[None, :] % F
    c, s = ramp[0][mm], ramp[1][mm]
    y = torch.empty((2, B, L), dtype=x_re.dtype, device=x_re.device)
    P, R = divmod(L, F)
    # the whole periods as (B, P, F) views, then the remainder as (B, 1,
    # R), each against (B, 1, width) ramps
    for a, n_p, w in ((0, P, F), (P * F, 1, R)):
        if n_p * w == 0:
            continue
        xr, xi, y0, y1 = (t[..., a:a + n_p * w].view(*t.shape[:-1], n_p, w)
                          for t in (x_re, x_im, y[0], y[1]))
        cc, ss = c[:, None, :w], s[:, None, :w]
        torch.mul(xr, cc, out=y0)
        y0.sub_(xi * ss)
        torch.mul(xr, ss, out=y1)
        y1.add_(xi * cc)
    out = torch.nn.functional.conv1d(y.reshape(2 * B, 1, L),
                                     taps.reshape(1, 1, -1), stride=decim)
    out = out.reshape(2, B, -1)[:, :, :n_out]
    return out[0], out[1]


def fused_plain(planes: torch.Tensor, starts2: torch.Tensor,
                ks: torch.Tensor, taps: torch.Tensor, ramp: torch.Tensor,
                l_win: int, decim: int):
    n_out = l_win // decim
    span = (n_out - 1) * decim + taps.shape[0]
    idx, inside = _window_index(planes, starts2, span)
    zero = torch.zeros((), dtype=planes.dtype, device=planes.device)
    x_re = torch.where(inside, planes[0][idx], zero)
    x_im = torch.where(inside, planes[1][idx], zero)
    return rotate_decimate(x_re, x_im, ks, ramp, taps, decim, n_out)


def fused(planes: torch.Tensor, starts2: torch.Tensor, ks: torch.Tensor,
          taps: torch.Tensor, ramp: torch.Tensor, l_win: int, decim: int):
    """planes (2, N) f32, starts2 (B, 2) i32 [tile, r], ks (B,) i32 bin
    offsets, taps (ntaps,) f32, ramp (2, F) from ramp_table ->
    (B, l_win // decim) f32 real and imaginary outputs."""
    if planes.device.type == "cpu":
        return fused_plain(planes, starts2, ks, taps, ramp, l_win, decim)
    dev = planes.device
    B = starts2.shape[0]
    F = ramp.shape[1]
    ntaps = taps.shape[0]
    _kernels.check(planes, "planes", torch.float32, dev)
    _kernels.check(starts2, "starts2", torch.int32, dev, (B, 2))
    _kernels.check(ks, "ks", torch.int32, dev, (B,))
    _kernels.check(taps, "taps", torch.float32, dev)
    _kernels.check(ramp, "ramp", torch.float32, dev, (2, F))
    if planes.dim() != 2 or planes.shape[0] != 2:
        raise ValueError("planes must be (2, N)")
    if not supports(F, decim, l_win) or F >= 65536:
        raise ValueError(f"unsupported shape F={F} decim={decim} "
                         f"l_win={l_win}")
    n_out = l_win // decim
    out_re = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    out_im = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    if B == 0:
        return out_re, out_im
    # scratch: each burst's ramp in sample order (the kernel's first pass)
    rot = torch.empty((B, 2, F), dtype=torch.float32, device=dev)
    k = _kernels
    k.FUSED_FRONTEND.launch(
        dev, k.ptr(planes), planes.shape[1], k.ptr(starts2), k.ptr(ks),
        k.ptr(taps), k.ptr(ramp), B, l_win, F, decim, ntaps, ALIGN,
        k.ptr(out_re), k.ptr(out_im), k.ptr(rot))
    return out_re, out_im
