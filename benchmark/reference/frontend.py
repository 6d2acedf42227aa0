"""The burst front-end in plain PyTorch: window gather, coarse-CFO
rotation and the decimating FIR.

Frozen copy of `iridium_tpu_torch/ops/window_gather.py` (`_window_index`,
the window start contract) and `iridium_tpu_torch/ops/fused_frontend.py`
(`ramp_table`, `rotate_decimate`, `fused_plain`). For burst b with window
start w0 = tile * ALIGN + r and bin offset k:
    y[n]   = x[w0 + n] * ramp[(k * n) mod F]
    out[m] = sum_u taps[u] * y[m * decim + u],    m < l_win // decim

`tf32=True` rounds the FIR's inputs (the rotated window and the taps) to
TF32's 10-bit mantissa before an f32 convolution: the products of one
TF32 tensor-core pass, the precision below the f32 the configuration
states. It is the benchmark's control, never its reference.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 128
R_ROWS = 160
ALIGN = TILE * R_ROWS          # 20480 samples; a multiple of 128 and 40


def _window_index(planes: torch.Tensor, starts2: torch.Tensor,
                  length: int):
    n = planes.shape[1]
    s = starts2[:, 0].long() * ALIGN + starts2[:, 1].long()
    idx = s[:, None] + torch.arange(length, device=planes.device)
    inside = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), inside


def ramp_table(fft_size: int, device: torch.device) -> torch.Tensor:
    """(2, F) f32 cos and sin of (-2*pi/F) * m, m in [0, F)."""
    ang = torch.arange(fft_size, dtype=torch.float32, device=device) \
        * float(np.float32(-2.0 * np.pi / fft_size))
    return torch.stack([torch.cos(ang), torch.sin(ang)])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    b = x.contiguous().view(torch.int32).long()
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return (b - ((b >> 31) << 32)).int().view(torch.float32)


def rotate_decimate(x_re: torch.Tensor, x_im: torch.Tensor,
                    ks: torch.Tensor, ramp: torch.Tensor,
                    taps: torch.Tensor, decim: int, n_out: int,
                    tf32: bool = False):
    """Rotate (B, L) windows by their exact-integer-phase ramps and run
    the valid strided FIR: (B, n_out) f32 real and imaginary outputs,
    out[m] = sum_u taps[u] * y[m * decim + u]."""
    B, L = x_re.shape
    F = ramp.shape[1]
    n = torch.arange(min(L, F), device=x_re.device)
    mm = (ks.long()[:, None] % F) * n[None, :] % F
    c, s = ramp[0][mm], ramp[1][mm]
    y = torch.empty((2, B, L), dtype=x_re.dtype, device=x_re.device)
    P, R = divmod(L, F)
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
    if tf32:
        y, taps = round_tf32(y), round_tf32(taps)
    out = torch.nn.functional.conv1d(y.reshape(2 * B, 1, L),
                                     taps.reshape(1, 1, -1), stride=decim)
    out = out.reshape(2, B, -1)[:, :, :n_out]
    return out[0], out[1]


def fused_plain(planes: torch.Tensor, starts2: torch.Tensor,
                ks: torch.Tensor, taps: torch.Tensor, ramp: torch.Tensor,
                l_win: int, decim: int, tf32: bool = False):
    """planes (2, N) f32, starts2 (B, 2) [tile, r], ks (B,) bin offsets ->
    (B, l_win // decim) f32 real and imaginary outputs."""
    n_out = l_win // decim
    span = (n_out - 1) * decim + taps.shape[0]
    idx, inside = _window_index(planes, starts2, span)
    zero = torch.zeros((), dtype=planes.dtype, device=planes.device)
    x_re = torch.where(inside, planes[0][idx], zero)
    x_im = torch.where(inside, planes[1][idx], zero)
    return rotate_decimate(x_re, x_im, ks, ramp, taps, decim, n_out, tf32)
