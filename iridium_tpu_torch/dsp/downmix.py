"""Batched per-burst downmix chain, after the front-end has rotated and
decimated each burst window.

Port of iridium_tpu/dsp/downmix.py (`make_consts` :95, `generate_sync_word`
:66, `downmix_from_dec` :387-531). The JAX module's TPU workarounds
(`_shift_take`, `_pick1`: dynamic addressing without dynamic-address ops)
are plain indexing here and give the same values. Reference sources
(burst_downmix.c): noise LPF :682-698, burst start :441-478, fine CFO
:482-535, RRC :723-734, sync correlation :539-639, phase align and
extraction :749-793.

The three small FIRs (25, 20 and 51 taps) with their masks are
`noise_box` (the noise LPF, the re-zeroing, |x|^2 and the box filter) and
`frame_rrc` (the frame gather, its mask, the fine rotation and the RRC
matched filter; `frame_rrc_sync` also writes the sync search's input):
on a CUDA tensor a launch each of csrc/downmix_fir.cu, on a CPU tensor
their plain versions `noise_box_plain` and `frame_rrc_plain` (with
`sync_input_plain`), whose FIRs are shifted adds (`fir_valid_small`) with
the JAX package's sequential f32 accumulation order (`_fir_valid_small`,
`_fir_same_c` :132-164).

The steps around the FIRs and the three FFTs (torch.fft, cuFFT on the
card) are four launches of csrc/downmix_chain.cu on a CUDA tensor:
`burst_start` (the burst start and the fine CFO estimate's input),
`cfo_peak` (the fine CFO's peak), `sync_products` (the correlation's
template products) and `sync_extract` (the sync peaks and the choice,
phase align, extraction), the first, second and fourth a row to a cluster
of `plan`'s blocks; on a CPU tensor their plain versions, the tensor code
`Downmix.forward` ran before the kernel (`burst_start_plain`,
`cfo_peak_plain`, `sync_products_plain`, `sync_extract_plain`).
`Downmix.forward` calls every wrapper by its module global, so that a
caller can wrap or swap it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels, iridium
from ..config import DetectorParams, DownmixParams
from ..ops import filters, windows

RRC_NTAPS = 51
RC_NTAPS = 51
RRC_ALPHA = 0.4
START_THRESHOLD = 0.45
DIR_DL = 0
DIR_UL = 1
MAX_TAPS = 64       # csrc/downmix_fir.cu's limit, the JAX _SMALL_FIR_MAX


class DownmixConsts(NamedTuple):
    """Host-precomputed numpy constants for the downmix chain."""
    input_taps: np.ndarray      # (801,) f32 anti-alias decimation FIR
    noise_taps: np.ndarray      # (25,) f32
    box_taps: np.ndarray        # (20,) f32
    rrc_taps: np.ndarray        # (51,) f32
    cfo_window: np.ndarray      # (cfo_fft_size,) f32 Blackman
    dl_sync_fft: np.ndarray     # (corr_fft,) c64
    ul_sync_fft: np.ndarray     # (corr_fft,) c64
    dl_sync_len: int
    ul_sync_len: int


def generate_sync_word(dmp: DownmixParams, uw, preamble_len: int,
                       is_uplink: bool, rc: np.ndarray):
    """Correlation template: preamble+UW symbols, upsampled, RC-shaped,
    reversed+conjugated, FFT'd (reference burst_downmix.c:138-219)."""
    s0 = np.complex64(1 + 1j)
    s1 = np.complex64(-1 - 1j)
    if is_uplink:
        pre = [s1 if i % 2 == 0 else s0 for i in range(preamble_len)]
    else:
        pre = [s0] * preamble_len
    symbols = np.array(pre + [s0 if u == 0 else s1 for u in uw],
                       dtype=np.complex64)
    isps = int(round(dmp.samples_per_symbol))
    padded_len = len(symbols) * isps - (isps - 1)
    padded = np.zeros(padded_len, np.complex64)
    padded[::isps] = symbols
    half = (len(rc) - 1) // 2
    buf = np.concatenate([np.zeros(half, np.complex64), padded,
                          np.zeros(len(rc) - 1 - half, np.complex64)])
    # fir_filter_ccf is a correlation: out[i] = sum_k taps[k] * in[i+k]
    shaped = (np.correlate(buf.real, rc, mode="valid")
              + 1j * np.correlate(buf.imag, rc, mode="valid")
              ).astype(np.complex64)
    template = np.conj(shaped[::-1])
    padded_fft = np.zeros(dmp.corr_fft_size, np.complex64)
    padded_fft[:padded_len] = template
    return np.fft.fft(padded_fft).astype(np.complex64), padded_len


def make_consts(dmp: DownmixParams) -> DownmixConsts:
    out_rate = float(dmp.output_sample_rate)
    # Input anti-alias filter designed at a FIXED 10 MHz rate regardless of
    # the true input rate (reference burst_downmix.c:250-261)
    input_taps = filters.lpf_taps(1.0, 10_000_000.0, out_rate * 0.4,
                                  out_rate * 0.2)
    noise_taps = filters.lpf_taps(1.0, out_rate, 40_000.0 / 2.0, 40_000.0)
    box_len = max(int(dmp.samples_per_symbol * 2), 3)
    box = filters.box_taps(box_len)
    rrc = filters.rrc_taps(1.0, out_rate, iridium.SYMBOLS_PER_SECOND,
                           RRC_ALPHA, RRC_NTAPS)
    rc = filters.rc_taps(out_rate, iridium.SYMBOLS_PER_SECOND,
                         RRC_ALPHA, RC_NTAPS)
    cfo_win = windows.blackman(dmp.cfo_fft_size)
    dl_fft, dl_len = generate_sync_word(
        dmp, iridium.UW_DL, iridium.PREAMBLE_LENGTH_SHORT, False, rc)
    ul_fft, ul_len = generate_sync_word(
        dmp, iridium.UW_UL, iridium.PREAMBLE_LENGTH_SHORT, True, rc)
    return DownmixConsts(input_taps, noise_taps, box, rrc, cfo_win,
                         dl_fft, ul_fft, dl_len, ul_len)


def fir_valid_small(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Valid correlation FIR along dim 1, out[i] = sum_k taps[k] x[i+k],
    as shifted f32 adds in tap order. x is real, (B, L) or (B, L, 2); taps
    (T,) f32 on x's device (a tap is a 0-d tensor: nothing is copied from
    the host, so the FIR can be captured into a CUDA graph)."""
    n_out = x.shape[1] - len(taps) + 1
    acc = None
    for k, c in enumerate(taps):
        term = c * x[:, k:k + n_out]
        acc = term if acc is None else acc + term
    return acc


def fir_same_c(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Centred same-length FIR of complex (B, L) rows (the reference pads
    with zeros and runs valid: burst_downmix.c:686-693)."""
    t = len(taps)
    half = (t - 1) // 2
    xr = torch.view_as_real(x)
    B = xr.shape[0]
    xp = torch.cat([xr.new_zeros((B, half, 2)), xr,
                    xr.new_zeros((B, t - 1 - half, 2))], dim=1)
    return torch.view_as_complex(fir_valid_small(xp, taps).contiguous())


def noise_box_plain(x: torch.Tensor, dec_len: torch.Tensor,
                    shift_dec: torch.Tensor, noise_taps: torch.Tensor,
                    box_taps: torch.Tensor):
    """The decimated rows x (B, L) c64 kept where shift_dec <= i < dec_len
    ((B,) i64), through the noise LPF ("same"; skipped for very short
    bursts, burst_downmix.c:684-697), re-zeroed outside the kept samples
    (the LPF smears burst energy into the alignment lead) -> xd (B, L)
    c64; and the box filter over |xd|^2 padded with zeros (the burst
    start's energy, burst_downmix.c:441-478) -> filt (B, L) f32."""
    dev = x.device
    B, L = x.shape
    iota = torch.arange(L, device=dev)
    zero_c = torch.zeros((), dtype=torch.complex64, device=dev)
    keep = (iota < dec_len[:, None]) & (iota >= shift_dec[:, None])
    x = torch.where(keep, x, zero_c)
    nl = fir_same_c(x, noise_taps)
    xd = torch.where((dec_len - len(noise_taps) + 1 > 0)[:, None], nl, x)
    xd = torch.where(keep, xd, zero_c)
    mag2 = xd.abs() ** 2
    filt = fir_valid_small(
        torch.cat([mag2, mag2.new_zeros((B, len(box_taps) - 1))], 1),
        box_taps)
    return xd, filt


def rrc_plain(xf: torch.Tensor, frame_len: torch.Tensor,
              rrc_taps: torch.Tensor) -> torch.Tensor:
    """The frames xf (B, L) c64 below frame_len ((B,) i64) through the RRC
    matched filter ("same") -> (B, L) c64."""
    iota = torch.arange(xf.shape[1], device=xf.device)
    zero_c = torch.zeros((), dtype=torch.complex64, device=xf.device)
    xf = torch.where(iota < frame_len[:, None], xf, zero_c)
    return fir_same_c(xf, rrc_taps)


def frame_rrc_plain(xd: torch.Tensor, start: torch.Tensor,
                    frame_len: torch.Tensor, u: torch.Tensor,
                    corr: torch.Tensor, rrc_taps: torch.Tensor,
                    cfo_total: int) -> torch.Tensor:
    """The frame of xd (B, L) c64 from start ((B,) i64; 0 past the row),
    kept below frame_len, turned by the fine CFO (the integer bin u (B,)
    i64 exact, the fraction corr (B,) f32 in f32, over 2 cfo_total), and
    through the RRC matched filter (`rrc_plain`) -> (B, L) c64."""
    iota = torch.arange(xd.shape[1], device=xd.device)
    zero_c = torch.zeros((), dtype=torch.complex64, device=xd.device)
    # frame gather: the frame starts at index 0
    xf = shift_take(xd, start, xd.shape[1])
    xf = torch.where(iota < frame_len[:, None], xf, zero_c)
    # fine rotate: integer part exact, fraction in f32
    two_total = 2 * cfo_total
    mfine = ((u[:, None] * iota) % two_total).float()
    frac = (corr[:, None] * iota.float()) / two_total
    angf = float(np.float32(-2.0 * np.pi)) * (mfine / two_total + frac)
    xf = xf * torch.complex(torch.cos(angf), torch.sin(angf))
    return rrc_plain(xf, frame_len, rrc_taps)


def _check_rows(x: torch.Tensor, lengths: dict, taps: dict) -> None:
    """Raise unless x is a contiguous (B, L) c64 tensor, each of
    `lengths` a (B,) i64 and each of `taps` a (1..MAX_TAPS,) f32 tensor on
    its device."""
    dev = x.device
    _kernels.check(x, "x", torch.complex64, dev)
    if x.dim() != 2:
        raise ValueError(f"x must be (B, L), got {tuple(x.shape)}")
    for name, t in lengths.items():
        _kernels.check(t, name, torch.int64, dev, (x.shape[0],))
    for name, t in taps.items():
        _kernels.check(t, name, torch.float32, dev)
        if t.dim() != 1 or not 1 <= t.shape[0] <= MAX_TAPS:
            raise ValueError(f"{name}: the kernel takes 1 to {MAX_TAPS} "
                             f"taps, got shape {tuple(t.shape)}")


def noise_box(x: torch.Tensor, dec_len: torch.Tensor,
              shift_dec: torch.Tensor, noise_taps: torch.Tensor,
              box_taps: torch.Tensor):
    """`noise_box_plain`'s function: on a CPU tensor `noise_box_plain`, on
    a CUDA tensor one launch of csrc/downmix_fir.cu (stage 0), or a
    raise."""
    if x.device.type == "cpu":
        return noise_box_plain(x, dec_len, shift_dec, noise_taps, box_taps)
    _check_rows(x, dict(dec_len=dec_len, shift_dec=shift_dec),
                dict(noise_taps=noise_taps, box_taps=box_taps))
    B, L = x.shape
    xd = torch.empty_like(x)
    filt = torch.empty((B, L), dtype=torch.float32, device=x.device)
    if xd.numel():
        k = _kernels
        k.DOWNMIX_FIR.launch(x.device, 0, k.ptr(x), B, L, k.ptr(dec_len),
                             k.ptr(shift_dec), None, None, 0,
                             k.ptr(noise_taps),
                             noise_taps.shape[0], k.ptr(box_taps),
                             box_taps.shape[0], k.ptr(xd), k.ptr(filt),
                             None, 0, 0)
    return xd, filt


def frame_rrc(xd: torch.Tensor, start: torch.Tensor,
              frame_len: torch.Tensor, u: torch.Tensor, corr: torch.Tensor,
              rrc_taps: torch.Tensor, cfo_total: int) -> torch.Tensor:
    """`frame_rrc_plain`'s function: on a CPU tensor `frame_rrc_plain`, on
    a CUDA tensor one launch of csrc/downmix_fir.cu (stage 1), or a raise.
    The kernel takes the fine rotation's 2 cfo_total as a power of two up
    to 2^24 (the downmix's always is)."""
    if xd.device.type == "cpu":
        return frame_rrc_plain(xd, start, frame_len, u, corr, rrc_taps,
                               cfo_total)
    return _frame_rrc_launch(xd, start, frame_len, u, corr, rrc_taps,
                             cfo_total)


def frame_rrc_sync(xd: torch.Tensor, start: torch.Tensor,
                   frame_len: torch.Tensor, u: torch.Tensor,
                   corr: torch.Tensor, rrc_taps: torch.Tensor,
                   cfo_total: int, search_cap: int, corr_n: int):
    """`frame_rrc_sync_plain`'s function: on a CPU tensor
    `frame_rrc_sync_plain`, on a CUDA tensor one launch of
    csrc/downmix_fir.cu (stage 1, which also writes the sync search's
    input), or a raise. -> (xr (B, L), fwd_in (B, corr_n)) c64."""
    if xd.device.type == "cpu":
        return frame_rrc_sync_plain(xd, start, frame_len, u, corr, rrc_taps,
                                    cfo_total, search_cap, corr_n)
    if not 0 <= search_cap <= min(xd.shape[-1], corr_n) or corr_n >= 1 << 30:
        raise ValueError(f"search_cap {search_cap} must lie in [0, L] and "
                         f"[0, corr_n {corr_n}]")
    sync = torch.empty((xd.shape[0], corr_n), dtype=torch.complex64,
                       device=xd.device)
    xr = _frame_rrc_launch(xd, start, frame_len, u, corr, rrc_taps,
                           cfo_total, sync, search_cap)
    if not xr.numel():
        sync.zero_()
    return xr, sync


def _frame_rrc_launch(xd, start, frame_len, u, corr, rrc_taps, cfo_total,
                      sync=None, search_cap: int = 0) -> torch.Tensor:
    """Check the arguments and launch stage 1 of csrc/downmix_fir.cu,
    with the sync buffer `sync` (or none): xr."""
    _check_rows(xd, dict(start=start, frame_len=frame_len, u=u),
                dict(rrc_taps=rrc_taps))
    _kernels.check(corr, "corr", torch.float32, xd.device, (xd.shape[0],))
    two_total = 2 * int(cfo_total)
    if not 0 < two_total <= 1 << 24 or two_total & (two_total - 1):
        raise ValueError(f"cfo_total: the kernel takes 2 cfo_total as a "
                         f"power of two up to 2^24, got {cfo_total}")
    B, L = xd.shape
    xr = torch.empty_like(xd)
    if xr.numel():
        k = _kernels
        k.DOWNMIX_FIR.launch(xd.device, 1, k.ptr(xd), B, L,
                             k.ptr(frame_len), k.ptr(start), k.ptr(u),
                             k.ptr(corr), two_total, k.ptr(rrc_taps),
                             rrc_taps.shape[0], None, 0, k.ptr(xr), None,
                             None if sync is None else k.ptr(sync),
                             search_cap, 0 if sync is None else sync.shape[1])
    return xr


def shift_take(x: torch.Tensor, start: torch.Tensor,
               out_len: int) -> torch.Tensor:
    """out[b, i] = x[b, start[b] + i], 0 past the end of the row."""
    L = x.shape[1]
    idx = start.long()[:, None] + torch.arange(out_len, device=x.device)
    inside = idx < L
    xr = torch.view_as_real(x)
    g = torch.gather(xr, 1, idx.clamp(0, L - 1)[:, :, None].expand(
        -1, -1, 2))
    return torch.view_as_complex(
        torch.where(inside[:, :, None], g, 0.0).contiguous())


def _quad_interp(alpha, beta, gamma):
    """Three-point quadratic peak interpolation with the reference's
    denominator guard (burst_downmix.c:526-528)."""
    denom = alpha - 2.0 * beta + gamma
    return torch.where(denom.abs() > 1e-10,
                       0.5 * (alpha - gamma) / denom,
                       torch.zeros_like(denom))


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rows x (B, m) zero-padded to (B, n), as torch.fft's n= pads them."""
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1]))], 1)


class DownmixOut(NamedTuple):
    samples: torch.Tensor      # (B, max_frame_cap) c64 from uw_start
    n_samples: torch.Tensor    # (B,) i32 extract length
    ok: torch.Tensor           # (B,) bool
    direction: torch.Tensor    # (B,) i32 (0=DL, 1=UL)
    start_dec: torch.Tensor    # (B,) i32 decimated-domain start
    fine_offset: torch.Tensor  # (B,) f32 fractional CFO (of output rate)
    uw_corr: torch.Tensor      # (B,) f32 sub-sample UW start correction


class ChainConsts(NamedTuple):
    """The downmix chain's scalars (`Downmix.chain`), which
    csrc/downmix_chain.cu takes by value."""
    decim: int                 # input samples a decimated sample
    box_ntaps: int             # the burst start's box filter
    pre_start: int             # decimated samples kept before the start
    cfo_total: int             # the fine CFO FFT's padded size
    search_cap: int            # the sync search's longest span
    corr_n: int                # the sync correlation's FFT size
    sync_len: tuple            # (DL, UL) correlation template lengths
    pre_off: tuple             # (DL, UL) samples from the template's start
                               # to the unique word
    max_len: tuple             # (simplex, normal) longest frame, samples
    min_len: tuple             # (simplex, normal) shortest frame, samples
    max_frame_cap: int         # the extracted rows' length
    fft_size: int              # the detector's FFT (center_bin's bins)
    center_frequency: float
    in_rate: float
    out_rate: float


# The downmix chain's steps around its FIRs and FFTs, `Downmix.forward`'s
# tensor code as it ran before csrc/downmix_chain.cu (the twins), and
# their wrappers: on a CPU tensor the twin, on a CUDA tensor a launch of
# the kernel, or a raise.

def burst_start_plain(xd: torch.Tensor, filt: torch.Tensor,
                      ext_len: torch.Tensor, dec_len: torch.Tensor,
                      shift_dec: torch.Tensor, cfo_win: torch.Tensor,
                      k: ChainConsts):
    """The burst start (burst_downmix.c:441-478) from the box filter's
    energy filt (B, L) f32 of xd (B, L) c64, and the fine CFO estimate's
    input: ext_len, dec_len, shift_dec (B,) i64 -> start, frame_len (B,)
    i64; ok (B,) bool (the window and the decimated row long enough
    behind the lead, the start early enough); z (B, cfo_total) c64, the
    frame's first len(cfo_win) samples below frame_len squared and
    windowed, zero-padded."""
    dev = xd.device
    iota = torch.arange(filt.shape[1], device=dev)
    zero_c = torch.zeros((), dtype=torch.complex64, device=dev)
    ok = ext_len - shift_dec * k.decim >= 100
    ok &= dec_len - shift_dec >= 100
    flen = torch.clamp(dec_len - k.box_ntaps + 1, min=0)
    fmask = iota < flen[:, None]
    filt_m = torch.where(fmask, filt, -torch.inf)
    thr = START_THRESHOLD * filt_m.max(1).values
    hit = fmask & (filt >= thr[:, None])
    first = torch.where(hit.any(1), hit.int().argmax(1), flen)
    box_half = (k.box_ntaps - 1) // 2
    start = torch.where(
        first > shift_dec,
        torch.maximum(first + box_half - k.pre_start, shift_dec),
        shift_dec)
    start = torch.where(flen > 0, start, shift_dec)
    ok &= start < dec_len - 100
    frame_len = dec_len - start
    # fine CFO: squared signal, x16 zero-padded FFT, quadratic peak, on
    # the frame's first cfo_n samples (from start, below frame_len)
    cfo_n = cfo_win.shape[0]
    ncfo = torch.clamp(frame_len, max=cfo_n)
    z = shift_take(xd, start, cfo_n)
    z = torch.where(torch.arange(cfo_n, device=dev) < ncfo[:, None],
                    z * z * cfo_win, zero_c)
    return start, frame_len, ok, _pad(z, k.cfo_total)


def cfo_peak_plain(spec: torch.Tensor):
    """The fine CFO from the FFT spec (B, cfo_total) c64 of the squared
    frame (burst_downmix.c:482-535): its first |spec|^2 peak as the signed
    bin u (B,) i64, the quadratic interpolation corr (B,) f32 (0 at the
    ends), fine_offset (B,) f32 = (u + corr) / cfo_total / 2."""
    B, n = spec.shape
    rows = torch.arange(B, device=spec.device)
    p = spec.abs() ** 2
    idx = p.argmax(1)
    u = torch.where(idx >= n // 2, idx - n, idx)
    interior = (idx > 0) & (idx < n - 1)
    a = p[rows, torch.clamp(idx - 1, 0, n - 1)]
    b_ = p[rows, idx]
    g = p[rows, torch.clamp(idx + 1, 0, n - 1)]
    corr = torch.where(interior, _quad_interp(a, b_, g),
                       torch.zeros_like(a))
    fine_offset = (u.float() + corr) / n / 2.0
    return u, corr, fine_offset


def sync_input_plain(xr: torch.Tensor, frame_len: torch.Tensor,
                     search_cap: int, corr_n: int) -> torch.Tensor:
    """The sync-word search's input: xr (B, L) c64 below min(frame_len,
    search_cap), zero-padded to (B, corr_n) (burst_downmix.c:539-560)."""
    search_len = torch.clamp(frame_len, max=search_cap)
    zero_c = torch.zeros((), dtype=torch.complex64, device=xr.device)
    fwd_in = torch.where(
        torch.arange(search_cap, device=xr.device) < search_len[:, None],
        xr[:, :search_cap], zero_c)
    return _pad(fwd_in, corr_n)


def frame_rrc_sync_plain(xd, start, frame_len, u, corr, rrc_taps,
                         cfo_total: int, search_cap: int, corr_n: int):
    """`frame_rrc_plain`, then `sync_input_plain` of its output."""
    xr = frame_rrc_plain(xd, start, frame_len, u, corr, rrc_taps, cfo_total)
    return xr, sync_input_plain(xr, frame_len, search_cap, corr_n)


def sync_products_plain(fwd: torch.Tensor, dl_fft: torch.Tensor,
                        ul_fft: torch.Tensor) -> torch.Tensor:
    """The search's spectrum fwd (B, corr_n) c64 times each template's
    (corr_n,) c64 -> (2, B, corr_n) c64, DL then UL, for one inverse FFT."""
    return torch.stack([fwd * dl_fft, fwd * ul_fft])


def sync_extract_plain(cc: torch.Tensor, xr: torch.Tensor,
                       start: torch.Tensor, frame_len: torch.Tensor,
                       ok: torch.Tensor, center_bin: torch.Tensor,
                       fine_offset: torch.Tensor, k: ChainConsts
                       ) -> DownmixOut:
    """From the two correlations cc (2, B, corr_n) c64 (DL, UL) and the
    filtered frames xr (B, L) c64: each one's |cc|^2 peak below
    min(frame_len, search_cap), DL where its peak is at least UL's, the
    UW's start and sub-sample correction (burst_downmix.c:539-639); the
    phase align by the peak's phase and the extraction from the UW's start
    (:749-793), whose simplex/normal lengths need the absolute frequency
    (:763-770; f32 as in the JAX package, the printed frequency is rebuilt
    on the host); start, frame_len, center_bin (B,) i64, ok (B,) bool,
    fine_offset (B,) f32 -> the DownmixOut."""
    dev = xr.device
    B, L = xr.shape
    corr_n = cc.shape[2]
    rows = torch.arange(B, device=dev)
    dl_c, ul_c = cc[0], cc[1]
    search_len = torch.clamp(frame_len, max=k.search_cap)
    smask = torch.arange(corr_n, device=dev) < search_len[:, None]

    def peak(c):
        pm = torch.where(smask, c.abs() ** 2, -1.0)
        off = pm.argmax(1)
        return off, pm[rows, off]

    off_dl, max_dl = peak(dl_c)
    off_ul, max_ul = peak(ul_c)
    is_dl = max_dl >= max_ul
    off = torch.where(is_dl, off_dl, off_ul)
    c = torch.where(is_dl[:, None], dl_c, ul_c)
    corr_val = c[rows, off]
    interior = (off > 0) & (off < search_len - 1)
    pa = c[rows, torch.clamp(off - 1, 0, corr_n - 1)].abs() ** 2
    pb = corr_val.abs() ** 2
    pg = c[rows, torch.clamp(off + 1, 0, corr_n - 1)].abs() ** 2
    uw_corr = torch.where(interior, _quad_interp(pa, pb, pg),
                          torch.zeros_like(pa))
    sync_len = torch.where(is_dl, k.sync_len[0], k.sync_len[1])
    pre_off = torch.where(is_dl, k.pre_off[0], k.pre_off[1])
    uw_start = off - sync_len + 1 + pre_off
    ok = ok & (uw_start >= 0) & (uw_start < frame_len)

    # phase align
    cmag = corr_val.abs()
    one_c = torch.ones((), dtype=torch.complex64, device=dev)
    pc = torch.where(cmag > 0, torch.conj(corr_val / cmag), one_c)
    xa = xr * pc[:, None]

    # extract from uw_start
    cf = (k.center_frequency
          + (center_bin - k.fft_size // 2).float() / k.fft_size * k.in_rate
          + fine_offset * k.out_rate)
    simplex = cf > iridium.SIMPLEX_FREQUENCY_MIN
    max_len = torch.where(simplex, k.max_len[0], k.max_len[1])
    min_len = torch.where(simplex, k.min_len[0], k.min_len[1])
    available = frame_len - uw_start
    ok = ok & (available >= min_len)
    n_samples = torch.minimum(available, max_len)
    out = shift_take(xa, torch.clamp(uw_start, 0, L), k.max_frame_cap)
    zero_c = torch.zeros((), dtype=torch.complex64, device=dev)
    out = torch.where(
        torch.arange(k.max_frame_cap, device=dev) < n_samples[:, None],
        out, zero_c)
    return DownmixOut(
        samples=out,
        n_samples=torch.where(ok, n_samples, 0).int(),
        ok=ok,
        direction=torch.where(is_dl, DIR_DL, DIR_UL).int(),
        start_dec=start.int(),
        fine_offset=fine_offset,
        uw_corr=uw_corr)


# the chain kernel's layouts: csrc/downmix_chain.cu, whose limits these are
SMS = 132                      # the H100's SMs
CLUSTERS = (1, 2, 4, 8)        # blocks a row: a portable cluster
# the largest cluster `plan` picks where a row's shared memory does not
# ask for more: at the 24- to 48-row class batches 4 blocks a row measured
# ~1 us faster a chain than 8 (tools/exp_downmix_chain.py --clusters, on an
# H100 80GB HBM3 at 700 W)
DEFAULT_MAX_CLUSTER = 4
MAX_STAGED = 232_448 - 1_024   # bytes of filt a block of stage 0 stages


class ChainPlan(NamedTuple):
    cluster: int    # blocks a row (stages 0, 1 and 3)
    part: int       # filt positions a block of stage 0 stages
    smem: int       # stage 0's dynamic shared memory bytes a block


def plan(B: int, L: int, cluster: int | None = None) -> ChainPlan:
    """The chain kernel's layout for B rows of L, which its C entry
    checks: a cluster of `cluster` blocks a row where given, else the
    fewest of CLUSTERS up to DEFAULT_MAX_CLUSTER whose B cluster blocks
    reach the SMS SMs (rows of 1,024 one block, 96 two, 48 and fewer
    four), and more (up to 8) where a block's part of a row of filt
    would not fit its shared memory; each block stages ceil(L / cluster)
    positions rounded up to a multiple of 4 (the 16-byte copies), in 4
    (part + 4) bytes. Raises where no layout takes the rows."""
    if B < 0 or L < 1:
        raise ValueError(f"the chain kernel takes B >= 0 rows of L >= 1, "
                         f"got {B} x {L}")
    if cluster is None:
        cluster = next((c for c in CLUSTERS if B * c >= SMS
                        or c == DEFAULT_MAX_CLUSTER), DEFAULT_MAX_CLUSTER)
        while (cluster < CLUSTERS[-1]
               and 4 * (_part(L, cluster) + 4) > MAX_STAGED):
            cluster *= 2
    if cluster not in CLUSTERS:
        raise ValueError(f"the chain kernel takes a cluster of "
                         f"{CLUSTERS} blocks, got {cluster}")
    part = _part(L, cluster)
    smem = 4 * (part + 4)
    if smem > MAX_STAGED or B * cluster >= 2 ** 31:
        raise ValueError(f"{B} rows of {L} in clusters of {cluster}: "
                         f"{B * cluster} blocks of {smem} bytes of shared "
                         f"memory, at most 2^31 - 1 of {MAX_STAGED}")
    return ChainPlan(cluster, part, smem)


def _part(L: int, cluster: int) -> int:
    """ceil(L / cluster) rounded up to a multiple of 4."""
    each = -(-L // cluster)
    return -(-each // 4) * 4


def _chain(stage: int, dev: torch.device, B: int, L: int, ptrs: list,
           ints=(), floats=()) -> None:
    """One launch of csrc/downmix_chain.cu's `stage` over B rows of L,
    with its pointers, ints and floats packed as the C entry takes them."""
    _kernels.DOWNMIX_CHAIN.launch(
        dev, stage, B, L, (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
        (ctypes.c_longlong * len(ints))(*ints), len(ints),
        (ctypes.c_float * len(floats))(*floats), len(floats))


def _check_vectors(B: int, dev: torch.device, **named) -> None:
    """Raise unless each of `named` is a contiguous (B,) tensor of the
    dtype its value's second item names, on `dev`."""
    for name, (t, dtype) in named.items():
        _kernels.check(t, name, dtype, dev, (B,))


def _check_matrix(t: torch.Tensor, name: str, dev: torch.device,
                  dtype=torch.complex64) -> None:
    """Raise unless t is a contiguous (B, L) `dtype` tensor on dev, L > 0."""
    _kernels.check(t, name, dtype, dev)
    if t.dim() != 2 or t.shape[1] < 1:
        raise ValueError(f"{name} must be (B, L) with L >= 1, got "
                         f"{tuple(t.shape)}")


I64 = torch.int64


def burst_start(xd: torch.Tensor, filt: torch.Tensor, ext_len: torch.Tensor,
                dec_len: torch.Tensor, shift_dec: torch.Tensor,
                cfo_win: torch.Tensor, k: ChainConsts):
    """`burst_start_plain`'s function: on a CPU tensor the twin, on a CUDA
    tensor one launch of csrc/downmix_chain.cu (stage 0) at `plan`'s
    layout, or a raise."""
    if xd.device.type == "cpu":
        return burst_start_plain(xd, filt, ext_len, dec_len, shift_dec,
                                 cfo_win, k)
    dev = xd.device
    _check_matrix(xd, "xd", dev)
    B, L = xd.shape
    _kernels.check(filt, "filt", torch.float32, dev, (B, L))
    _check_vectors(B, dev, ext_len=(ext_len, I64), dec_len=(dec_len, I64),
                   shift_dec=(shift_dec, I64))
    _kernels.check(cfo_win, "cfo_win", torch.float32, dev)
    if (cfo_win.dim() != 1 or not 1 <= cfo_win.shape[0] <= k.cfo_total
            or k.cfo_total > 1 << 24 or k.box_ntaps < 1):
        raise ValueError(f"the kernel takes 1 to cfo_total (at most 2^24) "
                         f"window samples and a box filter: cfo_win "
                         f"{tuple(cfo_win.shape)}, {k}")
    start = torch.empty(B, dtype=I64, device=dev)
    frame_len = torch.empty_like(start)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    z = torch.empty((B, k.cfo_total), dtype=torch.complex64, device=dev)
    p = _kernels.ptr
    lay = plan(B, L)
    _chain(0, dev, B, L,
           [p(xd), p(filt), p(ext_len), p(dec_len), p(shift_dec),
            p(cfo_win), p(start), p(frame_len), p(ok), p(z)],
           [k.decim, k.box_ntaps, k.pre_start, cfo_win.shape[0],
            k.cfo_total, lay.cluster, lay.part], [START_THRESHOLD])
    return start, frame_len, ok, z


def cfo_peak(spec: torch.Tensor):
    """`cfo_peak_plain`'s function: on a CPU tensor the twin, on a CUDA
    tensor one launch of csrc/downmix_chain.cu (stage 1) at `plan`'s
    layout, or a raise."""
    if spec.device.type == "cpu":
        return cfo_peak_plain(spec)
    dev = spec.device
    _check_matrix(spec, "spec", dev)
    B, n = spec.shape
    u = torch.empty(B, dtype=I64, device=dev)
    corr = torch.empty(B, dtype=torch.float32, device=dev)
    fine_offset = torch.empty_like(corr)
    p = _kernels.ptr
    _chain(1, dev, B, n, [p(spec), p(u), p(corr), p(fine_offset)],
           [plan(B, n).cluster])
    return u, corr, fine_offset


def sync_products(fwd: torch.Tensor, dl_fft: torch.Tensor,
                  ul_fft: torch.Tensor) -> torch.Tensor:
    """`sync_products_plain`'s function: on a CPU tensor the twin, on a
    CUDA tensor one launch of csrc/downmix_chain.cu (stage 2), or a
    raise."""
    if fwd.device.type == "cpu":
        return sync_products_plain(fwd, dl_fft, ul_fft)
    dev = fwd.device
    _check_matrix(fwd, "fwd", dev)
    B, n = fwd.shape
    _kernels.check(dl_fft, "dl_fft", torch.complex64, dev, (n,))
    _kernels.check(ul_fft, "ul_fft", torch.complex64, dev, (n,))
    out = torch.empty((2, B, n), dtype=torch.complex64, device=dev)
    p = _kernels.ptr
    _chain(2, dev, B, n, [p(fwd), p(dl_fft), p(ul_fft), p(out)])
    return out


def sync_extract(cc: torch.Tensor, xr: torch.Tensor, start: torch.Tensor,
                 frame_len: torch.Tensor, ok: torch.Tensor,
                 center_bin: torch.Tensor, fine_offset: torch.Tensor,
                 k: ChainConsts) -> DownmixOut:
    """`sync_extract_plain`'s function: on a CPU tensor the twin, on a CUDA
    tensor one launch of csrc/downmix_chain.cu (stage 3) at `plan`'s
    layout, or a raise."""
    if xr.device.type == "cpu":
        return sync_extract_plain(cc, xr, start, frame_len, ok, center_bin,
                                  fine_offset, k)
    dev = xr.device
    _check_matrix(xr, "xr", dev)
    B, L = xr.shape
    _kernels.check(cc, "cc", torch.complex64, dev)
    if cc.dim() != 3 or cc.shape[:2] != (2, B) or cc.shape[2] < 1:
        raise ValueError(f"cc must be (2, {B}, corr_n), got "
                         f"{tuple(cc.shape)}")
    _check_vectors(B, dev, start=(start, I64), frame_len=(frame_len, I64),
                   ok=(ok, torch.bool), center_bin=(center_bin, I64),
                   fine_offset=(fine_offset, torch.float32))
    if not 1 <= k.max_frame_cap < 1 << 30 or k.fft_size < 1:
        raise ValueError(f"the kernel takes 1 <= max_frame_cap < 2^30 and "
                         f"an FFT size: {k}")
    samples = torch.empty((B, k.max_frame_cap), dtype=torch.complex64,
                          device=dev)
    n_samples = torch.empty(B, dtype=torch.int32, device=dev)
    ok_out = torch.empty_like(ok)
    direction = torch.empty_like(n_samples)
    start_dec = torch.empty_like(n_samples)
    uw_corr = torch.empty_like(fine_offset)
    p = _kernels.ptr
    _chain(3, dev, B, L,
           [p(cc), p(xr), p(start), p(frame_len), p(ok), p(center_bin),
            p(fine_offset), p(samples), p(n_samples), p(ok_out),
            p(direction), p(start_dec), p(uw_corr)],
           [k.search_cap, cc.shape[2], k.max_frame_cap, k.fft_size,
            *k.sync_len, *k.pre_off, *k.max_len, *k.min_len,
            plan(B, L).cluster],
           [k.center_frequency, k.in_rate, k.out_rate,
            iridium.SIMPLEX_FREQUENCY_MIN])
    return DownmixOut(samples=samples, n_samples=n_samples, ok=ok_out,
                      direction=direction, start_dec=start_dec,
                      fine_offset=fine_offset, uw_corr=uw_corr)


class Downmix(torch.nn.Module):
    """`forward(dec_full, ext_len, center_bin, shift_dec)`: the chain
    after the decimating FIR, batched over bursts.

    dec_full (B, dec_cap) c64 decimated window; ext_len (B,) valid input
    samples of the window including the alignment lead; center_bin (B,)
    detector bin (fftshifted); shift_dec (B,) alignment lead in decimated
    samples (ops/window_gather.py), zeroed here."""

    def __init__(self, det: DetectorParams, dmp: DownmixParams,
                 dec_cap: int, max_frame_cap: int,
                 device: torch.device):
        super().__init__()
        c = make_consts(dmp)
        self.decim = dmp.decimation
        self.in_ntaps = len(c.input_taps)
        self.dec_cap = dec_cap
        self.max_frame_cap = max_frame_cap
        assert dec_cap >= max(dmp.cfo_fft_size, dmp.sync_search_len, 128)
        sps = float(dmp.samples_per_symbol)
        self.chain = ChainConsts(
            decim=dmp.decimation, box_ntaps=len(c.box_taps),
            pre_start=dmp.pre_start_samples, cfo_total=dmp.cfo_fft_total,
            search_cap=dmp.sync_search_len, corr_n=dmp.corr_fft_size,
            sync_len=(c.dl_sync_len, c.ul_sync_len),
            pre_off=(int(iridium.PREAMBLE_LENGTH_SHORT * sps),
                     int(32 * sps)),
            max_len=(int(iridium.MAX_FRAME_LENGTH_SIMPLEX * sps),
                     int(iridium.MAX_FRAME_LENGTH_NORMAL * sps)),
            min_len=(int(iridium.MIN_FRAME_LENGTH_SIMPLEX * sps),
                     int(iridium.MIN_FRAME_LENGTH_NORMAL * sps)),
            max_frame_cap=max_frame_cap, fft_size=det.fft_size,
            center_frequency=det.center_frequency,
            in_rate=det.sample_rate, out_rate=dmp.output_sample_rate)
        self.register_buffer("noise_taps", torch.from_numpy(c.noise_taps))
        self.register_buffer("box_taps", torch.from_numpy(c.box_taps))
        self.register_buffer("rrc_taps", torch.from_numpy(c.rrc_taps))
        self.register_buffer("cfo_win", torch.from_numpy(c.cfo_window))
        self.register_buffer("dl_fft", torch.from_numpy(c.dl_sync_fft))
        self.register_buffer("ul_fft", torch.from_numpy(c.ul_sync_fft))
        self.to(device)

    def forward(self, dec_full, ext_len, center_bin, shift_dec
                ) -> DownmixOut:
        k = self.chain
        ext_len = ext_len.long()
        shift_dec = shift_dec.long()
        dec_len = torch.clamp((ext_len - self.in_ntaps + 1) // self.decim, 0,
                              self.dec_cap)
        # each step by its module global, so that a caller can wrap it:
        # the noise LPF, re-zeroing and box filter
        xd, filt = noise_box(dec_full, dec_len, shift_dec, self.noise_taps,
                             self.box_taps)
        # the burst start and the fine CFO estimate's input
        start, frame_len, ok, z = burst_start(xd, filt, ext_len, dec_len,
                                              shift_dec, self.cfo_win, k)
        u, corr, fine_offset = cfo_peak(torch.fft.fft(z))
        # the frame gather, the fine rotation and the RRC matched filter
        # ("same"), with the sync search's input
        xr, fwd_in = frame_rrc_sync(xd, start, frame_len, u, corr,
                                    self.rrc_taps, k.cfo_total,
                                    k.search_cap, k.corr_n)
        # the sync-word correlations, one inverse FFT for both templates
        cc = torch.fft.ifft(sync_products(torch.fft.fft(fwd_in),
                                          self.dl_fft, self.ul_fft))
        # the peaks and the choice, phase align and extraction
        return sync_extract(cc, xr, start, frame_len, ok, center_bin.long(),
                            fine_offset, k)
