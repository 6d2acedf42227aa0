"""Batched per-burst downmix chain, after the front-end has rotated and
decimated each burst window.

Port of iridium_tpu/dsp/downmix.py (`make_consts` :95, `generate_sync_word`
:66, `downmix_from_dec` :387-531). The JAX module's TPU workarounds
(`_shift_take`, `_pick1`: dynamic addressing without dynamic-address ops)
are plain indexing here and give the same values. Reference sources
(burst_downmix.c): noise LPF :682-698, burst start :441-478, fine CFO
:482-535, RRC :723-734, sync correlation :539-639, phase align and
extraction :749-793.

The three small FIRs (25, 20 and 51 taps) are shifted adds with the JAX
package's sequential f32 accumulation order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import iridium
from ..config import DetectorParams, DownmixParams
from ..ops import filters, windows

RRC_NTAPS = 51
RC_NTAPS = 51
RRC_ALPHA = 0.4
START_THRESHOLD = 0.45
DIR_DL = 0
DIR_UL = 1


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


def fir_valid_small(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid correlation FIR along dim 1, out[i] = sum_k taps[k] x[i+k],
    as shifted f32 adds in tap order. x is real, (B, L) or (B, L, 2)."""
    t = np.asarray(taps, np.float32)
    n_out = x.shape[1] - len(t) + 1
    acc = None
    for k, c in enumerate(t.tolist()):
        term = c * x[:, k:k + n_out]
        acc = term if acc is None else acc + term
    return acc


def fir_same_c(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Centred same-length FIR of complex (B, L) rows (the reference pads
    with zeros and runs valid: burst_downmix.c:686-693)."""
    t = len(taps)
    half = (t - 1) // 2
    xr = torch.view_as_real(x)
    B = xr.shape[0]
    xp = torch.cat([xr.new_zeros((B, half, 2)), xr,
                    xr.new_zeros((B, t - 1 - half, 2))], dim=1)
    return torch.view_as_complex(fir_valid_small(xp, taps).contiguous())


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


class DownmixOut(NamedTuple):
    samples: torch.Tensor      # (B, max_frame_cap) c64 from uw_start
    n_samples: torch.Tensor    # (B,) i32 extract length
    ok: torch.Tensor           # (B,) bool
    direction: torch.Tensor    # (B,) i32 (0=DL, 1=UL)
    start_dec: torch.Tensor    # (B,) i32 decimated-domain start
    fine_offset: torch.Tensor  # (B,) f32 fractional CFO (of output rate)
    uw_corr: torch.Tensor      # (B,) f32 sub-sample UW start correction


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
        self.c = c
        self.F = det.fft_size
        self.in_rate = det.sample_rate
        self.center_frequency = det.center_frequency
        self.decim = dmp.decimation
        self.out_rate = dmp.output_sample_rate
        self.in_ntaps = len(c.input_taps)
        self.cfo_n = dmp.cfo_fft_size
        self.cfo_total = dmp.cfo_fft_total
        self.corr_n = dmp.corr_fft_size
        self.search_cap = dmp.sync_search_len
        self.pre_start = dmp.pre_start_samples
        self.dec_cap = dec_cap
        self.max_frame_cap = max_frame_cap
        assert dec_cap >= max(self.cfo_n, self.search_cap, 128)
        sps = float(dmp.samples_per_symbol)
        self.dl_pre_off = int(iridium.PREAMBLE_LENGTH_SHORT * sps)
        self.ul_pre_off = int(32 * sps)
        self.max_len = (int(iridium.MAX_FRAME_LENGTH_SIMPLEX * sps),
                        int(iridium.MAX_FRAME_LENGTH_NORMAL * sps))
        self.min_len = (int(iridium.MIN_FRAME_LENGTH_SIMPLEX * sps),
                        int(iridium.MIN_FRAME_LENGTH_NORMAL * sps))
        self.register_buffer("cfo_win", torch.from_numpy(c.cfo_window))
        self.register_buffer("dl_fft", torch.from_numpy(c.dl_sync_fft))
        self.register_buffer("ul_fft", torch.from_numpy(c.ul_sync_fft))
        self.to(device)

    def forward(self, dec_full, ext_len, center_bin, shift_dec
                ) -> DownmixOut:
        c = self.c
        dev = dec_full.device
        B = dec_full.shape[0]
        rows = torch.arange(B, device=dev)
        ext_len = ext_len.long()
        shift_dec = shift_dec.long()
        iota = torch.arange(self.dec_cap, device=dev)
        zero_c = torch.zeros((), dtype=torch.complex64, device=dev)
        decim = self.decim

        ok = ext_len - shift_dec * decim >= 100
        k = center_bin.long() - self.F // 2
        dec_len = torch.clamp((ext_len - self.in_ntaps + 1) // decim, 0,
                              self.dec_cap)
        ok &= dec_len - shift_dec >= 100
        keep = (iota < dec_len[:, None]) & (iota >= shift_dec[:, None])
        dec_full = torch.where(keep, dec_full, zero_c)

        # noise LPF ("same"; skipped for very short bursts,
        # burst_downmix.c:684-697), then re-zero the alignment lead
        noise_ntaps = len(c.noise_taps)
        nl = fir_same_c(dec_full, c.noise_taps)
        xd = torch.where((dec_len - noise_ntaps + 1 > 0)[:, None], nl,
                         dec_full)
        xd = torch.where(keep, xd, zero_c)

        # burst start
        box_ntaps = len(c.box_taps)
        mag2 = xd.abs() ** 2
        filt = fir_valid_small(
            torch.cat([mag2, mag2.new_zeros((B, box_ntaps - 1))], 1),
            c.box_taps)
        flen = torch.clamp(dec_len - box_ntaps + 1, min=0)
        fmask = iota < flen[:, None]
        filt_m = torch.where(fmask, filt, -torch.inf)
        thr = START_THRESHOLD * filt_m.max(1).values
        hit = fmask & (filt >= thr[:, None])
        first = torch.where(hit.any(1), hit.int().argmax(1), flen)
        box_half = (box_ntaps - 1) // 2
        start = torch.where(
            first > shift_dec,
            torch.maximum(first + box_half - self.pre_start, shift_dec),
            shift_dec)
        start = torch.where(flen > 0, start, shift_dec)
        ok &= start < dec_len - 100
        frame_len = dec_len - start

        # frame gather: the frame starts at index 0
        xf = shift_take(xd, start, self.dec_cap)
        xf = torch.where(iota < frame_len[:, None], xf, zero_c)

        # fine CFO: squared signal, x16 zero-padded FFT, quadratic peak
        cfo_n, cfo_total = self.cfo_n, self.cfo_total
        ncfo = torch.clamp(frame_len, max=cfo_n)
        z = xf[:, :cfo_n]
        z = torch.where(torch.arange(cfo_n, device=dev) < ncfo[:, None],
                        z * z * self.cfo_win, zero_c)
        p = torch.fft.fft(z, n=cfo_total).abs() ** 2
        idx = p.argmax(1)
        u = torch.where(idx >= cfo_total // 2, idx - cfo_total, idx)
        interior = (idx > 0) & (idx < cfo_total - 1)
        a = p[rows, torch.clamp(idx - 1, 0, cfo_total - 1)]
        b_ = p[rows, idx]
        g = p[rows, torch.clamp(idx + 1, 0, cfo_total - 1)]
        corr = torch.where(interior, _quad_interp(a, b_, g),
                           torch.zeros_like(a))
        fine_offset = (u.float() + corr) / cfo_total / 2.0

        # fine rotate: integer part exact, fraction in f32
        two_total = 2 * cfo_total
        mfine = ((u[:, None] * iota) % two_total).float()
        frac = (corr[:, None] * iota.float()) / two_total
        angf = float(np.float32(-2.0 * np.pi)) * (mfine / two_total + frac)
        xf = xf * torch.complex(torch.cos(angf), torch.sin(angf))

        # RRC matched filter ("same")
        xf = torch.where(iota < frame_len[:, None], xf, zero_c)
        xr = fir_same_c(xf, c.rrc_taps)

        # sync-word correlation
        search_cap, corr_n = self.search_cap, self.corr_n
        search_len = torch.clamp(frame_len, max=search_cap)
        fwd_in = torch.where(
            torch.arange(search_cap, device=dev) < search_len[:, None],
            xr[:, :search_cap], zero_c)
        fwd = torch.fft.fft(fwd_in, n=corr_n)
        dl_c = torch.fft.ifft(fwd * self.dl_fft)
        ul_c = torch.fft.ifft(fwd * self.ul_fft)
        smask = torch.arange(corr_n, device=dev) < search_len[:, None]

        def peak(cc):
            pm = torch.where(smask, cc.abs() ** 2, -1.0)
            off = pm.argmax(1)
            return off, pm[rows, off]

        off_dl, max_dl = peak(dl_c)
        off_ul, max_ul = peak(ul_c)
        is_dl = max_dl >= max_ul
        off = torch.where(is_dl, off_dl, off_ul)
        cc = torch.where(is_dl[:, None], dl_c, ul_c)
        corr_val = cc[rows, off]
        interior = (off > 0) & (off < search_len - 1)
        pa = cc[rows, torch.clamp(off - 1, 0, corr_n - 1)].abs() ** 2
        pb = corr_val.abs() ** 2
        pg = cc[rows, torch.clamp(off + 1, 0, corr_n - 1)].abs() ** 2
        uw_corr = torch.where(interior, _quad_interp(pa, pb, pg),
                              torch.zeros_like(pa))
        sync_len = torch.where(is_dl, c.dl_sync_len, c.ul_sync_len)
        pre_off = torch.where(is_dl, self.dl_pre_off, self.ul_pre_off)
        uw_start = off - sync_len + 1 + pre_off
        ok &= (uw_start >= 0) & (uw_start < frame_len)

        # phase align
        cmag = corr_val.abs()
        one_c = torch.ones((), dtype=torch.complex64, device=dev)
        pc = torch.where(cmag > 0, torch.conj(corr_val / cmag), one_c)
        xa = xr * pc[:, None]

        # extract from uw_start; the simplex/normal split needs the
        # absolute frequency (reference burst_downmix.c:763-770), f32 as
        # in the JAX package (the printed frequency is rebuilt on the host)
        cf = (self.center_frequency + k.float() / self.F * self.in_rate
              + fine_offset * self.out_rate)
        simplex = cf > iridium.SIMPLEX_FREQUENCY_MIN
        max_len = torch.where(simplex, self.max_len[0], self.max_len[1])
        min_len = torch.where(simplex, self.min_len[0], self.min_len[1])
        available = frame_len - uw_start
        ok &= available >= min_len
        n_samples = torch.minimum(available, max_len)
        out = shift_take(xa, torch.clamp(uw_start, 0, self.dec_cap),
                         self.max_frame_cap)
        out = torch.where(
            torch.arange(self.max_frame_cap, device=dev)
            < n_samples[:, None], out, zero_c)

        return DownmixOut(
            samples=out,
            n_samples=torch.where(ok, n_samples, 0).int(),
            ok=ok,
            direction=torch.where(is_dl, DIR_DL, DIR_UL).int(),
            start_dec=start.int(),
            fine_offset=fine_offset,
            uw_corr=uw_corr)
