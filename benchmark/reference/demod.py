"""Batched DQPSK demodulator: Gardner timing recovery + 1st-order PLL +
hard/soft UW verification + differential decode, in plain PyTorch.

Frozen copy of `iridium_tpu_torch/dsp/demod.py`'s plain versions
(`loop_plain`, `Demod.decide_plain`, `warp_sum`), without the kernel's
plan and launch. Reference sources (qpsk_demod.c): Catmull-Rom
interpolation :56-81, Gardner loop :85-130, simple decimation :134-141,
PLL :145-195, hard decision and confidence :199-260, DQPSK map :264-273,
UW checks :277-325, bits and LLR :329-335, 489-503.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import iridium

PLL_ALPHA = 0.2
SQRT1_2 = 0.70710678118654752
CONFIDENCE_ANGLE = 22.0
MAGNITUDE_DROP = 8.0
MAX_LOW_COUNT = 3
UW_MAX_ERRORS = 2
UW_SOFT_THRESHOLD = 3.0
GARDNER_KP = 0.02
GARDNER_KI = 0.0002

DQPSK_MAP = (0, 2, 3, 1)

DIR_DL = 0
DIR_UL = 1


class DemodOut(NamedTuple):
    ok: torch.Tensor           # (B,) bool — UW verified
    direction: torch.Tensor    # (B,) i32 final direction
    n_symbols: torch.Tensor    # (B,) i32 actual symbols (after EOF trim)
    confidence: torch.Tensor   # (B,) i32 percent
    level: torch.Tensor        # (B,) f32 mean magnitude
    total_phase: torch.Tensor  # (B,) f32 summed PLL corrections
    bits: torch.Tensor         # (B, 2*S) i32
    llr: torch.Tensor          # (B, 2*S) f32


def _cubic4(x: torch.Tensor, pos: torch.Tensor, n_samp: torch.Tensor):
    """Catmull-Rom interpolation with the reference's clamping: mu keeps
    the pre-clamp fraction (qpsk_demod.c:56-81). The 4-sample read is
    clamped into the row like a dynamic slice."""
    L = x.shape[1]
    idx0 = pos.to(torch.int64)
    mu = pos - idx0.float()
    idx = torch.minimum(torch.clamp(idx0, min=1), n_samp - 3)
    base = torch.clamp(idx - 1, 0, L - 4)
    w = torch.gather(torch.view_as_real(x), 1,
                     (base[:, None] + torch.arange(4, device=x.device))
                     [:, :, None].expand(-1, -1, 2))
    w = torch.view_as_complex(w.contiguous())
    s0, s1, s2, s3 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    mu2 = mu * mu
    mu3 = mu2 * mu
    a = -0.5 * s0 + 1.5 * s1 - 1.5 * s2 + 0.5 * s3
    b = s0 - 2.5 * s1 + 2.0 * s2 - 0.5 * s3
    cc = -0.5 * s0 + 0.5 * s2
    return a * mu3 + b * mu2 + cc * mu + s1


def _pll_update(phi, total, sym, v):
    """One PLL step (qpsk_demod.c:145-195) on the in-flight symbol."""
    out = sym * phi
    s = float(np.float32(SQRT1_2))
    xh = torch.complex(torch.where(out.real >= 0, s, -s),
                       torch.where(out.imag >= 0, s, -s))
    er = torch.conj(xh) * out
    skip = er.abs() < 1e-10
    sc = PLL_ALPHA * torch.atan2(er.imag, er.real)
    corr = torch.complex(torch.cos(sc), torch.sin(sc))
    phi2 = torch.conj(corr) * phi
    pm = phi2.abs()
    phi2 = torch.where(pm > 0,
                       torch.complex(phi2.real / pm, phi2.imag / pm), phi2)
    upd = v & ~skip
    return (torch.where(upd, phi2, phi),
            torch.where(upd, total + sc, total), out)


def _gardner_pll(x, n_samp, sps, S):
    """Gardner timing loop with the PLL fused into the same symbol loop
    (the PLL consumes symbols in production order)."""
    B = x.shape[0]
    dev = x.device
    nf = n_samp.float()
    pos = torch.zeros(B, device=dev)
    tmo = torch.zeros(B, device=dev)
    prev = torch.zeros(B, dtype=torch.complex64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    phi = torch.ones(B, dtype=torch.complex64, device=dev)
    total = torch.zeros(B, device=dev)
    outs, valids = [], []
    for t in range(S):
        active = ~done & (pos < nf - 3)
        done = done | ~active
        on = _cubic4(x, pos, n_samp)
        midpos = pos - sps * 0.5
        mid = _cubic4(x, midpos, n_samp)
        do_mid = (midpos >= 1.0) if t > 0 else torch.zeros_like(done)
        err = torch.clamp(((prev - on) * torch.conj(mid)).real, -1.0, 1.0)
        tmo2 = torch.where(do_mid, tmo + GARDNER_KI * err, tmo)
        adjust = torch.clamp(GARDNER_KP * err + tmo2, -0.5, 0.5)
        pos2 = torch.where(do_mid, pos + adjust, pos)
        phi, total, out = _pll_update(phi, total, on, active)
        pos = torch.where(active, pos2 + sps, pos)
        tmo = torch.where(active, tmo2, tmo)
        prev = torch.where(active, on, prev)
        outs.append(out)
        valids.append(active)
    return torch.stack(outs, 1), torch.stack(valids, 1), total


def _simple_pll(x, n_samp, sps, S):
    """--no-gardner: strided decimation, then the PLL."""
    B, L = x.shape
    dev = x.device
    idx = torch.arange(S, device=dev) * int(round(sps))
    valid = idx[None, :] < n_samp[:, None]
    syms = x[:, torch.clamp(idx, 0, L - 1)]
    phi = torch.ones(B, dtype=torch.complex64, device=dev)
    total = torch.zeros(B, device=dev)
    outs = []
    for t in range(S):
        phi, total, out = _pll_update(phi, total, syms[:, t], valid[:, t])
        outs.append(out)
    return torch.stack(outs, 1), valid, total


def loop_plain(x: torch.Tensor, n_samp: torch.Tensor, sps: float, S: int,
               use_gardner: bool):
    """The symbol loop as tensor code: x (B, L) c64, n_samp (B,) i64 ->
    (PLL output (B, S) c64, valid (B, S) bool, summed PLL corrections (B,)
    f32). Every t < S is written, active or not."""
    if use_gardner:
        return _gardner_pll(x, n_samp, sps, S)
    return _simple_pll(x, n_samp, sps, S)


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x (B, n) f32 in the order a warp of csrc/demod_tail.cu
    takes them: the columns zero-padded to whole chunks of 32, each lane's
    column summed chunk by chunk, then the 32 lanes halved five times
    (lane l adds lane l + h, as a butterfly shuffle does). Elementwise
    adds in a fixed order, so the sum is the same on the CPU and the
    card."""
    B, n = x.shape
    C = max(1, -(-n // 32))
    x = torch.nn.functional.pad(x, (0, 32 * C - n)).reshape(B, C, 32)
    acc = x[:, 0]
    for c in range(1, C):
        acc = acc + x[:, c]
    for h in (16, 8, 4, 2, 1):
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


class Demod:
    """`demod(x, n_samples, direction)` over a (B, L) burst batch. Its
    constant tables live on `device`, so that a call copies nothing from
    the host (as a call captured into a CUDA graph must not)."""

    def __init__(self, max_symbols: int, sps: float,
                 use_gardner: bool = True,
                 device: str | torch.device = "cpu"):
        self.S = max_symbols
        self.sps = sps
        self.use_gardner = use_gardner
        self.uw_dl = torch.tensor(iridium.UW_DL, device=device)
        self.uw_ul = torch.tensor(iridium.UW_UL, device=device)
        self.dqpsk_map = torch.tensor(DQPSK_MAP, device=device)

    def __call__(self, x: torch.Tensor, n_samples: torch.Tensor,
                 direction: torch.Tensor) -> DemodOut:
        """`loop_plain`, then `decide_plain`, on any device."""
        return self.decide_plain(*loop_plain(
            x, n_samples.long(), self.sps, self.S, self.use_gardner),
            direction)

    def decide_plain(self, pll_out: torch.Tensor, valid: torch.Tensor,
                     total_phase: torch.Tensor, direction: torch.Tensor
                     ) -> DemodOut:
        """The loop's output -> hard decisions, end-of-frame trim,
        confidence, UW checks, bits and LLRs, as tensor code."""
        S = self.S
        dev = pll_out.device
        n_sym = valid.sum(1)
        iota_s = torch.arange(S, device=dev)

        # demod_qpsk: hard decisions, EOF detect, confidence
        re, im = pll_out.real, pll_out.imag
        mags = pll_out.abs()
        hard = torch.where(
            (re >= 0) & (im >= 0), 0,
            torch.where((re < 0) & (im >= 0), 1,
                        torch.where(re < 0, 2, 3)))
        cmax = torch.cummax(torch.where(valid, mags, -torch.inf), 1).values
        low = valid & (mags < cmax / MAGNITUDE_DROP)
        f2 = torch.zeros((pll_out.shape[0], 2), dtype=torch.bool,
                         device=dev)
        low1 = torch.cat([f2[:, :1], low[:, :-1]], 1)
        low2 = torch.cat([f2, low[:, :-2]], 1)
        trip = low & low1 & low2
        actual = torch.where(trip.any(1),
                             trip.int().argmax(1) + 1 - MAX_LOW_COUNT,
                             n_sym)
        amask = iota_s < actual[:, None]

        phase = (torch.atan2(im, re) + np.pi) * (180.0 / np.pi)
        offsets = 45.0 - torch.fmod(phase, 90.0)
        n_ok = (amask & (offsets.abs() <= CONFIDENCE_ANGLE)).sum(1)
        safe_n = torch.clamp(actual, min=1)
        sum_mag = warp_sum(torch.where(amask, mags, 0.0))
        level = torch.where(actual > 0, sum_mag / safe_n, 0.0)
        confidence = torch.where(actual > 0, (100 * n_ok) // safe_n, 0)

        # UW checks
        U = iridium.UW_LENGTH
        uw_syms = hard[:, :U]
        ang = torch.atan2(im[:, :U], re[:, :U])
        ang = torch.where(ang < 0, ang + 2 * np.pi, ang)

        def hard_check(uw):
            d = (uw_syms - uw).abs()
            d = torch.where(d == 3, 1, d)
            return (actual >= U) & (d.sum(1) <= UW_MAX_ERRORS)

        def soft_check(uw):
            expected = np.pi * 0.25 + uw.float() * (np.pi * 0.5)
            d = ang - expected
            d = torch.where(d > np.pi, d - 2 * np.pi, d)
            d = torch.where(d < -np.pi, d + 2 * np.pi, d)
            err = warp_sum(d.abs()) * (2.0 / np.pi)
            return torch.where(actual >= U, err, 999.0)

        uw_dl, uw_ul = self.uw_dl.to(dev), self.uw_ul.to(dev)
        dl_ok = hard_check(uw_dl)
        ul_ok = hard_check(uw_ul)
        both_fail = ~dl_ok & ~ul_ok
        dl_err = soft_check(uw_dl)
        ul_err = soft_check(uw_ul)
        ok = ~both_fail | (torch.minimum(dl_err, ul_err)
                           <= UW_SOFT_THRESHOLD)
        direction = torch.where(
            both_fail,
            torch.where(ul_err < dl_err, DIR_UL, DIR_DL),
            torch.where(ul_ok & ~dl_ok, DIR_UL,
                        torch.where(dl_ok & ~ul_ok, DIR_DL,
                                    direction.long())))

        # DQPSK differential decode + bits
        prev = torch.cat([torch.zeros_like(hard[:, :1]), hard[:, :-1]], 1)
        dec = self.dqpsk_map.to(dev)[(hard - prev) % 4]
        bits = torch.stack([(dec >> 1) & 1, dec & 1], -1).reshape(-1, 2 * S)
        bmask = torch.arange(2 * S, device=dev) < 2 * actual[:, None]
        bits = torch.where(bmask, bits, 0).int()

        # LLR
        scale = torch.where((actual > 0) & (sum_mag > 0),
                            SQRT1_2 / (sum_mag / safe_n), 1.0)
        llr = torch.stack([re.abs(), im.abs()], -1).reshape(-1, 2 * S) \
            * scale[:, None]
        llr = torch.where(bmask, llr, 0.0)

        return DemodOut(ok=ok, direction=direction.int(),
                        n_symbols=actual.int(),
                        confidence=confidence.int(),
                        level=level.float(), total_phase=total_phase,
                        bits=bits, llr=llr)
