"""The burst detector's spectrogram and scan, in plain PyTorch.

Frozen copy of `iridium_tpu_torch/dsp/state.py` (the state) and of `iridium_tpu_torch/dsp/detect_scan.py`'s `scan_plain`,
`spectrogram` and `frame_window`: the scan frame by frame as tensor ops,
the f32 arithmetic in the scan kernel's order (reference
burst_detect.c:388-422 and the JAX package's Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import windows
from .config import DetectorParams

E_DEL = 8          # natural-deletion emissions per frame
E_SQ = 16          # squelch emissions per frame

INT_FIELDS = ("hist_idx", "primed", "burst_id", "squelch_count",
              "n_tagged", "burst_dropped", "create_waits", "g_count")
FLOAT_FIELDS = ("peak_signal_db",)
GONE_FIELDS = ("g_id", "g_start", "g_stop", "g_last", "g_bin", "g_mag",
               "g_noise")


@dataclasses.dataclass
class ScanState:
    baseline_hist: torch.Tensor   # (H, F) f32 ring
    baseline_sum: torch.Tensor    # (F,) f32
    a_valid: torch.Tensor         # (F,) bool
    a_id: torch.Tensor            # (F,) i32
    a_start: torch.Tensor         # (F,) i32 samples, rel. block start
    a_last: torch.Tensor          # (F,) i32
    a_mag: torch.Tensor           # (F,) f32
    a_noise: torch.Tensor         # (F,) f32
    mask_count: torch.Tensor      # (F,) i32
    g_id: torch.Tensor            # (G,) i32
    g_start: torch.Tensor         # (G,) i32
    g_stop: torch.Tensor          # (G,) i32
    g_last: torch.Tensor          # (G,) i32
    g_bin: torch.Tensor           # (G,) i32
    g_mag: torch.Tensor           # (G,) f32
    g_noise: torch.Tensor         # (G,) f32
    ints: torch.Tensor            # (8,) i32, INT_FIELDS order
    floats: torch.Tensor          # (1,) f32, FLOAT_FIELDS order

    def clone(self) -> "ScanState":
        return ScanState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


def add_scalar_views(cls, int_fields, float_fields) -> None:
    """Give `cls` a property per scalar field: the 0-d view of its entry
    in the `ints` or `floats` tensor."""
    for group, names in (("ints", int_fields), ("floats", float_fields)):
        for i, name in enumerate(names):
            setattr(cls, name, property(
                lambda self, group=group, i=i: getattr(self, group)[i]))


add_scalar_views(ScanState, INT_FIELDS, FLOAT_FIELDS)


def init_state(p: DetectorParams, device: torch.device,
               id_offset: int = 0, n_bins: int | None = None) -> ScanState:
    """A fresh state over `n_bins` local bins (all fft_size bins by
    default)."""
    F = n_bins if n_bins is not None else p.fft_size
    H, G = p.history_size, p.gone_capacity

    def zi(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    def zf(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    ints = zi(len(INT_FIELDS))
    ints[INT_FIELDS.index("burst_id")] = id_offset * 10
    return ScanState(
        baseline_hist=torch.zeros((H, F), dtype=torch.float32,
                                  device=device),
        baseline_sum=zf(F),
        a_valid=torch.zeros(F, dtype=torch.bool, device=device),
        a_id=zi(F), a_start=zi(F), a_last=zi(F), a_mag=zf(F),
        a_noise=zf(F), mask_count=zi(F),
        g_id=zi(G), g_start=zi(G), g_stop=zi(G), g_last=zi(G), g_bin=zi(G),
        g_mag=zf(G), g_noise=zf(G),
        ints=ints, floats=zf(len(FLOAT_FIELDS)))


def _consts(p: DetectorParams) -> dict:
    F = p.fft_size
    return dict(
        threshold=np.float32(p.threshold),
        hist_f=np.float32(p.history_size),
        enbw=np.float32(windows.BLACKMAN_ENBW),
        f2=np.float32(F) * np.float32(F),
        bin_width=np.float32(p.sample_rate) / np.float32(F),
        k_create=max(1, min(4, p.max_new_per_frame)))


def scan_plain(mag2: torch.Tensor, state: ScanState, n_valid: int,
               p: DetectorParams) -> ScanState:
    """The scan as tensor ops, one frame at a time (any device). Follows
    the Pallas kernel line for line; the float arithmetic is f32 in the
    same order, so baseline_sum is bit-equal to the kernel's."""
    F, H, G = p.fft_size, p.history_size, p.gone_capacity
    dev = mag2.device
    c = _consts(p)
    thr, hist_f, enbw = c["threshold"], c["hist_f"], c["enbw"]
    f2, bin_width, k_create = c["f2"], c["bin_width"], c["k_create"]
    hb = p.burst_width_bins // 2
    max_bursts = int(p.max_bursts)
    s = state.clone()
    hidx, prim, burst_id, sq_count, n_tagged, dropped, waits, _ = \
        s.ints.tolist()
    peak = np.float32(s.floats[0].item())
    bsum, hist = s.baseline_sum, s.baseline_hist
    valid, a_last, mask = s.a_valid, s.a_last, s.mask_count
    g = torch.arange(F, device=dev)
    dc = F // 2
    elig = (g >= hb) & (g < F - hb) & ~((g >= dc - 3) & (g <= dc + 3))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = []

    def emit(bins, stop):
        for b in bins.tolist():
            rows.append((int(s.a_id[b]), int(s.a_start[b]), stop,
                         int(a_last[b]), b, float(s.a_mag[b]),
                         float(s.a_noise[b])))

    def near(b):
        return (g - b).abs() <= hb

    for f in range(p.frames_per_block):
        idx = f * F
        act = idx + F <= n_valid
        mag = mag2[f]
        primed = prim >= H and act

        def noise_update():
            nonlocal prim, hidx
            ev = hist[hidx]
            bsum.copy_((bsum - (ev if prim >= H else zero)) + mag)
            hist[hidx] = mag
            prim = min(prim + 1, H)
            hidx = (hidx + 1) % H

        rel = torch.where(bsum > 0, mag / bsum, zero)
        n_act_pre = int(valid.sum())
        relm = torch.where((mask == 0) & elig, rel, zero)
        cand = torch.where(relm > thr, relm, zero)
        crt = torch.zeros(F, dtype=torch.bool, device=dev)

        if primed and n_act_pre > 0:
            nxt = torch.cat([rel[1:], zero[None]])
            prv = torch.cat([zero[None], rel[:-1]])
            dil = torch.maximum(rel, torch.maximum(nxt, prv)) > thr
            a_last.copy_(torch.where(valid & dil, idx, a_last))
            longb = valid & ((a_last - s.a_start) > p.max_burst_len)
            gone = valid & (((a_last + p.burst_post_len) <= idx) | longb)
            n_del = int(gone.sum())
            if n_del > 0:
                n_tagged += n_del
                dropped += max(n_del - E_DEL, 0)
                gbins = torch.nonzero(gone).flatten()
                emit(gbins[:E_DEL], idx)
                # release the +-half_bw mask of every gone bin
                cs = torch.cumsum(torch.cat([
                    torch.zeros(hb + 1, dtype=torch.int64, device=dev),
                    gone.long(),
                    torch.zeros(hb, dtype=torch.int64, device=dev)]), 0)
                mask -= (cs[2 * hb + 1:] - cs[:F]).int()
                valid &= ~gone
                if bool(longb.any()):
                    noise_update()

        n_acc = 0
        for _ in range(k_create):
            mt = cand.max()
            m = np.float32(mt.item())
            if not (primed and m > thr):
                break
            b = int(torch.nonzero(cand == mt)[0])
            base_at = np.float32(bsum[b].item())
            mag_db = np.float32(10.0) * np.log10(
                max(m * hist_f * enbw, np.float32(1e-30)))
            noise_db = np.float32(10.0) * np.log10(max(
                base_at / hist_f / f2 / enbw / bin_width,
                np.float32(1e-30)))
            valid[b] = True
            s.a_id[b] = burst_id
            s.a_start[b] = idx - p.burst_pre_len
            a_last[b] = idx - p.burst_pre_len
            s.a_mag[b] = float(mag_db)
            s.a_noise[b] = float(noise_db)
            crt[b] = True
            burst_id += 10
            nb = near(b)
            mask += nb.int()
            cand = torch.where(nb, zero, cand)
            peak = max(peak, mag_db)
            n_acc += 1
        if n_acc == k_create and bool((cand > thr).any()):
            waits += 1

        n_act_post = int(valid.sum())
        squelch = max_bursts > 0 and primed and n_act_post > max_bursts
        if squelch:
            sq = valid & ~crt
            n_sq = int(sq.sum())
            n_tagged += n_sq
            dropped += max(n_sq - E_SQ, 0)
            emit(torch.nonzero(sq).flatten()[:E_SQ], idx)
            valid.zero_()
            mask.zero_()
            sq_count += 3
        elif act:
            sq_count = max(sq_count - 1, 0)
        if act and sq_count >= 10:
            bsum.zero_()
            prim = 0
            sq_count = 0
        if act and (0 if squelch else n_act_post) == 0:
            noise_update()

    n = min(len(rows), G)
    for name in GONE_FIELDS:
        getattr(s, name).zero_()
    if n:
        cols = list(zip(*rows[:n]))
        for name, col in zip(GONE_FIELDS, cols):
            t = getattr(s, name)
            t[:n] = torch.tensor(col, dtype=t.dtype)
    s.ints.copy_(torch.tensor([hidx, prim, burst_id, sq_count, n_tagged,
                               dropped, waits, n], dtype=torch.int32))
    s.floats[0] = float(peak)
    return s


def frame_window(p: DetectorParams, device) -> torch.Tensor:
    """(F,) f32 Blackman window normalised by 0.42."""
    return torch.from_numpy(
        windows.blackman(p.fft_size) / np.float32(0.42)).to(device)


def spectrogram(samples: torch.Tensor, p: DetectorParams,
                window: torch.Tensor | None = None,
                n_frames: int | None = None) -> torch.Tensor:
    """(block_samples,) complex64 -> (frames_per_block, F) f32 fftshifted
    |X|^2 of the Blackman-windowed frames (`n_frames` frames: a sharded
    rank's time slice). A caller that runs many blocks passes
    `frame_window` once made: building it copies from the host, which
    waits for the device."""
    F = p.fft_size
    n_frames = p.frames_per_block if n_frames is None else n_frames
    if window is None:
        window = frame_window(p, samples.device)
    frames = samples[: n_frames * F].reshape(n_frames, F)
    spec = torch.fft.fft(frames * window[None, :])
    return torch.fft.fftshift(spec.abs() ** 2, dim=-1)


def detect_block(samples: torch.Tensor, state: ScanState, n_valid: int,
                 p: DetectorParams,
                 window: torch.Tensor | None = None) -> ScanState:
    """The detect step: spectrogram of the block, then the scan."""
    return scan_plain(spectrogram(samples, p, window), state, n_valid, p)
