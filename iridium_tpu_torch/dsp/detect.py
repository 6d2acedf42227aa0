"""The exact per-frame burst detector: the port of iridium_tpu/dsp/detect.py,
the reference's state machine (burst_detect.c:426-699) frame by frame with
a fixed-capacity burst table, and the JAX tests' oracle.

Parity sources (reference file:line) as in the JAX module:
  - relative magnitude:               burst_detect.c:426-434
  - baseline running-sum update:      burst_detect.c:438-454
  - active-burst extension:           burst_detect.c:458-469
  - burst mask over +-width/2:        burst_detect.c:473-486
  - gone-burst deletion (+ forced
    noise update on long bursts):     burst_detect.c:490-518
  - peak extraction with DC notch and
    edge exclusion:                   burst_detect.c:529-552
  - greedy burst creation, squelch and
    noise reset:                      burst_detect.c:556-632

The JAX module's per-frame `lax.cond`s and `while_loop` are Python
branches on host values here, so on the card every frame reads a few
scalars back: this scan is the oracle and the third `detect_impl`, not a
production path. Its state, `DetectorState`, keeps the bursts in a table of
`burst_capacity` slots, so it does not interchange with `ScanState`.
A frame step updates the state it is given in place.

The local bin range (`bin_lo`, `n_bins`, `own_lo`, `own_hi`) and the
`global_sum` hook (the JAX module's psum over `axis_name`; identity by
default) are the sharded mode's: bursts centred outside [own_lo, own_hi)
are tracked but neither emitted nor counted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DetectorParams
from . import detect_scan
from .state import add_scalar_views, rebase_

INT32_MAX = 2**31 - 1
INT_FIELDS = ("hist_idx", "primed", "burst_id", "squelch_count", "n_tagged",
              "g_count")
FLOAT_FIELDS = ("peak_signal_db",)


@dataclasses.dataclass
class DetectorState:
    """detect.DetectorState (iridium_tpu/dsp/detect.py:54-92) on one
    device. Sample indices are relative to the block's first sample; the
    burst table's bins are local, the gone table's global. `primed` is 0/1
    and the history ring restarts at slot 0 on a noise reset. The scalars
    live in `ints` (INT_FIELDS order) and `floats`, with field-named 0-d
    views."""
    baseline_hist: torch.Tensor   # (H, F_loc) f32
    baseline_sum: torch.Tensor    # (F_loc,) f32
    a_valid: torch.Tensor         # (B,) bool
    a_id: torch.Tensor            # (B,) i32
    a_start: torch.Tensor         # (B,) i32
    a_last: torch.Tensor          # (B,) i32
    a_bin: torch.Tensor           # (B,) i32
    a_mag: torch.Tensor           # (B,) f32
    a_noise: torch.Tensor         # (B,) f32
    mask_count: torch.Tensor      # (F_loc,) i32
    g_id: torch.Tensor            # (G,) i32
    g_start: torch.Tensor         # (G,) i32
    g_stop: torch.Tensor          # (G,) i32
    g_last: torch.Tensor          # (G,) i32
    g_bin: torch.Tensor           # (G,) i32
    g_mag: torch.Tensor           # (G,) f32
    g_noise: torch.Tensor         # (G,) f32
    ints: torch.Tensor            # (6,) i32
    floats: torch.Tensor          # (1,) f32

    def clone(self) -> "DetectorState":
        return DetectorState(**{f.name: getattr(self, f.name).clone()
                                for f in dataclasses.fields(self)})


add_scalar_views(DetectorState, INT_FIELDS, FLOAT_FIELDS)


def init_state(p: DetectorParams, device: str | torch.device,
               n_bins: int | None = None, id_offset: int = 0
               ) -> DetectorState:
    F = n_bins if n_bins is not None else p.fft_size
    H, B, G = p.history_size, p.burst_capacity, p.gone_capacity

    def z(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device=device)

    ints = z(len(INT_FIELDS))
    ints[INT_FIELDS.index("burst_id")] = id_offset * 10
    return DetectorState(
        baseline_hist=z((H, F), torch.float32),
        baseline_sum=z(F, torch.float32),
        a_valid=z(B, torch.bool), a_id=z(B), a_start=z(B), a_last=z(B),
        a_bin=z(B), a_mag=z(B, torch.float32), a_noise=z(B, torch.float32),
        mask_count=z(F),
        g_id=z(G), g_start=z(G), g_stop=z(G), g_last=z(G), g_bin=z(G),
        g_mag=z(G, torch.float32), g_noise=z(G, torch.float32),
        ints=ints, floats=z(len(FLOAT_FIELDS), torch.float32))


def _coverage(bins: torch.Tensor, weight: torch.Tensor, half_bw: int,
              n_bins: int) -> torch.Tensor:
    """Sum of the +-half_bw coverage of bursts at `bins` weighted by
    `weight` (int32), clipped at the edges, as interval endpoints and a
    cumsum."""
    lo = (bins - half_bw).clamp(0, n_bins - 1).long()
    hi = (bins + half_bw).clamp(0, n_bins - 1).long()
    diff = torch.zeros(n_bins + 1, dtype=torch.int32, device=bins.device)
    diff.index_add_(0, lo, weight)
    diff.index_add_(0, hi + 1, -weight)
    return torch.cumsum(diff, 0, dtype=torch.int32)[:-1]


def make_frame_step(p: DetectorParams, *, global_sum=None, bin_lo: int = 0,
                    n_bins: int | None = None, own_lo: int | None = None,
                    own_hi: int | None = None, id_stride: int = 1):
    """Build frame_step(state, mag, idx, act), which runs one FFT frame of
    the state machine on `state` in place: `mag` the frame's (F_loc,)
    |X|^2, `idx` its first sample, `act` whether it lies within the valid
    samples (frames past EOF leave the state alone, burst_detect.c:821)."""
    F = p.fft_size
    FL = n_bins if n_bins is not None else F
    own_lo = bin_lo if own_lo is None else own_lo
    own_hi = bin_lo + FL if own_hi is None else own_hi
    G, H = p.gone_capacity, p.history_size
    hb = p.burst_width_bins // 2
    c = detect_scan._consts(p)
    thr, hist_f, enbw = (float(c["threshold"]), float(c["hist_f"]),
                         float(c["enbw"]))
    f2, bin_width = float(c["f2"]), float(c["bin_width"])
    gsum = global_sum or (lambda x: x)
    gbins = bin_lo + np.arange(FL)
    dc = F // 2
    eligible_np = ((gbins >= hb) & (gbins < F - hb)
                   & ~((gbins >= dc - 3) & (gbins <= dc + 3)))
    owned_np = (gbins >= own_lo) & (gbins < own_hi)
    all_owned = bool(owned_np.all())
    consts = {}

    def const(dev):
        if dev not in consts:
            consts[dev] = (
                torch.from_numpy(eligible_np.astype(np.float32)).to(dev),
                torch.from_numpy(owned_np).to(dev))
        return consts[dev]

    def frame_step(s: DetectorState, mag: torch.Tensor, idx: int,
                   act: bool) -> None:
        elig, owned_bin = const(mag.device)
        h = dict(zip(INT_FIELDS, s.ints.tolist()))
        hist = s.baseline_hist
        row0 = hist[h["hist_idx"]].clone()
        row1 = hist[(h["hist_idx"] + 1) % H].clone()

        def owned(slots_mask):
            if all_owned:
                return slots_mask
            return slots_mask & owned_bin[s.a_bin.long().clamp(0, FL - 1)]

        def count_active() -> int:
            return int(gsum(owned(s.a_valid).sum()))

        def update_baseline(evict) -> int:
            """The noise update (burst_detect.c:438-454); returns the
            history slot it writes. Rows older than the last reset are
            masked by `primed` instead of zeroed (the JAX module's
            update_baseline :207-235)."""
            s.baseline_sum = (s.baseline_sum - evict * float(h["primed"])
                              ) + mag
            slot = h["hist_idx"]
            if slot + 1 == H:
                h["hist_idx"], h["primed"] = 0, 1
            else:
                h["hist_idx"] = slot + 1
            return slot

        def append_gone(flags, stop: int) -> None:
            """Remove flagged bursts; append the owned ones to the gone
            table in id order (burst_detect.c:703-742)."""
            emit = owned(flags)
            key = torch.where(emit, s.a_id, INT32_MAX)
            n_gone = int(emit.sum())
            order = torch.argsort(key, stable=True)[:n_gone]
            n_put = min(n_gone, G - h["g_count"])
            if n_put > 0:
                src = order[:n_put]
                dst = slice(h["g_count"], h["g_count"] + n_put)
                s.g_id[dst] = s.a_id[src]
                s.g_start[dst] = s.a_start[src]
                s.g_stop[dst] = stop
                s.g_last[dst] = s.a_last[src]
                s.g_bin[dst] = s.a_bin[src] + bin_lo
                s.g_mag[dst] = s.a_mag[src]
                s.g_noise[dst] = s.a_noise[src]
            h["g_count"] = min(h["g_count"] + n_gone, G)
            h["n_tagged"] += n_gone
            s.a_valid &= ~flags

        rel = torch.where(s.baseline_sum > 0, mag / s.baseline_sum,
                          torch.zeros((), device=mag.device))
        cand = bool((rel * elig).max() > thr) and h["primed"] > 0
        have = bool(s.a_valid.any()) or cand
        if not all_owned:
            # every range takes the same branch: the full step couples
            have = int(gsum(torch.tensor(int(have)))) > 0
        w_force = w_idle = H
        if not have:
            # no active burst and no peak: only the squelch decay and the
            # idle noise update (burst_detect.c:629, :698)
            if act:
                h["squelch_count"] = max(h["squelch_count"] - 1, 0)
                w_idle = update_baseline(row0)
        else:
            primed = h["primed"] > 0 and act
            # extend last_active (burst_detect.c:458-469)
            cb = s.a_bin.long()
            glob_cb = cb + bin_lo
            zero = torch.zeros((), device=mag.device)
            hit = ((torch.where(glob_cb > 0, rel[(cb - 1).clamp(0, FL - 1)],
                                zero) > thr)
                   | (rel[cb.clamp(0, FL - 1)] > thr)
                   | (torch.where(glob_cb < F - 1,
                                  rel[(cb + 1).clamp(0, FL - 1)], zero)
                      > thr))
            if primed:
                s.a_last = torch.where(s.a_valid & hit, idx, s.a_last)
            # peaks under the mask carried from the frame before
            relm = rel * (s.mask_count == 0) * elig
            relm = torch.where(relm > thr, relm, zero)
            # delete gone bursts (burst_detect.c:490-518)
            long_b = s.a_valid & ((s.a_last - s.a_start) > p.max_burst_len)
            gone = s.a_valid & (((s.a_last + p.burst_post_len) <= idx)
                                | long_b)
            force = int(gsum(long_b.any().int())) > 0 and primed
            if primed and bool(gone.any()):
                append_gone(gone, idx)
            if force:
                w_force = update_baseline(row0)
            # the mask of the remaining bursts
            if primed:
                s.mask_count = _coverage(s.a_bin, s.a_valid.int(), hb, FL)
            # create new bursts: the greedy argmax walk over the masked
            # peaks; once one pick fails every later one would
            created = torch.zeros_like(s.a_valid)
            ok, k = primed, 0
            while ok and k < p.max_new_per_frame:
                c = relm * (s.mask_count == 0)
                pk = int(torch.argmax(c))
                pv = c[pk]
                slot = int(torch.argmin(s.a_valid.int()))
                ok = bool(pv > thr) and not bool(s.a_valid[slot])
                if ok:
                    mag_db = 10.0 * torch.log10(
                        torch.clamp(pv * hist_f * enbw, min=1e-30))
                    noise_db = 10.0 * torch.log10(torch.clamp(
                        s.baseline_sum[pk] / hist_f / f2 / enbw / bin_width,
                        min=1e-30))
                    start = idx - p.burst_pre_len
                    s.a_valid[slot] = True
                    s.a_id[slot] = h["burst_id"]
                    s.a_start[slot] = start
                    s.a_last[slot] = start
                    s.a_bin[slot] = pk
                    s.a_mag[slot] = mag_db
                    s.a_noise[slot] = noise_db
                    created[slot] = True
                    s.mask_count[max(pk - hb, 0):min(pk + hb, FL - 1) + 1] \
                        += 1
                    h["burst_id"] += 10 * id_stride
                    s.floats[0] = torch.maximum(s.floats[0], mag_db)
                k += 1
            # squelch (burst_detect.c:594-631) on the global count
            n_active = count_active()
            if primed and p.max_bursts > 0 and n_active > p.max_bursts:
                append_gone(s.a_valid & ~created, idx)
                s.a_valid.zero_()
                s.mask_count.zero_()
                h["squelch_count"] += 3
            elif act:
                h["squelch_count"] = max(h["squelch_count"] - 1, 0)
            # noise-estimate reset after repeated squelch: the stale rows
            # stay, masked by `primed` until they are overwritten
            if act and h["squelch_count"] >= 10:
                s.baseline_sum = torch.zeros_like(s.baseline_sum)
                h.update(hist_idx=0, primed=0, squelch_count=0)
            # final noise update when no burst is active (:698)
            n_active = count_active()
            if act and n_active == 0:
                w_idle = update_baseline(row1 if w_force != H else row0)
        for w in (w_force, w_idle):
            if w != H:
                hist[w] = mag
        s.ints.copy_(torch.tensor([h[k] for k in INT_FIELDS],
                                  dtype=torch.int32))

    return frame_step


def make_detect_block(p: DetectorParams, **shard_kw):
    """detect(samples, state, n_valid, window=None) -> new DetectorState
    for one block of (block_samples,) complex64 samples, of which the
    first `n_valid` are real (frames past them are skipped, as the
    reference's feed loop does, burst_detect.c:821). The spectrogram is
    the scan kernel's detect step's (`detect_scan.spectrogram`)."""
    frame_step = make_frame_step(p, **shard_kw)

    def detect(samples: torch.Tensor, state: DetectorState, n_valid: int,
               window: torch.Tensor | None = None) -> DetectorState:
        mag2 = detect_scan.spectrogram(samples, p, window)
        idxs = np.arange(p.frames_per_block) * p.fft_size
        return run_state_machine(mag2, idxs, idxs + p.fft_size <= n_valid,
                                 state, frame_step)

    return detect


def run_state_machine(mag2: torch.Tensor, idxs, active,
                      state: DetectorState, frame_step) -> DetectorState:
    """A frame step over per-frame |X|^2 rows (the sharded path computes
    the spectrogram separately); `idxs` and `active` are host sequences.
    The input state is left as it was."""
    s = state.clone()
    for mag, idx, act in zip(mag2, idxs, active):
        frame_step(s, mag, int(idx), bool(act))
    return s


def rebase_state(state: DetectorState, block_samples: int
                 ) -> DetectorState:
    """A copy with the burst sample indices shifted by -block_samples and
    the gone table cleared, the carry for the next block."""
    s = state.clone()
    rebase_(s, block_samples)
    return s
