"""Single-device block pipeline: capture blocks in, demodulated frames out.

Port of iridium_tpu/runtime/pipeline.py with its default finish path
(`_finish_group` :932-977). Blocks go in groups of `agg_blocks`:

  [host]   a capture file's blocks come from the native reader
           (io/native.py: a C++ thread converts them into pinned buffers)
  [device] per block, the detect step (window + FFT + |X|^2, then the scan
           `detect_scan.resolve_impl` picks for the configuration: the
           scan kernel, or detect_fast where the kernel refuses the
           shape); it writes the block's stream planes [tail | block |
           zero pad] and its gone table into the group's buffers
  [device] per group, the group program (`_fused_for` :716-838): routing
           of every gone burst of the group (start decomposition, length
           clamp, class split, rank compaction into each class's batch of
           fixed size), then the class batches (front-end kernel, downmix,
           demod, packed rows). Between the two, the class counts come to
           the host (12 bytes) so that a class with no burst runs no
           batch. On the card the routing and each class batch are CUDA
           graphs per group arity, captured the first time they run.
  [host]   one copy per group of [heads | class counts | meta | table rows
           | packed rows] into pinned memory, parsed into frames; a class
           with more bursts than its batch takes another round.

`run_blocks` keeps dispatching detect steps while `depth` earlier groups
finish. Everything runs on one stream; the host waits only on the event of
a group's result copy (and on a pinned upload buffer it is about to
refill).

Two other flows stay, as in the JAX package: the host-routed flow
(`_finish_group_host` :979-1081; `host_routed = True`), the oracle of the
group program in the tests, and the per-batch flow of `save_bursts_dir`
(`_finish_group_legacy` :1152-1187), which dumps each burst's samples. The
JAX package's fault salvage (`_retry`, `DeviceLostError`, `n_faults`)
existed for a remote TPU's transient faults and is left out: a CUDA error
is sticky and surfaces.

The detector's IQ ring buffer (`burst_detect.c:388-422`) is a device-
resident tail of the previous `l_ext` samples, placed in front of each
block so extraction windows that span block boundaries resolve.

Timestamp arithmetic matches the reference exactly:
  - burst:  start_time_ns + trunc(start/in_rate*1e9)   (burst_downmix.c:659-660)
  - + FIR group delay (ntaps/2)*1e9/in_rate (integer)   (burst_downmix.c:430-434)
  - + trunc(start_dec/out_rate*1e9)                     (burst_downmix.c:783)
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import os
import sys
import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .. import _kernels
from .. import device as device_mod
from .. import iridium
from ..config import DetectorConfig, DetectorParams, DownmixConfig, DownmixParams
from ..dsp import demod as demod_mod
from ..dsp import detect, detect_fast, detect_scan, downmix
from ..dsp import state as state_mod
from ..io import native
from ..ops import fused_frontend, window_gather
from . import tracing


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The packed output row (all int32 words), the JAX package's layout
# (iridium_tpu/runtime/pipeline.py:55-69):
#   [bits: ceil(2S/32) words, bit j of word w = bit 32w+j]
#   [llr (optional): 1 word bitcast-f32 scale = the burst's max LLR, then
#    ceil(2S/2) words of two u16 llr quanta each (lo = element 2i);
#    q = clip(round(llr * 65535 / scale), 0, 65535), llr = q * scale / 65535]
#   [4 words bitcast-f32: fine_offset, level, total_phase, uw_corr]
#   [7 words i32: dm_ok, dd_ok, n_symbols, confidence, direction,
#    start_dec, n_samples]
# Only the protocol decoders read LLRs, so they cross to the host only
# when asked for (`want_llr`).
_META_WORDS = 11


def packed_width(max_symbols: int, want_llr: bool) -> int:
    return row_words(2 * max_symbols, want_llr)


def row_words(s2_pad: int, want_llr: bool) -> int:
    """Words of a packed row whose bits and LLRs are padded to s2_pad."""
    nl = 1 + (s2_pad + 1) // 2 if want_llr else 0
    return (s2_pad + 31) // 32 + nl + _META_WORDS


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return (x - ((x >> 31) << 32)).int()


def pack_outputs(dm: downmix.DownmixOut, dd: demod_mod.DemodOut,
                 s2_pad: int, want_llr: bool) -> torch.Tensor:
    """`pack_plain` on CPU tensors. The card has no launch of the packing
    alone (the class batches decide and pack in one, `decide_pack`), so
    any other device raises."""
    if dd.bits.device.type != "cpu":
        raise ValueError(f"pack_outputs takes CPU tensors, got "
                         f"{dd.bits.device}: on the card the rows are "
                         "packed in `decide_pack`")
    return pack_plain(dm, dd, s2_pad, want_llr)


# csrc/demod_tail.cu (`decide_pack`): its limits and its layout
TAIL_MAX_CHUNKS = 8      # chunks of 32 symbols a warp holds
TAIL_MAX_WARPS = 16      # warps a block
TAIL_MAX_SMEM = 48 * 1024
# the most warps `tail_plan` gives a batch in all, and a burst: at the
# class batches the layouts under these measured fastest (S = 205: 2 warps
# a burst at 1,024 bursts, 8 at 32; S = 471: 8 at 24-96 bursts;
# tools/exp_demod_tail.py --layouts, on an H100 80GB HBM3 at 700 W)
TAIL_BATCH_WARPS = 16 * 132
TAIL_BURST_WARPS = 8


class TailPlan(NamedTuple):
    warps: int      # warps a burst
    bursts: int     # bursts a block
    chunks: int     # chunks of 32 symbols a warp (at most)
    threads: int
    smem: int       # dynamic shared memory bytes a block


def tail_plan(B: int, S: int, warps: int | None = None) -> TailPlan:
    """The layout of `decide_pack`'s launch for B bursts of S symbols,
    which its C entry checks: `warps` warps a burst where given, else the
    most of 1, 2, 4 and 8 that the burst's C = ceil(S / 32) chunks of 32
    symbols fill (at most the power of two at or above C) and that keep
    the batch within TAIL_BATCH_WARPS warps, and at least so many that a
    warp holds at most TAIL_MAX_CHUNKS chunks (in registers); as many
    bursts a block as make 4 warps (one where a burst has more); a burst's
    shared memory 4 (5 warps + 1 + 33 chunks) bytes (csrc/demod_tail.cu
    `slot_words`). Raises where no layout takes S."""
    C = max(1, -(-S // 32))
    if warps is None:
        warps = 1
        while (2 * warps <= TAIL_BURST_WARPS and warps < C
               and B * 2 * warps <= TAIL_BATCH_WARPS):
            warps *= 2
        warps = max(warps, -(-C // TAIL_MAX_CHUNKS))
    chunks = -(-C // max(warps, 1))
    if not (1 <= warps <= TAIL_MAX_WARPS and chunks <= TAIL_MAX_CHUNKS):
        raise ValueError(f"decide_pack takes at most {TAIL_MAX_CHUNKS} "
                         f"chunks of 32 symbols a warp and {TAIL_MAX_WARPS} "
                         f"warps a burst: S = {S}, {warps} warps")
    bursts = max(1, 4 // warps)
    slot = 4 * (5 * warps + 1 + 33 * C)
    if bursts * slot > TAIL_MAX_SMEM:
        raise ValueError(f"decide_pack: {slot} bytes of shared memory a "
                         f"burst of {S} symbols, at most {TAIL_MAX_SMEM}")
    return TailPlan(warps, bursts, chunks, 32 * warps * bursts,
                    bursts * slot)


def decide_pack_plain(dmd: demod_mod.Demod, pll_out: torch.Tensor,
                      valid: torch.Tensor, total_phase: torch.Tensor,
                      dm: downmix.DownmixOut, s2_pad: int,
                      want_llr: bool) -> torch.Tensor:
    """The demodulator's decisions on its loop's output and the packed
    rows, as the two twins composed: `pack_plain` of `Demod.decide_plain`
    (with the downmix's direction)."""
    return pack_plain(dm, dmd.decide_plain(pll_out, valid, total_phase,
                                           dm.direction), s2_pad, want_llr)


def decide_pack(dmd: demod_mod.Demod, pll_out: torch.Tensor,
                valid: torch.Tensor, total_phase: torch.Tensor,
                dm: downmix.DownmixOut, s2_pad: int,
                want_llr: bool) -> torch.Tensor:
    """`decide_pack_plain`'s function: on a CPU tensor the twin, on a CUDA
    tensor one launch of csrc/demod_tail.cu (at `tail_plan`'s layout),
    which writes the (B, W) rows from the loop's
    pll_out (B, S) c64, valid (B, S) bool and total_phase (B,) f32 and the
    downmix's fields, or a raise."""
    if pll_out.device.type == "cpu":
        return decide_pack_plain(dmd, pll_out, valid, total_phase, dm,
                                 s2_pad, want_llr)
    dev = pll_out.device
    S = dmd.S
    _kernels.check(pll_out, "pll_out", torch.complex64, dev)
    if pll_out.dim() != 2 or pll_out.shape[1] != S:
        raise ValueError(f"pll_out must be (B, {S}), got "
                         f"{tuple(pll_out.shape)}")
    B = pll_out.shape[0]
    U = iridium.UW_LENGTH
    if S < U:
        raise ValueError(f"the UW checks need S >= {U} symbols, got {S}")
    if not 2 * S <= s2_pad < 2 ** 30:
        raise ValueError(f"s2_pad = {s2_pad}: the rows pad {2 * S} bits "
                         "up, to under 2^30")
    _kernels.check(valid, "valid", torch.bool, dev, (B, S))
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype in (
            ("total_phase", total_phase, f32),
            ("direction", dm.direction, i32),
            ("fine_offset", dm.fine_offset, f32), ("uw_corr", dm.uw_corr, f32),
            ("dm.ok", dm.ok, torch.bool), ("start_dec", dm.start_dec, i32),
            ("n_samples", dm.n_samples, i32)):
        _kernels.check(t, name, dtype, dev, (B,))
    for name, t, n in (("uw_dl", dmd.uw_dl, U), ("uw_ul", dmd.uw_ul, U),
                       ("dqpsk_map", dmd.dqpsk_map, 4)):
        _kernels.check(t, name, torch.int64, dev, (n,))
    lay = tail_plan(B, S)
    W = row_words(s2_pad, want_llr)
    rows = torch.empty((B, W), dtype=torch.int32, device=dev)
    p = _kernels.ptr
    ptrs = [p(pll_out), p(valid), p(dm.direction), p(dmd.uw_dl),
            p(dmd.uw_ul), p(dmd.dqpsk_map), p(total_phase), p(dm.fine_offset),
            p(dm.uw_corr), p(dm.ok), p(dm.start_dec), p(dm.n_samples),
            p(rows)]
    ints = [demod_mod.UW_MAX_ERRORS, s2_pad, int(want_llr), W, lay.warps,
            lay.bursts]
    floats = [demod_mod.MAGNITUDE_DROP, demod_mod.CONFIDENCE_ANGLE,
              demod_mod.UW_SOFT_THRESHOLD]
    _kernels.DEMOD_TAIL.launch(
        dev, B, S, (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
        (ctypes.c_longlong * len(ints))(*ints), len(ints),
        (ctypes.c_float * len(floats))(*floats), len(floats))
    return rows


def pack_plain(dm: downmix.DownmixOut, dd: demod_mod.DemodOut,
               s2_pad: int, want_llr: bool) -> torch.Tensor:
    """One burst batch's host-bound fields as a (B, W) int32 matrix (see
    the layout above), as tensor code; `unpack_outputs` is the host-side
    inverse."""
    B, S2 = dd.bits.shape
    NW = (s2_pad + 31) // 32
    dev = dd.bits.device
    pad = torch.nn.functional.pad
    bits = pad(dd.bits.long(), (0, NW * 32 - S2))
    words = (bits.reshape(B, NW, 32)
             << torch.arange(32, device=dev)).sum(-1)
    cols = [_wrap_i32(words)]
    if want_llr:
        NL = (s2_pad + 1) // 2
        scale = dd.llr.amax(1)
        denom = torch.where(scale > 0, scale, 1.0)
        q = torch.clamp(torch.round(dd.llr * (65535.0 / denom[:, None])),
                        0, 65535).long()
        q = pad(q, (0, NL * 2 - S2)).reshape(B, NL, 2)
        cols += [scale.view(torch.int32)[:, None],
                 _wrap_i32(q[:, :, 0] | (q[:, :, 1] << 16))]
    floats = torch.stack([dm.fine_offset, dd.level, dd.total_phase,
                          dm.uw_corr], 1).float().contiguous()
    ints = torch.stack([dm.ok.int(), dd.ok.int(), dd.n_symbols,
                        dd.confidence, dd.direction, dm.start_dec,
                        dm.n_samples], 1).int()
    return torch.cat(cols + [floats.view(torch.int32), ints], 1)


def unpack_outputs(pi: np.ndarray, max_symbols: int,
                   want_llr: bool) -> dict:
    """Host-side inverse of pack_outputs on a fetched (B, W) i32 matrix."""
    pi = np.ascontiguousarray(pi)
    B = pi.shape[0]
    S2 = 2 * max_symbols
    NW = (S2 + 31) // 32
    pu = pi.view(np.uint32)
    bw = pu[:, :NW]
    bits = ((bw[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .reshape(B, NW * 32)[:, :S2].astype(np.int32)
    off = NW
    if want_llr:
        NL = (S2 + 1) // 2
        scale = np.ascontiguousarray(pi[:, off]).view(np.float32)
        lw = pu[:, off + 1:off + 1 + NL]
        q = np.stack([lw & 0xFFFF, lw >> 16], axis=-1).reshape(B, NL * 2)
        llr = q[:, :S2].astype(np.float32) * (scale[:, None]
                                              / np.float32(65535.0))
        off += 1 + NL
    else:
        llr = np.zeros((B, S2), np.float32)
    fl = np.ascontiguousarray(pi[:, off:off + 4]).view(np.float32)
    ii = pi[:, off + 4:off + _META_WORDS]
    return dict(
        dm_ok=ii[:, 0].astype(bool), dd_ok=ii[:, 1].astype(bool),
        n_sym=ii[:, 2], conf=ii[:, 3], direc=ii[:, 4],
        sdec=ii[:, 5].astype(np.int64),
        bits=bits, llr=llr,
        fine=fl[:, 0].astype(np.float64), level=fl[:, 1],
        total=fl[:, 2].astype(np.float64))


def build_frames_np(p, dmp, in_ntaps: int, start_time_ns: int,
                    ids, bins, mags, noises, abs_starts, u,
                    js) -> list[dict]:
    """Demod-frame dicts for unpacked rows `js` (numpy throughout). The
    timestamp/frequency arithmetic is the reference's
    (burst_downmix.c:659-660, :430-434, :783; PLL residual refinement
    qpsk_demod.c:521-527)."""
    F = p.fft_size
    js = np.asarray(js)
    ids = np.asarray(ids, np.int64)
    bins = np.asarray(bins, np.int64)
    k = bins - F // 2
    ns = u["n_sym"][js].astype(np.int64)
    cf = (p.center_frequency + k / F * p.sample_rate
          + u["fine"][js] * dmp.output_sample_rate)
    nz = ns > 0
    cf = cf + np.where(
        nz,
        u["total"][js] / (np.maximum(ns, 1) / iridium.SYMBOLS_PER_SECOND)
        / np.pi / 2.0,
        0.0)
    abs_starts = np.asarray(abs_starts, np.int64)
    ts = (start_time_ns
          + (abs_starts / p.sample_rate * 1e9).astype(np.int64)
          + (in_ntaps // 2) * 1_000_000_000 // p.sample_rate
          + (u["sdec"][js] / dmp.output_sample_rate * 1e9)
          .astype(np.int64))
    conf = u["conf"][js].tolist()
    level = u["level"][js].tolist()
    direc = u["direc"][js].tolist()
    ns_l = ns.tolist()
    return [dict(
        id=int(ids[i]), timestamp_ns=int(ts[i]), frequency=float(cf[i]),
        magnitude=float(mags[i]), noise=float(noises[i]),
        confidence=int(conf[i]), level=float(level[i]),
        n_symbols=ns_l[i],
        direction="UL" if direc[i] else "DL",
        bits=u["bits"][js[i], :2 * ns_l[i]],
        llr=u["llr"][js[i], :2 * ns_l[i]])
        for i in range(len(js))]


@dataclasses.dataclass
class PipelineStats:
    """Counters matching the reference's stats line inputs
    (main.c:181-187)."""
    n_samples: int = 0
    n_detected: int = 0
    n_handled: int = 0
    n_ok: int = 0
    n_dropped: int = 0
    # scan capacity diagnostics (cumulative, from the gone-table head
    # row): bursts dropped at the per-frame emission caps, and frames
    # whose creation budget deferred a peak
    n_em_dropped: int = 0
    n_create_waits: int = 0
    # peak blocks in flight since the last take_q_peak(): the analogue of
    # the reference's samples_queue depth behind `q_max:` (main.c:428-432)
    q_peak: int = 0


# the most bytes of gathered windows a class batch holds at once
GATHER_BYTES = 1 << 32


class BurstClass:
    """One burst class: window length, decimated length, the bursts it
    runs at once (`batch` = jobs x bursts per job) and its symbol cap, with
    its front-end, downmix and demod."""

    def __init__(self, pipe: "BurstDecoder", l_win: int, dec_cap: int,
                 jobs: int, per_job: int, frame_cap: int,
                 fused: bool = True):
        p, dmp = pipe.p, pipe.dmp
        self.l_win = l_win
        self.dec_cap = dec_cap
        self.jobs = jobs
        self.per_job = per_job
        self.batch = jobs * per_job
        self.decim = dmp.decimation
        self.fused = fused and fused_frontend.supports(
            p.fft_size, dmp.decimation, l_win)
        self.downmix = downmix.Downmix(p, dmp, dec_cap, frame_cap,
                                       pipe.device)
        sps = dmp.samples_per_symbol
        self.max_symbols = int(frame_cap / (sps - 0.5)) + 4
        self.demod = demod_mod.Demod(self.max_symbols, sps,
                                     pipe.use_gardner, pipe.device)
        self.taps, self.ramp = pipe.input_taps, pipe.ramp
        self.want_llr = pipe.want_llr
        self.W = packed_width(self.max_symbols, pipe.want_llr)

    def rows(self, planes: torch.Tensor, params: torch.Tensor):
        """params (5, n) i32 rows [tile, r, ext_len, bin, shift_dec] ->
        the batch's DownmixOut and its packed (n, W) i32 rows: the
        front-end, the downmix, the demod loop, then the decisions and the
        packing in one (`decide_pack`)."""
        re, im = self.front_end(planes, params)
        dm = self.downmix(torch.complex(re, im), params[2], params[3],
                          params[4])
        d = self.demod
        return dm, decide_pack(d, *d.loop(dm.samples, dm.n_samples), dm,
                               2 * self.max_symbols, self.want_llr)

    def front_end(self, planes: torch.Tensor, params: torch.Tensor):
        """params (5, n) -> the windows gathered, rotated and filtered:
        (n, dec_cap) f32 real and imaginary parts."""
        starts2 = params[:2].T.contiguous()
        ks = (params[3] - self.ramp.shape[1] // 2).contiguous()
        if not self.fused:
            return self._gather_rotate(planes, starts2, ks)
        re, im = fused_frontend.fused(planes, starts2, ks, self.taps,
                                      self.ramp, self.l_win, self.decim)
        return re[:, :self.dec_cap], im[:, :self.dec_cap]

    def _gather_rotate(self, planes: torch.Tensor, starts2: torch.Tensor,
                       ks: torch.Tensor):
        """The gather path's front-end: the windows gathered, rotated and
        filtered (B, dec_cap), in slices of windows whose gathered planes
        hold at most GATHER_BYTES (a 1.6 GHz large-class batch, 24 windows
        of 180 M samples, would gather 34.6 GB at once); the rotation's
        (2, B, L) temporary is the size of a slice's planes."""
        B = starts2.shape[0]
        n = max(1, GATHER_BYTES // (8 * self.l_win))
        if B <= n:
            xr, xi = window_gather.gather(planes, starts2, self.l_win)
            return fused_frontend.rotate_decimate(
                xr, xi, ks, self.ramp, self.taps, self.decim, self.dec_cap)
        re = torch.empty((B, self.dec_cap), dtype=torch.float32,
                         device=planes.device)
        im = torch.empty_like(re)
        for w0 in range(0, B, n):
            xr, xi = window_gather.gather(planes, starts2[w0:w0 + n],
                                          self.l_win)
            re[w0:w0 + n], im[w0:w0 + n] = fused_frontend.rotate_decimate(
                xr, xi, ks[w0:w0 + n], self.ramp, self.taps, self.decim,
                self.dec_cap)
            del xr, xi
        return re, im

    def run(self, planes: torch.Tensor, params: torch.Tensor
            ) -> torch.Tensor:
        """params (5, n) -> packed (n, W) i32 rows."""
        return self.rows(planes, params)[1]

    def run_jobs(self, planes: torch.Tensor, params: torch.Tensor
                 ) -> torch.Tensor:
        """params (5, batch) in window order -> (batch, W) rows. On the card
        one batch (a CUDA graph cannot skip work). On the CPU the JAX
        package's per-job form (`_make_group_processor` :621-631): a job
        of `per_job` bursts with none live gives zero rows and no work."""
        if planes.device.type != "cpu":
            return self.run(planes, params)
        rows = []
        for j0 in range(0, self.batch, self.per_job):
            pj = params[:, j0:j0 + self.per_job]
            rows.append(self.run(planes, pj) if bool((pj[2] > 0).any())
                        else torch.zeros((self.per_job, self.W),
                                         dtype=torch.int32))
        return torch.cat(rows)


def class_program(classes, planes: torch.Tensor, routing, skips,
                  tracer: tracing.Tracer, graph=None) -> list:
    """The routing (`routing()` -> `_route_windows`' result) and the class
    batches of one round, as [class counts (3,), meta per class, table rows
    per class (6 x batch), packed rows per class (batch x W)], all i32 and
    1-D. With `graph` (a GroupGraph whose static buffers the inputs are)
    the routing is its part 0 and class c its part 1 + c, each replayed as
    a CUDA graph. The class counts come to the host (12 bytes; `tracer`'s
    `counts_wait`, a wait for the device): a class with no member in its
    window runs no batch and gives zero rows. Each batch that runs counts
    its live rows and its rows (`rows_live`, `rows_run`)."""
    def run(part, fn):
        return fn() if graph is None else graph.parts[part].replay(fn)

    ncs, routed = run(0, routing)
    with tracer.span("counts_wait"):
        counts = ncs.tolist()
    live = [n > s for n, s in zip(counts, skips)]
    for cls, n, s, run_c in zip(classes, counts, skips, live):
        if run_c:
            tracer.count("rows_live", min(n - s, cls.batch))
            tracer.count("rows_run", cls.batch)
    parts = [ncs]
    parts += [meta for meta, _, _ in routed]
    parts += [tw.reshape(-1) for _, tw, _ in routed]
    for c, (cls, (_, _, params)) in enumerate(zip(classes, routed)):
        parts.append(
            run(1 + c, lambda cls=cls, params=params:
                cls.run_jobs(planes, params).reshape(-1)) if live[c]
            else torch.zeros(cls.batch * cls.W, dtype=torch.int32,
                             device=planes.device))
    return parts


class BurstDecoder:
    """What the single card's `Pipeline` and the sharded pipeline
    (parallel/stream.py) share: the configuration, the front-end's taps
    and ramp, the extraction window sizes, the three burst classes, the
    routing of gone bursts into the classes' batches, and the parse of a
    round's result into frames and stats."""

    def __init__(self, det_cfg: DetectorConfig | None,
                 dm_cfg: DownmixConfig | None, dev: torch.device,
                 use_gardner: bool, want_llr: bool):
        self.device = dev
        # the JAX package's counts of its profile's summary, at 0 too
        self.tracer = tracing.Tracer(
            dev, counts=("n_blocks", "n_groups", "n_overflow_rounds"))
        self.p: DetectorParams = (det_cfg or DetectorConfig()).derived()
        self.dmp: DownmixParams = (dm_cfg or DownmixConfig()).derived(self.p)
        p, dmp = self.p, self.dmp
        self.use_gardner = use_gardner
        self.want_llr = want_llr
        taps = downmix.make_consts(dmp).input_taps
        self.in_ntaps = len(taps)
        self.input_taps = torch.from_numpy(taps).to(dev)
        self.ramp = fused_frontend.ramp_table(p.fft_size, dev)
        self._det_window = detect_scan.frame_window(p, dev)
        ALIGN = window_gather.ALIGN
        # extraction window capacity: the longest [start, stop+pre)
        # window and enough input for dec_cap outputs, plus one ALIGN of
        # alignment lead
        self.l_ext = _round_up(
            max(p.max_extract,
                (dmp.dec_cap - 1) * dmp.decimation + self.in_ntaps)
            + ALIGN, ALIGN)
        # Window classes (iridium_tpu/runtime/pipeline.py:460-536): typical
        # bursts fit a quarter of the full window; only the simplex band
        # (above SIMPLEX_FREQUENCY_MIN, routed by bin with a margin over
        # the largest fine-CFO correction) carries the long 444-symbol
        # frames.
        self.l_small = min(self.l_ext, _round_up(
            p.burst_pre_len + p.burst_post_len + 120_000 + self.in_ntaps
            + ALIGN, ALIGN))
        self.dec_small = (self.l_small - self.in_ntaps) // dmp.decimation + 1
        self.dec_large = (self.l_ext - self.in_ntaps) // dmp.decimation + 1
        margin_hz = 150e3
        self.simplex_bin_min = int(np.floor(
            (iridium.SIMPLEX_FREQUENCY_MIN - margin_hz
             - p.center_frequency) * p.fft_size / p.sample_rate)
        ) + p.fft_size // 2

    @property
    def timing(self) -> collections.Counter:
        """The tracer's totals: cumulative seconds and counts by key
        (`reset` starts new ones)."""
        return self.tracer.totals

    def _burst_classes(self, jobs, per_job) -> tuple:
        """The small-normal, small-simplex and large classes (in that
        order), with max(jobs[c], 1) jobs of per_job[c] bursts each."""
        dmp = self.dmp
        cap_n = int(iridium.MAX_FRAME_LENGTH_NORMAL
                    * dmp.samples_per_symbol) + 8
        wins = ((self.l_small, self.dec_small, cap_n),
                (self.l_small, self.dec_small, dmp.max_frame_samples),
                (self.l_ext, self.dec_large, dmp.max_frame_samples))
        return tuple(BurstClass(self, l_win, dec_cap, max(j, 1), b, cap)
                     for (l_win, dec_cap, cap), j, b
                     in zip(wins, jobs, per_job))

    def _route_windows(self, tables: torch.Tensor, flats: torch.Tensor,
                       ext_len: torch.Tensor, skips, keep=None):
        """The routing's last steps (`_fused_for` :754-826) over gone
        tables (nt, G + 1, 6): each burst's window of `ext_len` samples
        that starts at `flats` in the planes (both (nt, G)), decomposed
        for the front-end (tile * ALIGN + r + lead), the class split by
        lead-inflated length (l_small) and bin (simplex_bin_min), and for
        each class its valid members (and `keep`, where given) ranked by
        flat index (table * G + slot) with one stable sort, window [skip,
        skip + batch).

        Returns (class counts (3,) i32, [(meta (batch,) i32 flat index or
        -1, table rows (6, batch) i32 [id, start, stop, bin, mag, noise],
        params (5, batch) i32 [tile, r, ext_len, bin, shift_dec])] per
        class); rows past a class's members are -1 / 0."""
        ALIGN = window_gather.ALIGN
        decim = self.dmp.decimation
        dev = tables.device
        nt, G = tables.shape[0], tables.shape[1] - 1
        N = nt * G
        valid = (torch.arange(G, device=dev)[None, :]
                 < tables[:, 0, 0].long()[:, None])
        if keep is not None:
            valid = valid & keep
        bins = tables[:, 1:, 3].long()
        r = flats % decim
        tile = (flats - r) // ALIGN
        lead = flats - (tile * ALIGN + r)
        ext_infl = ext_len + lead
        small = ext_infl <= self.l_small
        sim = bins >= self.simplex_bin_min
        cols = torch.stack([tile, r, ext_infl, bins, lead // decim]
                           ).reshape(5, N).int()
        trows = tables[:, 1:, :].reshape(N, 6).T
        iota = torch.arange(N, device=dev)
        ncs, routed = [], []
        for c, member in enumerate((valid & small & ~sim,
                                    valid & small & sim,
                                    valid & ~small)):
            cap = self.classes[c].batch
            member = member.reshape(N)
            nk = member.sum()
            ncs.append(nk)
            # members first, by flat index
            _, order = torch.sort(torch.where(member, iota, N), stable=True)
            pos = skips[c] + torch.arange(cap, device=dev)
            in_cap = torch.arange(cap, device=dev) < nk - skips[c]
            idx = order[pos.clamp(max=N - 1)]
            routed.append((torch.where(in_cap, idx, -1).int(),
                           torch.where(in_cap, trows[:, idx], 0),
                           torch.where(in_cap, cols[:, idx], 0)))
        return torch.stack(ncs).int(), routed

    def _count_heads(self, heads: np.ndarray) -> None:
        """Stats from gone-table head rows [g_count, n_tagged,
        burst_dropped, create_waits, ...], one per block (counted once per
        group)."""
        st = self.stats
        for h in heads:
            self.prev_tagged = max(self.prev_tagged, int(h[1]))
            st.n_detected += int(h[0])
        st.n_dropped = self.prev_tagged - st.n_detected
        st.n_em_dropped = max(st.n_em_dropped, int(heads[:, 2].max()))
        st.n_create_waits = max(st.n_create_waits, int(heads[:, 3].max()))

    def _array_blocks(self, samples: np.ndarray):
        """(block, n_valid) of a capture in memory, the last block padded
        with zeros."""
        bs = self.p.block_samples
        for i0 in range(0, len(samples), bs):
            chunk = samples[i0:i0 + bs]
            n_valid = len(chunk)
            if n_valid < bs:
                chunk = np.concatenate(
                    [chunk, np.zeros(bs - n_valid, np.complex64)])
            yield chunk, n_valid

    def _noise_db(self, baseline_sum: float) -> float:
        """A sum of bins' baselines as the average noise floor in
        dBFS/Hz."""
        p = self.p
        avg = baseline_sum / (p.fft_size * p.history_size)
        bin_width = p.sample_rate / p.fft_size
        if avg > 0 and bin_width > 0:
            return 10.0 * np.log10(avg / bin_width)
        return -120.0

    def _parse_round(self, part: np.ndarray, skips: np.ndarray, locate):
        """The classes' part of one round's result, one row for each of n
        buffers of the same layout (a rank's each): (n, W) i32 [class
        counts (3) | meta per class | table rows per class (6 x batch) |
        packed rows per class (batch x W)]. Counts n_handled and n_ok and
        builds the frames of the decoded bursts; `locate(meta, rows)`
        gives their clamped absolute starts and their positions in the
        stream planes from their metas and table rows (6, k) i64.

        Returns ([(meta, frame)], new skips, done): done is False while a
        class has members past its window in some buffer."""
        p, dmp = self.p, self.dmp
        n = part.shape[0]
        caps = np.asarray([c.batch for c in self.classes], np.int64)
        ncs = part[:, :3].astype(np.int64)
        o = 3
        metas, tws = [], []
        for cap in caps:
            metas.append(part[:, o:o + cap].reshape(-1))
            o += cap
        for cap in caps:
            tws.append(np.concatenate(list(
                part[:, o:o + 6 * cap].reshape(n, 6, cap)), axis=1))
            o += 6 * cap
        found = []
        for cls, meta, tw in zip(self.classes, metas, tws):
            rows = part[:, o:o + cls.batch * cls.W].reshape(-1, cls.W)
            o += cls.batch * cls.W
            sel = meta >= 0
            if not sel.any():
                continue
            u = unpack_outputs(rows, cls.max_symbols, self.want_llr)
            self.stats.n_handled += int((u["dm_ok"] & sel).sum())
            ok = u["dm_ok"] & u["dd_ok"] & sel
            self.stats.n_ok += int(ok.sum())
            if not ok.any():
                continue
            with self.tracer.span("host_format"):
                js = np.nonzero(ok)[0]
                m = meta[js].astype(np.int64)
                cl, fpos = locate(m, tw[:, js].astype(np.int64))
                # the alignment lead, from the routing's arithmetic
                lead = fpos % window_gather.ALIGN - fpos % dmp.decimation
                frames = build_frames_np(
                    p, dmp, self.in_ntaps, self.start_time_ns, tw[0, js],
                    tw[3, js],
                    np.ascontiguousarray(tw[4, js]).view(np.float32),
                    np.ascontiguousarray(tw[5, js]).view(np.float32),
                    cl - lead, u, js)
                found += zip(m.tolist(), frames)
        want = ncs.max(axis=0)
        lim = skips + caps
        return found, np.minimum(lim, want), bool(np.all(want <= lim))

@dataclasses.dataclass
class _Group:
    """Blocks finished together, with the buffers their detect steps fill
    (block i at planes[:, i*stream_len:(i+1)*stream_len], tables[i]), the
    host clock at the end of each block's detect step and, on the device
    flow, the pinned result of its last dispatched round."""
    planes: torch.Tensor        # (2, agg_blocks * stream_len) f32
    tables: torch.Tensor        # (agg_blocks, G + 1, 6) i32
    bases: list = dataclasses.field(default_factory=list)
    stepped: list = dataclasses.field(default_factory=list)
    result: torch.Tensor | None = None
    event: torch.cuda.Event | None = None


class Captured:
    """A function of static tensors as a CUDA graph. The first `replay`
    runs `fn` eagerly on a side stream (cuFFT plans, kernel binding; not
    with `warm` False, where the caller has made sure `fn` needs none, and
    has run any collective in it once), captures it and instantiates it;
    capture errors raise. Later replays rerun the captured work on the
    current stream; `fn` is not kept. Kernel launches made while capturing
    are taken off the kernels' counts and added back at each replay."""

    def __init__(self, warm: bool = True):
        self.warm = warm
        self.graph = None
        self.out = None
        self.launches: dict = {}
        self.capture_s = self.instantiate_s = None
        self.nodes = self.pool_bytes = None

    def replay(self, fn):
        if self.graph is None:
            self._capture(fn)
        self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n
        return self.out

    def _capture(self, fn) -> None:
        if self.warm:
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()
            cur.wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = {k: k.launches for k in _kernels.KERNELS}
        reserved = torch.cuda.memory_reserved()
        try:
            graph, keep = torch.cuda.CUDAGraph(keep_graph=True), True
        except TypeError:        # older PyTorch: no node count
            graph, keep = torch.cuda.CUDAGraph(), False
        # no garbage collection while capturing: freeing another graph
        # (an unreferenced pipeline's) is a call the driver refuses during
        # a capture, and the capture would be lost
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        try:
            # thread-local: another thread's query of the device (NCCL's
            # watchdog in a process group) must not invalidate the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn()
        finally:
            gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: k.launches - before[k] for k in _kernels.KERNELS
                         if k.launches != before[k]}
        for k in _kernels.KERNELS:
            k.launches = before[k]
        if keep:
            self.nodes = _kernels.graph_nodes(graph.raw_cuda_graph())
            t0 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph, self.out = graph, out


class GroupGraph:
    """The group program of one arity on the card (the counterpart of the
    program the JAX package jits per arity): its routing as one CUDA
    graph, each burst class's batch as another, captured the first time
    each runs (`parts`: routing, then the classes).

    Their inputs are static buffers: the group's (2, nb * stream_len)
    planes, its (nb, G + 1, 6) gone tables and [floor, skip x 3]; a class
    graph reads the params the routing graph wrote. `load` copies a group
    into them. The copy is what lets an overflow round re-run an earlier
    group after later detect steps have filled other buffers."""

    def __init__(self, pipe: BurstDecoder, planes_len: int, n_tables: int):
        dev = pipe.device
        self.planes = torch.zeros((2, planes_len), dtype=torch.float32,
                                  device=dev)
        self.tables = torch.zeros((n_tables, pipe.p.gone_capacity + 1, 6),
                                  dtype=torch.int32, device=dev)
        self.scal = torch.zeros(4, dtype=torch.int64, device=dev)
        self.parts = [Captured() for _ in range(1 + len(pipe.classes))]

    def load(self, planes, tables, scal) -> None:
        self.planes.copy_(planes)
        self.tables.copy_(tables)
        for i, v in enumerate(scal):
            self.scal[i].fill_(int(v))


class Pipeline(BurstDecoder):
    """Offline decode on one device. `device=None` means the current CUDA
    device and raises when there is none; `device="cpu"` runs the plain
    versions of the kernels on the CPU. `want_llr` carries each frame's
    u16-quantised LLRs to the host (frame key "llr"; zeros without it)
    for the protocol decoders. `agg_blocks` blocks share one group
    program and one result copy; `group_jobs` sizes the class batches
    (the JAX package's capacities, `_build_burst_processor` :516-535);
    `save_bursts_dir` takes the per-batch flow and dumps each burst.
    `detect_impl` picks the detector scan (`detect_scan.resolve_impl`):
    "auto" is the scan kernel where it takes the shape and detect_fast
    otherwise, "scan", "fast" or "exact" (detect.py) ask for one."""

    def __init__(self,
                 det_cfg: DetectorConfig | None = None,
                 dm_cfg: DownmixConfig | None = None,
                 burst_batch: int = 128,
                 use_gardner: bool = True,
                 start_time_ns: int | None = None,
                 device: str | torch.device | None = None,
                 want_llr: bool = True,
                 save_bursts_dir: str | None = None,
                 agg_blocks: int = 4,
                 group_jobs: int = 8,
                 detect_impl: str = "auto"):
        dev = device_mod.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        super().__init__(det_cfg, dm_cfg, dev, use_gardner, want_llr)
        p = self.p
        self.detect_impl = detect_scan.resolve_impl(p, detect_impl)
        if self.detect_impl == "scan":
            self._detect = lambda x, st, n, w: detect_scan.detect_block(
                x, st, n, p, w)
        elif self.detect_impl == "fast":
            self._detect = detect_fast.make_detect_block_fast(p)
        else:
            self._detect = detect.make_detect_block(p)
        self.burst_batch = burst_batch
        self.save_bursts_dir = save_bursts_dir
        self.agg_blocks = max(agg_blocks, 1)
        self.group_jobs = max(group_jobs, 1)
        # the host-routed flow in place of the group program: the oracle
        # the tests and chip_smoke.py hold the group program to
        self.host_routed = False
        # per-block device stream: [tail | block | zero pad]
        self.stream_len = p.block_samples + 2 * self.l_ext
        self.batch_large = max(8, burst_batch // 8)
        J, bl = self.group_jobs, self.batch_large
        self.classes = self._burst_classes(
            (J // 2, J // 4, J // 12), (2 * burst_batch, 3 * bl, 3 * bl))
        self._legacy = None          # the per-batch flow's classes
        self.graphs: dict[int, GroupGraph] = {}   # card only, by arity
        self._free: list = []        # group buffers not in flight
        self._block = None           # device block of the detect step
        self._uploads = [None, None]  # pinned (buffer, event) ring
        self._up_next = 0
        self.reset(start_time_ns)

    def reset(self, start_time_ns: int | None = None) -> None:
        """Fresh stream state; CUDA graphs and buffers are kept."""
        init = (detect.init_state if self.detect_impl == "exact"
                else state_mod.init_state)
        self.state = init(self.p, self.device)
        self.tail = torch.zeros((2, self.l_ext), dtype=torch.float32,
                                device=self.device)
        self._rebase = False
        self.base_index = 0          # absolute sample index of block start
        self.prev_tagged = 0
        self.stats = PipelineStats()
        self.start_time_ns = start_time_ns
        # `timing`: host spans (seconds) under the JAX package's keys,
        # read, step_dispatch, group_dispatch (counts_wait inside),
        # result_fetch_wait, host_parse (host_format inside), and finish
        # (the last three and the overflow rounds' group_dispatch inside)
        # and consumer; device seconds while tracing, upload_dev, step_dev,
        # round_dev, copy_dev; counts n_blocks, n_groups,
        # n_overflow_rounds, n_burst_batches (the other flows),
        # upload_bytes, rows_live, rows_run; and queue_wait, the host
        # seconds blocks wait between their detect step and their group's
        # finish (`tracing`)
        self.tracer.reset()

    # ---- detect steps ----

    def _new_group(self) -> _Group:
        if self._free:
            return _Group(*self._free.pop())
        # each detect step writes all of its block's part of both
        n = self.agg_blocks
        return _Group(
            torch.empty((2, n * self.stream_len), dtype=torch.float32,
                        device=self.device),
            torch.empty((n, self.p.gone_capacity + 1, 6),
                        dtype=torch.int32, device=self.device))

    def _upload(self, samples: np.ndarray | torch.Tensor) -> torch.Tensor:
        """The block on the device. A tensor (the native reader's block, in
        pinned memory on the card) is only copied to the device; the
        reader gives its buffer back once that copy has run. A numpy block
        goes through a ring of two pinned buffers on the card; one is
        refilled only after its copy ran. Counts the block's bytes
        (`upload_bytes`)."""
        tr = self.tracer
        if isinstance(samples, torch.Tensor):
            tr.count("upload_bytes", samples.numel() * samples.element_size())
            if self.device.type == "cpu":
                return samples
            if not samples.is_pinned():
                raise ValueError("a host tensor block must be pinned")
            if self._block is None:
                self._block = torch.empty(samples.shape, dtype=samples.dtype,
                                          device=self.device)
            with tr.device("upload_dev"):
                self._block.copy_(samples, non_blocking=True)
            return self._block
        x = np.ascontiguousarray(samples, np.complex64)
        tr.count("upload_bytes", x.nbytes)
        if self.device.type == "cpu":
            return torch.from_numpy(x)
        if self._block is None:
            self._block = torch.empty(x.shape, dtype=torch.complex64,
                                      device=self.device)
        i = self._up_next
        self._up_next = 1 - i
        if self._uploads[i] is None:
            self._uploads[i] = (torch.empty(x.shape, dtype=torch.complex64,
                                            pin_memory=True),
                                torch.cuda.Event())
        host, ev = self._uploads[i]
        ev.synchronize()
        host.numpy()[:] = x
        with tr.device("upload_dev"):
            self._block.copy_(host, non_blocking=True)
        ev.record()
        return self._block

    def _dispatch_step(self, group: _Group, samples: np.ndarray,
                       n_valid: int) -> None:
        """Enqueue the detect step of one block; it fills the block's
        planes and gone table in `group`."""
        p = self.p
        if self.start_time_ns is None:
            self.start_time_ns = time.time_ns()
        if samples.shape != (p.block_samples,):
            raise ValueError(f"block of shape {samples.shape}, expected "
                             f"({p.block_samples},)")
        tr = self.tracer
        with tr.span("step_dispatch"):
            block = self._upload(samples)
            with tr.device("step_dev"):
                self._detect_into(group, block, n_valid)
            self.stats.n_samples += n_valid
            group.bases.append(self.base_index)
            self.base_index += p.block_samples
        tr.count("n_blocks")
        group.stepped.append(time.perf_counter())

    def _detect_into(self, group: _Group, block: torch.Tensor,
                     n_valid: int) -> None:
        """The detect step of the block on the device: the scan, then the
        block's stream planes and gone table in `group`."""
        p = self.p
        if self._rebase:
            state_mod.rebase_(self.state, p.block_samples)
        self.state = self._detect(block, self.state, n_valid,
                                  self._det_window)
        bi = len(group.bases)
        bs, l_ext, sl = p.block_samples, self.l_ext, self.stream_len
        seg = group.planes[:, bi * sl:(bi + 1) * sl]
        seg[:, :l_ext] = self.tail
        seg[:, l_ext:l_ext + bs] = torch.view_as_real(block).T
        seg[:, l_ext + bs:] = 0
        self.tail.copy_(seg[:, bs:bs + l_ext])
        st = self.state
        zero = st.g_count * 0
        # the exact scan has no capacity counters (the JAX step's getattr)
        group.tables[bi, 0].copy_(torch.stack(
            [st.g_count, st.n_tagged, getattr(st, "burst_dropped", zero),
             getattr(st, "create_waits", zero), zero, zero]))
        group.tables[bi, 1:].copy_(torch.stack(
            [st.g_id, st.g_start, st.g_stop, st.g_bin,
             st.g_mag.view(torch.int32), st.g_noise.view(torch.int32)], 1))
        self._rebase = True

    def _group_planes(self, group: _Group) -> torch.Tensor:
        nb = len(group.bases)
        return group.planes[:, :nb * self.stream_len].contiguous()

    # ---- the group program (device flow) ----

    def route(self, tables: torch.Tensor, floor: torch.Tensor,
              skips: torch.Tensor):
        """On-device burst routing over a group's stacked gone tables
        (nb, G + 1, 6) (`_fused_for`'s routing, :754-826): each gone
        burst's window start in the group's concatenated planes,
        decomposed for the front-end (tile * ALIGN + r + lead), its
        extraction length clamped, the class split by lead-inflated length
        (l_small) and bin (simplex_bin_min), and for each class the members
        ranked by flat index (bi * G + slot), window [skip, skip + batch).
        `floor` (= -the group's first block's absolute start) clamps starts
        before the stream; `skips` (3,) holds each class's window start.

        Returns (class counts (3,) i32, [(meta (batch,) i32 flat index or
        -1, table rows (6, batch) i32 [id, start, stop, bin, mag, noise],
        params (5, batch) i32 [tile, r, ext_len, bin, shift_dec])] per
        class); rows past a class's members are -1 / 0. Static shapes and
        no host read, so it captures into a CUDA graph; `lax.cond`'s skip
        of an empty class is a masked compute with the same values."""
        p = self.p
        dev = tables.device
        nb = tables.shape[0]
        rows = tables[:, 1:, :].long()
        start, stop = rows[..., 1], rows[..., 2]
        blk = torch.arange(nb, device=dev)[:, None]
        # group-relative start, run-start clamp (floor = -base0)
        t_cl = torch.maximum(start + blk * p.block_samples, floor)
        el = torch.clamp(stop + blk * p.block_samples + p.burst_pre_len
                         - t_cl, max=self.l_ext - window_gather.ALIGN)
        flats = t_cl + blk * (self.stream_len - p.block_samples) + self.l_ext
        return self._route_windows(tables, flats, el, skips)

    def group_program(self, planes: torch.Tensor, tables: torch.Tensor,
                      scal: torch.Tensor, skips,
                      graph: GroupGraph | None = None) -> torch.Tensor:
        """The group program: planes (2, nb * stream_len) f32, tables
        (nb, G + 1, 6) i32, scal (4,) i64 [floor, skip x 3] on the device,
        `skips` the same three skips on the host -> the 1-D i32 result
        [heads (nb * 6) | class counts (3) | meta per class | table rows
        per class (6 x batch) | packed rows per class (batch x W)], the JAX
        package's layout. With `graph` (whose static buffers the inputs
        must be) the routing and each class batch replay as CUDA graphs.

        The class counts come to the host (12 bytes, a wait for the group's
        detect steps and routing): a class with no member in its window
        runs no batch and gives zero rows, as an empty job does in the JAX
        package (:621-627). A graph cannot skip work, and an empty group's
        replay of all three classes costs more than a tenth of a block's
        capture time (PERF.md)."""
        return torch.cat([tables[:, 0, :].reshape(-1)] + class_program(
            self.classes, planes,
            lambda: self.route(tables, scal[0], scal[1:]), skips,
            self.tracer, graph))

    def _dispatch_group(self, group: _Group, skips: np.ndarray) -> None:
        """Enqueue one round of the group program for `group` (`round_dev`
        on the device) and the copy of its result to the host
        (`copy_dev`)."""
        nb = len(group.bases)
        skips = [int(s) for s in skips]
        scal = [-group.bases[0]] + skips
        tr = self.tracer
        with tr.span("group_dispatch"):
            if self.device.type == "cpu":
                group.result = self.group_program(
                    self._group_planes(group), group.tables[:nb],
                    torch.tensor(scal, dtype=torch.int64), skips)
                return
            g = self.graphs.get(nb)
            if g is None:
                g = self.graphs[nb] = GroupGraph(
                    self, nb * self.stream_len, nb)
            with tr.device("round_dev"):
                g.load(group.planes[:, :nb * self.stream_len],
                       group.tables[:nb], scal)
                buf = self.group_program(g.planes, g.tables, g.scal, skips,
                                         g)
            group.result = torch.empty(buf.shape, dtype=torch.int32,
                                       pin_memory=True)
            with tr.device("copy_dev"):
                group.result.copy_(buf, non_blocking=True)
            group.event = torch.cuda.Event()
            group.event.record()

    def _parse_group_buf(self, buf: np.ndarray, group: _Group,
                         skips: np.ndarray, out: list[list[dict]],
                         first_round: bool):
        """Frames from one round's result. Returns (new skips, done):
        done is False while a class has members past its window."""
        p = self.p
        nb, G = len(group.bases), p.gone_capacity
        if first_round:
            self._count_heads(buf[:nb * 6].reshape(nb, 6))
        base0 = group.bases[0]

        def locate(meta, rows):
            bi = meta // G
            cl = np.maximum(base0 + bi * p.block_samples + rows[1], 0)
            return cl, (cl - base0 - bi * p.block_samples + self.l_ext
                        + bi * self.stream_len)

        found, skips, done = self._parse_round(buf[None, nb * 6:], skips,
                                               locate)
        for m, f in found:
            out[m // G].append(f)
        return skips, done

    def _begin_group(self, group: _Group) -> None:
        """What a group's finish needs and no host decision precedes: the
        first round of the group program (device flow only)."""
        if not (self.save_bursts_dir or self.host_routed):
            self._dispatch_group(group, np.zeros(3, np.int64))

    def _finish_group(self, group: _Group) -> list[list[dict]]:
        """Per-block frame lists of a group, in block order, each sorted by
        burst id; the group's buffers go back to the free list. Adds its
        blocks' waits since their detect steps to `queue_wait`, and
        resolves the device spans that have run."""
        tr = self.tracer
        now = time.perf_counter()
        tr.add("queue_wait", sum(now - t for t in group.stepped))
        with tr.span("finish"):
            if self.save_bursts_dir or self.host_routed:
                out = self._finish_group_host(group)
            else:
                out = self._finish_group_device(group)
            for frames in out:
                frames.sort(key=lambda f: f["id"])
            self._free.append((group.planes, group.tables))
        tr.drain()
        return out

    def _finish_group_device(self, group: _Group) -> list[list[dict]]:
        out: list[list[dict]] = [[] for _ in group.bases]
        skips = np.zeros(3, np.int64)
        if group.result is None:
            self._dispatch_group(group, skips)
        first = True
        tr = self.tracer
        while True:
            with tr.span("result_fetch_wait"):
                if group.event is not None:
                    group.event.synchronize()
                buf = group.result.numpy()
            tr.count("n_groups" if first else "n_overflow_rounds")
            with tr.span("host_parse"):
                skips, done = self._parse_group_buf(buf, group, skips, out,
                                                    first)
            first = False
            if done:
                return out
            self._dispatch_group(group, skips)

    # ---- the host-routed flow (the oracle) ----

    def _finish_group_host(self, group: _Group) -> list[list[dict]]:
        """One stacked gone-table copy, routing in numpy, the class rounds,
        one packed-row copy (`_finish_group_host` :979-1081)."""
        p = self.p
        nb = len(group.bases)
        out: list[list[dict]] = [[] for _ in group.bases]
        tabs = group.tables[:nb].cpu().numpy()
        self.tracer.count("n_groups")
        self._count_heads(tabs[:, 0])
        blocks_g = []
        for bi, (tab, base) in enumerate(zip(tabs, group.bases)):
            n = int(tab[0, 0])
            if n > 0:
                rows = tab[1:1 + n]
                blocks_g.append((bi, dict(
                    id=rows[:, 0], start=rows[:, 1], stop=rows[:, 2],
                    bin=rows[:, 3], mag=rows[:, 4].view(np.float32),
                    noise=rows[:, 5].view(np.float32)), base))
        if not blocks_g:
            return out
        planes = self._group_planes(group)
        if self.save_bursts_dir:
            return self._finish_group_legacy(planes, blocks_g, out)

        ginfo = self._route_group(blocks_g)
        small = ginfo["small"]
        sim = ginfo["bin"][small] >= self.simplex_bin_min
        rounds = []
        for cls, idx in zip(self.classes, (small[~sim], small[sim],
                                           ginfo["large"])):
            for r0 in range(0, len(idx), cls.batch):
                sel = idx[r0:r0 + cls.batch]
                params = np.zeros((5, cls.batch), np.int32)
                params[:, :len(sel)] = np.stack(
                    [ginfo[k][sel] for k in ("tile", "r", "ext_len", "bin",
                                             "shift_dec")])
                meta = np.full(cls.batch, -1, np.int64)
                meta[:len(sel)] = sel
                rounds.append((cls, params, meta))
        pf_all = torch.cat([
            cls.run_jobs(planes, torch.from_numpy(params).to(self.device)
                         ).reshape(-1)
            for cls, params, _ in rounds]).cpu().numpy()
        self.tracer.count("n_burst_batches", len(rounds))
        o = 0
        for cls, params, meta in rounds:
            rows = pf_all[o:o + cls.batch * cls.W].reshape(cls.batch, cls.W)
            o += cls.batch * cls.W
            self._format_group(rows, meta, ginfo, out, cls.max_symbols)
        return out

    def _route_group(self, blocks_g) -> dict:
        """Group-wide routing in numpy (`_route_group` :1083-1122): every
        block's gone bursts in one table, starts offset into the group's
        concatenated planes, decomposed for the front-end and split by
        lead-inflated extraction length."""
        p = self.p
        sl = self.stream_len
        ALIGN = window_gather.ALIGN
        decim = self.dmp.decimation
        flat_start, ext_len, cols = [], [], collections.defaultdict(list)
        for bi, g, base_index in blocks_g:
            abs_start = g["start"].astype(np.int64) + base_index
            cl = np.maximum(abs_start, 0)
            el = (g["stop"].astype(np.int64) + p.burst_pre_len
                  + base_index - cl)
            ext_len.append(np.minimum(el, self.l_ext - ALIGN))
            flat_start.append(cl - base_index + self.l_ext + bi * sl)
            cols["abs_cl"].append(cl)
            cols["blk"].append(np.full(len(el), bi, np.int64))
            for k in ("id", "bin", "mag", "noise"):
                cols[k].append(g[k])
        flat_start = np.concatenate(flat_start)
        ext_len = np.concatenate(ext_len)
        c = {k: np.concatenate(v) for k, v in cols.items()}
        r = flat_start % decim
        tile = (flat_start - r) // ALIGN
        lead = flat_start - (tile * ALIGN + r)
        ext_infl = ext_len + lead
        small = ext_infl <= self.l_small
        return dict(
            tile=tile.astype(np.int32), r=r.astype(np.int32),
            ext_len=ext_infl.astype(np.int32), bin=c["bin"].astype(np.int32),
            shift_dec=(lead // decim).astype(np.int32),
            blk=c["blk"], id=c["id"], mag=c["mag"], noise=c["noise"],
            abs_al=c["abs_cl"] - lead,
            small=np.nonzero(small)[0], large=np.nonzero(~small)[0])

    def _format_group(self, rows, meta, ginfo, out, max_symbols) -> None:
        u = unpack_outputs(rows, max_symbols, self.want_llr)
        valid = meta >= 0
        self.stats.n_handled += int((u["dm_ok"] & valid).sum())
        ok = u["dm_ok"] & u["dd_ok"] & valid
        self.stats.n_ok += int(ok.sum())
        if not ok.any():
            return
        with self.tracer.span("host_format"):
            js = np.nonzero(ok)[0]
            e = meta[js]
            frames = build_frames_np(
                self.p, self.dmp, self.in_ntaps, self.start_time_ns,
                ginfo["id"][e], ginfo["bin"][e], ginfo["mag"][e],
                ginfo["noise"][e], ginfo["abs_al"][e], u, js)
            for f, bi in zip(frames, ginfo["blk"][e].tolist()):
                out[bi].append(f)

    # ---- the per-batch flow (--save-bursts) ----

    def _legacy_classes(self):
        """The per-batch processors (`_make_processor` :645-665): a small
        and a full window, `burst_batch` bursts, the full symbol cap, the
        window gathered at the burst's exact start."""
        if self._legacy is None:
            mf = self.dmp.max_frame_samples
            self._legacy = (
                BurstClass(self, self.l_small, self.dec_small, 1,
                           self.burst_batch, mf, fused=False),
                BurstClass(self, self.l_ext, self.dec_large, 1,
                           self.burst_batch, mf, fused=False))
        return self._legacy

    def _route_bursts(self, bi: int, g: dict, base_index: int) -> list:
        """One block's burst batches (`_route_bursts` :1262-1297): windows
        at the exact start, lengths clamped to l_ext, bucketed by length."""
        p = self.p
        abs_start_cl = np.maximum(g["start"].astype(np.int64) + base_index,
                                  0)
        ext_len = np.minimum(g["stop"].astype(np.int64) + p.burst_pre_len
                             + base_index - abs_start_cl, self.l_ext)
        rel = abs_start_cl - base_index + self.l_ext + bi * self.stream_len
        small = ext_len <= self.l_small
        jobs = []
        for idx, cls in zip((np.nonzero(small)[0], np.nonzero(~small)[0]),
                            self._legacy_classes()):
            for j0 in range(0, len(idx), self.burst_batch):
                sel = idx[j0:j0 + self.burst_batch]
                zero = np.zeros(len(sel), np.int64)
                params = np.stack([zero, rel[sel], ext_len[sel],
                                   g["bin"][sel], zero]).astype(np.int32)
                jobs.append((bi, g, base_index, abs_start_cl, sel, cls,
                             params))
        return jobs

    def _finish_group_legacy(self, planes, blocks_g, out):
        jobs = []
        for bi, g, base_index in blocks_g:
            jobs += self._route_bursts(bi, g, base_index)
        res = [cls.rows(planes, torch.from_numpy(params).to(self.device))
               for *_, cls, params in jobs]
        pf_all = torch.cat([r[1] for r in res]).cpu().numpy()
        self.tracer.count("n_burst_batches", len(jobs))
        o = 0
        for (bi, g, base, cl, sel, cls, _), (dm, _) in zip(jobs, res):
            pf = pf_all[o:o + len(sel)]
            o += len(sel)
            out[bi] += self._format_batch(pf, cls, dm, g, sel, base, cl)
        return out

    def _format_batch(self, pf, cls, dm, g, sel, base_index,
                      abs_start_cl) -> list[dict]:
        u = unpack_outputs(pf, cls.max_symbols, self.want_llr)
        if self.save_bursts_dir:
            self._save_bursts(dm, u, g, sel, base_index)
        self.stats.n_handled += int(u["dm_ok"].sum())
        ok = u["dm_ok"] & u["dd_ok"]
        self.stats.n_ok += int(ok.sum())
        if not ok.any():
            return []
        with self.tracer.span("host_format"):
            js = np.nonzero(ok)[0]
            e = sel[js]
            return build_frames_np(
                self.p, self.dmp, self.in_ntaps, self.start_time_ns,
                g["id"][e], g["bin"][e], g["mag"][e], g["noise"][e],
                abs_start_cl[e], u, js)

    def _save_bursts(self, dm, u, g, sel, base_index) -> None:
        """--save-bursts: per-burst cf32 + metadata dumps (reference
        qpsk_demod.c:339-389; `_save_bursts` :1339-1391)."""
        try:
            os.makedirs(self.save_bursts_dir, exist_ok=True)
        except OSError as e:
            # warn and go on, like the reference (qpsk_demod.c:346-350)
            print(f"Warning: failed to create burst save directory: {e}",
                  file=sys.stderr)
            self.save_bursts_dir = None
            return
        p, dmp = self.p, self.dmp
        samples = dm.samples.cpu().numpy()
        n_samp = dm.n_samples.cpu().numpy()
        dm_ok = dm.ok.cpu().numpy()
        dd_ok, direc = u["dd_ok"], u["direc"]
        sdec = dm.start_dec.cpu().numpy()
        uw_corr = dm.uw_corr.cpu().numpy()
        for j in range(len(sel)):
            if not dm_ok[j]:
                continue
            gi = int(sel[j])
            abs_start = max(int(g["start"][gi]) + base_index, 0)
            ts = (self.start_time_ns
                  + int(abs_start / p.sample_rate * 1e9)
                  + (self.in_ntaps // 2) * 1_000_000_000 // p.sample_rate
                  + int(int(sdec[j]) / dmp.output_sample_rate * 1e9))
            k = int(g["bin"][gi]) - p.fft_size // 2
            cf = p.center_frequency + k / p.fft_size * p.sample_rate
            dir_str = ("DL" if int(direc[j]) == 0 else "UL") \
                if dd_ok[j] else "UN"
            base = os.path.join(
                self.save_bursts_dir,
                f"{ts:020d}_{cf:011.0f}_{int(g['id'][gi])}_{dir_str}")
            n = int(n_samp[j])
            samples[j, :n].astype(np.complex64).tofile(base + ".cf32")
            with open(base + ".meta", "w") as f:
                f.write(f"burst_id: {int(g['id'][gi])}\n"
                        f"timestamp_ns: {ts}\n"
                        f"center_freq_hz: {cf:.0f}\n"
                        f"sample_rate_hz: {dmp.output_sample_rate}\n"
                        f"samples_per_symbol: "
                        f"{dmp.samples_per_symbol:.2f}\n"
                        f"direction: {dir_str}\n"
                        f"magnitude_db: {float(g['mag'][gi]):.2f}\n"
                        f"noise_dbfs_hz: {float(g['noise'][gi]):.2f}\n"
                        f"num_samples: {n}\n"
                        f"uw_start_offset: {float(uw_corr[j]):.2f}\n")

    # ---- drivers ----

    def process_block(self, samples: np.ndarray, n_valid: int
                      ) -> list[dict]:
        """Feed one block (padded to block_samples) as a group of its own;
        returns its frames."""
        (frames,) = self.run_blocks([(samples, n_valid)])
        return frames

    def run_blocks(self, blocks, depth: int = 3) -> Iterator[list[dict]]:
        """Pipelined driver (`run_blocks` :1196-1252): `blocks` yields
        (samples, n_valid); yields each block's frames, in order. Detect
        steps are dispatched as blocks arrive; every `agg_blocks` blocks
        make a group whose first round is dispatched at once, and a group
        is finished (waited on, parsed) only when more than `depth` are in
        flight, or at the end. Tracing is on for the call while a torch
        profiler records (`tracing`); the caller's time between a yield and
        its next request is the `consumer` span."""
        agg = self.agg_blocks
        tr = self.tracer
        tr.on = tracing.recording()
        fut: collections.deque[_Group] = collections.deque()
        group = None
        it = iter(blocks)
        while True:
            with tr.span("read"):
                nxt = next(it, None)
            if nxt is None:
                break
            samples, n_valid = nxt
            if group is None:
                group = self._new_group()
            self._dispatch_step(group, samples, n_valid)
            if len(group.bases) >= agg:
                self._begin_group(group)
                fut.append(group)
                group = None
            self.stats.q_peak = max(
                self.stats.q_peak,
                len(fut) * agg + (len(group.bases) if group else 0))
            while len(fut) > depth:
                for frames in self._finish_group(fut.popleft()):
                    with tr.span("consumer"):
                        yield frames
        if group is not None:
            self._begin_group(group)
            fut.append(group)
        while fut:
            for frames in self._finish_group(fut.popleft()):
                with tr.span("consumer"):
                    yield frames

    def take_q_peak(self) -> int:
        """Read and reset the peak in-flight depth (q_max: reset each stats
        interval, main.c:428-432,524)."""
        v, self.stats.q_peak = self.stats.q_peak, 0
        return v

    def run_file(self, path: str, fmt: str | None = None) -> Iterator[dict]:
        """Frames of a capture file, read by the native reader into pinned
        buffers on the card ("-": stdin, through the Python reader)."""
        for frames in self.run_blocks(native.read_blocks(
                path, self.p.block_samples, fmt, self.device)):
            yield from frames

    def run_array(self, samples: np.ndarray) -> Iterator[dict]:
        for frames in self.run_blocks(self._array_blocks(samples)):
            yield from frames

    def noise_floor_db(self) -> float:
        """Average noise floor in dBFS/Hz (burst_detect.c:363-380)."""
        return self._noise_db(float(self.state.baseline_sum.sum()))

    def peak_signal_db(self) -> float:
        """Strongest detection so far, in dB (the diagnostic display)."""
        return float(self.state.peak_signal_db)
