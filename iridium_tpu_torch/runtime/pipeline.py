"""Single-device block pipeline: capture blocks in, demodulated frames out.

Port of iridium_tpu/runtime/pipeline.py, following its HOST-ROUTED flow
(`_finish_group_host` :979-1081 + `_route_group` :1083-1122) rather than
the on-device routing program (`_fused_for`), which existed to save
round trips to a remote TPU. Per block:

  [device] detect step: window + FFT + |X|^2, then the scan kernel
  [host]   one (G+1, 6) gone-table copy; routing of the gone bursts into
           three classes (small-normal, small-simplex, large) in numpy
  [device] per class batch: front-end (fused kernel, or window gather +
           rotate/decimate where the fused shape is unsupported),
           downmix, demod, packed rows
  [host]   one packed-row copy; vectorised frame building

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
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from .. import device as device_mod
from .. import iridium
from ..config import DetectorConfig, DetectorParams, DownmixConfig, DownmixParams
from ..dsp import demod as demod_mod
from ..dsp import detect_scan, downmix
from ..dsp import state as state_mod
from ..io import readers
from ..ops import fused_frontend, window_gather


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
    s2 = 2 * max_symbols
    nl = 1 + (s2 + 1) // 2 if want_llr else 0
    return (s2 + 31) // 32 + nl + _META_WORDS


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return (x - ((x >> 31) << 32)).int()


def pack_outputs(dm: downmix.DownmixOut, dd: demod_mod.DemodOut,
                 s2_pad: int, want_llr: bool) -> torch.Tensor:
    """One burst batch's host-bound fields as a (B, W) int32 matrix (see
    the layout above); `unpack_outputs` is the host-side inverse."""
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


class BurstClass:
    """One burst class: window length, decimated length, batch size and
    symbol cap, with its front-end, downmix and demod."""

    def __init__(self, pipe: "Pipeline", l_win: int, dec_cap: int,
                 batch: int, frame_cap: int):
        p, dmp = pipe.p, pipe.dmp
        self.l_win = l_win
        self.dec_cap = dec_cap
        self.batch = batch
        self.decim = dmp.decimation
        self.fused = fused_frontend.supports(p.fft_size, dmp.decimation,
                                             l_win)
        self.downmix = downmix.Downmix(p, dmp, dec_cap, frame_cap,
                                       pipe.device)
        sps = dmp.samples_per_symbol
        self.max_symbols = int(frame_cap / (sps - 0.5)) + 4
        self.demod = demod_mod.Demod(self.max_symbols, sps,
                                     pipe.use_gardner)
        self.taps, self.ramp = pipe.input_taps, pipe.ramp
        self.want_llr = pipe.want_llr

    def run(self, planes: torch.Tensor, params: torch.Tensor
            ) -> torch.Tensor:
        """params (5, n) i32 rows [tile, r, ext_len, bin, shift_dec] ->
        packed (n, W) i32 rows."""
        starts2 = params[:2].T.contiguous()
        bins = params[3]
        ks = (bins - self.ramp.shape[1] // 2).contiguous()
        if self.fused:
            re, im = fused_frontend.fused(planes, starts2, ks, self.taps,
                                          self.ramp, self.l_win,
                                          self.decim)
            re, im = re[:, :self.dec_cap], im[:, :self.dec_cap]
        else:
            xr, xi = window_gather.gather(planes, starts2, self.l_win)
            re, im = fused_frontend.rotate_decimate(
                xr, xi, ks, self.ramp, self.taps, self.decim, self.dec_cap)
        dm = self.downmix(torch.complex(re, im), params[2], bins,
                          params[4])
        dd = self.demod(dm.samples, dm.n_samples, dm.direction)
        return pack_outputs(dm, dd, 2 * self.max_symbols,
                            self.want_llr)


class Pipeline:
    """Offline decode on one device. `device=None` means the current CUDA
    device and raises when there is none; `device="cpu"` runs the plain
    versions of the kernels on the CPU. `want_llr` carries each frame's
    u16-quantised LLRs to the host (frame key "llr"; zeros without it)
    for the protocol decoders."""

    def __init__(self,
                 det_cfg: DetectorConfig | None = None,
                 dm_cfg: DownmixConfig | None = None,
                 burst_batch: int = 128,
                 use_gardner: bool = True,
                 start_time_ns: int | None = None,
                 device: str | torch.device | None = None,
                 want_llr: bool = True):
        self.device = device_mod.resolve(device)
        det_cfg = det_cfg or DetectorConfig()
        dm_cfg = dm_cfg or DownmixConfig()
        self.p: DetectorParams = det_cfg.derived()
        self.dmp: DownmixParams = dm_cfg.derived(self.p)
        p, dmp = self.p, self.dmp
        if self.device.type == "cuda" and not detect_scan.supports(p):
            raise ValueError("detector configuration not supported by the "
                             "scan kernel")
        self.use_gardner = use_gardner
        self.want_llr = want_llr
        taps = downmix.make_consts(dmp).input_taps
        self.in_ntaps = len(taps)
        self.input_taps = torch.from_numpy(taps).to(self.device)
        self.ramp = fused_frontend.ramp_table(p.fft_size, self.device)
        ALIGN = window_gather.ALIGN
        # extraction window capacity: the longest [start, stop+pre)
        # window and enough input for dec_cap outputs, plus one ALIGN of
        # alignment lead
        self.l_ext = _round_up(
            max(p.max_extract,
                (dmp.dec_cap - 1) * dmp.decimation + self.in_ntaps)
            + ALIGN, ALIGN)
        # per-block device stream: [tail | block | zero pad]
        self.stream_len = p.block_samples + 2 * self.l_ext

        # Window classes (iridium_tpu/runtime/pipeline.py:460-536): typical bursts fit a
        # quarter of the full window; only the simplex band (above
        # SIMPLEX_FREQUENCY_MIN, routed by bin with a margin over the
        # largest fine-CFO correction) carries the long 444-symbol frames.
        self.l_small = min(self.l_ext, _round_up(
            p.burst_pre_len + p.burst_post_len + 120_000 + self.in_ntaps
            + ALIGN, ALIGN))
        dec_small = (self.l_small - self.in_ntaps) // dmp.decimation + 1
        dec_large = (self.l_ext - self.in_ntaps) // dmp.decimation + 1
        batch_large = max(8, burst_batch // 8)
        margin_hz = 150e3
        self.simplex_bin_min = int(np.floor(
            (iridium.SIMPLEX_FREQUENCY_MIN - margin_hz
             - p.center_frequency) * p.fft_size / p.sample_rate)
        ) + p.fft_size // 2
        cap_n = int(iridium.MAX_FRAME_LENGTH_NORMAL
                    * dmp.samples_per_symbol) + 8
        self.small_normal = BurstClass(self, self.l_small, dec_small,
                                       2 * burst_batch, cap_n)
        self.small_simplex = BurstClass(self, self.l_small, dec_small,
                                        3 * batch_large,
                                        dmp.max_frame_samples)
        self.large = BurstClass(self, self.l_ext, dec_large,
                                3 * batch_large, dmp.max_frame_samples)
        self.reset(start_time_ns)

    def reset(self, start_time_ns: int | None = None) -> None:
        """Fresh stream state."""
        self.state = state_mod.init_state(self.p, self.device)
        self.tail = torch.zeros((2, self.l_ext), dtype=torch.float32,
                                device=self.device)
        self._rebase = False
        self.base_index = 0          # absolute sample index of block start
        self.prev_tagged = 0
        self.stats = PipelineStats()
        self.start_time_ns = start_time_ns
        # cumulative host wall seconds per stage; both stages end in a
        # device-to-host copy, so they include the device work they wait
        # for ("detect_s": detect step; "bursts_s": class batches, host
        # routing and frame building)
        self.timing = collections.Counter()

    # ---- block processing ----

    def _step(self, samples: np.ndarray, n_valid: int):
        """Detect step for one block; returns the block's stream planes
        and its gone table on the host."""
        p, dev = self.p, self.device
        if self.start_time_ns is None:
            self.start_time_ns = time.time_ns()
        if samples.shape != (p.block_samples,):
            raise ValueError(f"block of shape {samples.shape}, expected "
                             f"({p.block_samples},)")
        block = torch.from_numpy(
            np.ascontiguousarray(samples, np.complex64)).to(dev)
        if self._rebase:
            state_mod.rebase_(self.state, p.block_samples)
        self.state = detect_scan.detect_block(block, self.state, n_valid, p)
        bs, l_ext = p.block_samples, self.l_ext
        planes = torch.zeros((2, self.stream_len), dtype=torch.float32,
                             device=dev)
        planes[:, :l_ext] = self.tail
        planes[:, l_ext:l_ext + bs] = torch.view_as_real(block).T
        self.tail = planes[:, bs:bs + l_ext].clone()
        st = self.state
        head = torch.stack([st.g_count, st.n_tagged, st.burst_dropped,
                            st.create_waits, st.g_count * 0,
                            st.g_count * 0])
        rows = torch.stack([st.g_id, st.g_start, st.g_stop, st.g_bin,
                            st.g_mag.view(torch.int32),
                            st.g_noise.view(torch.int32)], 1)
        table = torch.cat([head[None], rows]).cpu().numpy()
        self._rebase = True
        self.stats.n_samples += n_valid
        base = self.base_index
        self.base_index += p.block_samples
        return planes, table, base

    def _route(self, g: dict, base_index: int) -> dict:
        """Burst routing (`_route_group`): the window start of each gone
        burst in the block's stream, decomposed for the front-end
        (tile * ALIGN + r + lead; ops/window_gather.py), and the class
        split by lead-inflated extraction length."""
        p = self.p
        ALIGN = window_gather.ALIGN
        decim = self.dmp.decimation
        abs_start = g["start"].astype(np.int64) + base_index
        cl = np.maximum(abs_start, 0)
        el = (g["stop"].astype(np.int64) + p.burst_pre_len
              + base_index - cl)
        el = np.minimum(el, self.l_ext - ALIGN)
        flat_start = cl - base_index + self.l_ext
        r = flat_start % decim
        tile = (flat_start - r) // ALIGN
        lead = flat_start - (tile * ALIGN + r)
        ext_infl = el + lead
        small = ext_infl <= self.l_small
        return dict(
            params=np.stack([tile, r, ext_infl, g["bin"], lead // decim]
                            ).astype(np.int32),
            abs_al=cl - lead,
            small=np.nonzero(small)[0], large=np.nonzero(~small)[0])

    def _finish(self, planes: torch.Tensor, table: np.ndarray,
                base_index: int) -> list[dict]:
        """Demodulate one block's gone bursts; frames sorted by id."""
        p, dmp = self.p, self.dmp
        g_count, n_tagged = int(table[0, 0]), int(table[0, 1])
        st = self.stats
        self.prev_tagged = max(self.prev_tagged, n_tagged)
        st.n_detected += g_count
        st.n_dropped = self.prev_tagged - st.n_detected
        st.n_em_dropped = max(st.n_em_dropped, int(table[0, 2]))
        st.n_create_waits = max(st.n_create_waits, int(table[0, 3]))
        if g_count <= 0:
            return []
        rows = table[1:1 + g_count]
        g = dict(id=rows[:, 0], start=rows[:, 1], stop=rows[:, 2],
                 bin=rows[:, 3], mag=rows[:, 4].view(np.float32),
                 noise=rows[:, 5].view(np.float32))
        info = self._route(g, base_index)
        small = info["small"]
        sim = g["bin"][small] >= self.simplex_bin_min
        jobs, outs = [], []
        for cls, idx in ((self.small_normal, small[~sim]),
                         (self.small_simplex, small[sim]),
                         (self.large, info["large"])):
            for r0 in range(0, len(idx), cls.batch):
                sel = idx[r0:r0 + cls.batch]
                params = torch.from_numpy(
                    np.ascontiguousarray(info["params"][:, sel])
                ).to(self.device)
                outs.append(cls.run(planes, params).reshape(-1))
                jobs.append((cls, sel))
        flat = torch.cat(outs).cpu().numpy()
        self.timing["batches"] += len(jobs)

        frames, o = [], 0
        for cls, sel in jobs:
            W = packed_width(cls.max_symbols, self.want_llr)
            packed = flat[o:o + len(sel) * W].reshape(len(sel), W)
            o += len(sel) * W
            u = unpack_outputs(packed, cls.max_symbols, self.want_llr)
            st.n_handled += int(u["dm_ok"].sum())
            ok = u["dm_ok"] & u["dd_ok"]
            st.n_ok += int(ok.sum())
            js = np.nonzero(ok)[0]
            if len(js) == 0:
                continue
            e = sel[js]
            frames += build_frames_np(
                p, dmp, self.in_ntaps, self.start_time_ns, g["id"][e],
                g["bin"][e], g["mag"][e], g["noise"][e], info["abs_al"][e],
                u, js)
        frames.sort(key=lambda f: f["id"])
        return frames

    def process_block(self, samples: np.ndarray, n_valid: int
                      ) -> list[dict]:
        """Feed one block (padded to block_samples); returns its frames."""
        t0 = time.perf_counter()
        ctx = self._step(samples, n_valid)
        t1 = time.perf_counter()
        frames = self._finish(*ctx)
        self.timing["detect_s"] += t1 - t0
        self.timing["bursts_s"] += time.perf_counter() - t1
        self.timing["blocks"] += 1
        return frames

    def run_blocks(self, blocks) -> Iterator[list[dict]]:
        """`blocks` yields (samples, n_valid); yields each block's frames."""
        for samples, n_valid in blocks:
            yield self.process_block(samples, n_valid)

    def run_file(self, path: str, fmt: str | None = None) -> Iterator[dict]:
        for frames in self.run_blocks(
                readers.read_blocks(path, self.p.block_samples, fmt)):
            yield from frames

    def run_array(self, samples: np.ndarray) -> Iterator[dict]:
        bs = self.p.block_samples

        def blocks():
            for i0 in range(0, len(samples), bs):
                chunk = samples[i0:i0 + bs]
                n_valid = len(chunk)
                if n_valid < bs:
                    chunk = np.concatenate(
                        [chunk, np.zeros(bs - n_valid, np.complex64)])
                yield chunk, n_valid

        for frames in self.run_blocks(blocks()):
            yield from frames

    def noise_floor_db(self) -> float:
        """Average noise floor in dBFS/Hz (burst_detect.c:363-380)."""
        p = self.p
        avg = float(self.state.baseline_sum.sum()) \
            / (p.fft_size * p.history_size)
        bin_width = p.sample_rate / p.fft_size
        if avg > 0 and bin_width > 0:
            return 10.0 * np.log10(avg / bin_width)
        return -120.0

    def peak_signal_db(self) -> float:
        """Strongest detection so far, in dB (the diagnostic display)."""
        return float(self.state.peak_signal_db)
