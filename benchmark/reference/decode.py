"""The reference decode of one group of blocks, as the program's timed
path groups them: the detect steps, the stream planes, the routing of the
gone bursts into the three burst classes, each class's front-end, downmix
and demodulator, then the frames and their `RAW:` lines.

Frozen copy of the arithmetic of `iridium_tpu_torch/runtime/pipeline.py`
(`BurstDecoder.__init__`'s window sizes, `_burst_classes`, `route` and
`_route_windows`' window decomposition and class split, `_parse_round`'s
`locate`, `build_frames_np`) and `iridium_tpu_torch/output/raw.py`
(`RawPrinter.format`). Every member of a class runs in one batch here, in
slices of rows (a row's result does not depend on its batch); the program
runs fixed batches in rounds. A block's windows read only its own segment
of the group's stream planes ([tail | block | zeros]); its place in the
group sets where that segment lies, and so each window's decomposition.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import demod as demod_mod
from . import downmix, frontend, iridium, scan
from .config import DetectorConfig, DownmixConfig

ALIGN = frontend.ALIGN
ROWS = 1024         # bursts a slice of a class batch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BurstClassRef:
    """A burst class: its window, its decimated length, its downmix and
    its demodulator."""
    l_win: int
    dec_cap: int
    downmix: downmix.Downmix
    demod: demod_mod.Demod


class Decoder:
    """The reference's constants for one configuration: the detector and
    downmix parameters, the front-end's taps and ramp, the window sizes
    and the three burst classes (small-normal, small-simplex, large)."""

    def __init__(self, sample_rate: int, frames_per_block: int,
                 gone_capacity: int, use_gardner: bool, device):
        self.device = dev = torch.device(device)
        self.p = p = DetectorConfig(
            sample_rate=sample_rate, frames_per_block=frames_per_block,
            gone_capacity=gone_capacity).derived()
        self.dmp = dmp = DownmixConfig().derived(p)
        taps = downmix.make_consts(dmp).input_taps
        self.in_ntaps = len(taps)
        self.taps = torch.from_numpy(taps).to(dev)
        self.ramp = frontend.ramp_table(p.fft_size, dev)
        self.window = scan.frame_window(p, dev)
        self.l_ext = _round_up(
            max(p.max_extract,
                (dmp.dec_cap - 1) * dmp.decimation + self.in_ntaps)
            + ALIGN, ALIGN)
        self.l_small = min(self.l_ext, _round_up(
            p.burst_pre_len + p.burst_post_len + 120_000 + self.in_ntaps
            + ALIGN, ALIGN))
        dec_small = (self.l_small - self.in_ntaps) // dmp.decimation + 1
        dec_large = (self.l_ext - self.in_ntaps) // dmp.decimation + 1
        self.simplex_bin_min = int(np.floor(
            (iridium.SIMPLEX_FREQUENCY_MIN - 150e3 - p.center_frequency)
            * p.fft_size / p.sample_rate)) + p.fft_size // 2
        self.stream_len = p.block_samples + 2 * self.l_ext
        sps = dmp.samples_per_symbol
        cap_n = int(iridium.MAX_FRAME_LENGTH_NORMAL * sps) + 8
        self.classes = []
        for l_win, dec_cap, cap in ((self.l_small, dec_small, cap_n),
                                    (self.l_small, dec_small,
                                     dmp.max_frame_samples),
                                    (self.l_ext, dec_large,
                                     dmp.max_frame_samples)):
            S = int(cap / (sps - 0.5)) + 4      # the class's symbol cap
            self.classes.append(BurstClassRef(
                l_win, dec_cap, downmix.Downmix(p, dmp, dec_cap, cap, dev),
                demod_mod.Demod(S, sps, use_gardner, dev)))

    # ---- detection ----

    def detect(self, x: torch.Tensor, state: scan.ScanState,
               bf16: bool = False) -> scan.ScanState:
        """The detect step of block x ((block_samples,) c64) from `state`,
        the input of its scan (left as it is). `bf16` rounds the |X|^2
        rows to bfloat16 first: the control's detector, never the
        reference's."""
        p = self.p
        mag2 = scan.spectrogram(x.to(self.device), p, self.window)
        if bf16:
            mag2 = mag2.bfloat16().float()
        return scan.scan_plain(mag2, state, p.block_samples, p)

    # ---- the block's stream segment, routing and classes ----

    def planes(self, x: torch.Tensor, tail: torch.Tensor, bi: int,
               agg: int) -> torch.Tensor:
        """The group program's (2, agg * stream_len) f32 planes with block
        x's segment [tail | x | zeros] at position bi (the tail: the last
        l_ext samples before the block, (l_ext,) c64); the other
        segments, which none of x's windows reads, left zero."""
        bs, l_ext, sl = self.p.block_samples, self.l_ext, self.stream_len
        out = torch.zeros((2, agg * sl), dtype=torch.float32,
                          device=self.device)
        seg = out[:, bi * sl:(bi + 1) * sl]
        seg[:, :l_ext] = torch.view_as_real(tail.to(self.device)).T
        seg[:, l_ext:l_ext + bs] = torch.view_as_real(x.to(self.device)).T
        return out

    def route(self, s: scan.ScanState, bi: int, base0: int) -> list[dict]:
        """Each gone burst of the state of block bi of a group (whose first
        block starts at absolute sample base0) as a dict: its row fields,
        window (tile, r, ext_len with lead, shift_dec), class and absolute
        start for the timestamp."""
        p, decim = self.p, self.dmp.decimation
        bs, sl, l_ext = p.block_samples, self.stream_len, self.l_ext
        n = int(s.g_count)
        cols = {f: getattr(s, f)[:n].cpu().numpy() for f in
                ("g_id", "g_start", "g_stop", "g_bin", "g_mag", "g_noise")}
        bursts = []
        for j in range(n):
            start, stop = int(cols["g_start"][j]), int(cols["g_stop"][j])
            t_cl = max(start + bi * bs, -base0)
            el = min(stop + bi * bs + p.burst_pre_len - t_cl, l_ext - ALIGN)
            flat = t_cl + bi * (sl - bs) + l_ext
            r = flat % decim
            tile = (flat - r) // ALIGN
            lead = flat - (tile * ALIGN + r)
            ext = el + lead
            b = int(cols["g_bin"][j])
            cls = (2 if ext > self.l_small
                   else 1 if b >= self.simplex_bin_min else 0)
            bursts.append(dict(
                id=int(cols["g_id"][j]), bin=b, mag=float(cols["g_mag"][j]),
                noise=float(cols["g_noise"][j]), tile=tile, r=r, ext=ext,
                shift=lead // decim, cls=cls,
                abs_start=base0 + t_cl - lead))
        return bursts

    def run_class(self, c: int, planes: torch.Tensor, bursts: list,
                  tf32: bool = False) -> dict:
        """The class-c batch of `bursts` -> host arrays of the fields the
        frames need."""
        cl = self.classes[c]
        dev, F = self.device, self.p.fft_size
        parts = []
        for i0 in range(0, len(bursts), ROWS):
            bb = bursts[i0:i0 + ROWS]

            def col(k):
                return torch.tensor([b[k] for b in bb], dtype=torch.int64,
                                    device=dev)
            starts2 = torch.stack([col("tile"), col("r")], 1)
            re, im = frontend.fused_plain(
                planes, starts2, col("bin") - F // 2, self.taps, self.ramp,
                cl.l_win, self.dmp.decimation, tf32)
            dm = cl.downmix(torch.complex(re[:, :cl.dec_cap],
                                          im[:, :cl.dec_cap]),
                            col("ext"), col("bin"), col("shift"))
            dd = cl.demod(dm.samples, dm.n_samples, dm.direction)
            parts.append(dict(
                ok=(dm.ok & dd.ok).cpu().numpy(),
                n_sym=dd.n_symbols.cpu().numpy(),
                conf=dd.confidence.cpu().numpy(),
                level=dd.level.float().cpu().numpy(),
                direc=dd.direction.cpu().numpy(),
                sdec=dm.start_dec.cpu().numpy().astype(np.int64),
                fine=dm.fine_offset.float().cpu().numpy().astype(np.float64),
                total=dd.total_phase.float().cpu().numpy()
                .astype(np.float64),
                bits=dd.bits.cpu().numpy()))
        out = {k: np.concatenate([q[k] for q in parts]) for k in parts[0]
               if k != "bits"}
        out["bits"] = [row for q in parts for row in q["bits"]]
        return out

    def frames(self, bursts: list, u: dict, start_time_ns: int) -> list:
        """Frames of the ok rows (`build_frames_np`'s arithmetic)."""
        p, dmp = self.p, self.dmp
        F = p.fft_size
        out = []
        for i, b in enumerate(bursts):
            if not u["ok"][i]:
                continue
            ns = int(u["n_sym"][i])
            cf = (p.center_frequency + (b["bin"] - F // 2) / F
                  * p.sample_rate + u["fine"][i] * dmp.output_sample_rate)
            if ns > 0:
                cf = cf + (u["total"][i] / (max(ns, 1)
                                            / iridium.SYMBOLS_PER_SECOND)
                           / np.pi / 2.0)
            ts = (start_time_ns
                  + int(np.int64(b["abs_start"] / p.sample_rate * 1e9))
                  + (self.in_ntaps // 2) * 1_000_000_000 // p.sample_rate
                  + int(np.int64(u["sdec"][i] / dmp.output_sample_rate
                                 * 1e9)))
            out.append(dict(
                id=b["id"], timestamp_ns=ts, frequency=float(cf),
                magnitude=b["mag"], noise=b["noise"],
                confidence=int(u["conf"][i]), level=float(u["level"][i]),
                n_symbols=ns, direction="UL" if u["direc"][i] else "DL",
                bits=u["bits"][i][:2 * ns]))
        return out

    def decode(self, x: torch.Tensor, tail: torch.Tensor,
               state: scan.ScanState, bi: int, agg: int, base0: int,
               start_time_ns: int, tf32: bool = False) -> list:
        """The frames of block x, the bi-th of a group of agg blocks whose
        first starts at absolute sample base0, from its detect step's
        state (`detect`), sorted by burst id."""
        planes = self.planes(x, tail, bi, agg)
        bursts = self.route(state, bi, base0)
        frames = []
        for c in range(3):
            mine = [b for b in bursts if b["cls"] == c]
            if mine:
                frames += self.frames(
                    mine, self.run_class(c, planes, mine, tf32),
                    start_time_ns)
        return sorted(frames, key=lambda f: f["id"])


def format_raw(frame: dict, t0_ns: int, file_info: str) -> str:
    """A `RAW:` line (`RawPrinter.format`, frame_output.c:144-199)."""
    ts_ms = (frame["timestamp_ns"] - t0_ns) / 1e6
    freq_hz = int(frame["frequency"] + 0.5)
    n_payload = max(frame["n_symbols"] - 12, 0)
    bits = "".join("1" if b else "0" for b in frame["bits"])
    return (f"RAW: {file_info} {ts_ms:012.4f} {freq_hz:010d} "
            f"N:{frame['magnitude']:05.2f}{frame['noise']:+06.2f} "
            f"I:{frame['id']:011d} {frame['confidence']:3d}% "
            f"{frame['level']:.5f} {n_payload:3d} {bits}")
