"""Pipeline configuration with the reference's derived-parameter math.

Parity sources:
  - Detector derivation: reference `burst_detect.c:174-323`
    (fft size = pow2 nearest to 1 ms, pre/post lengths, burst width in bins,
     max bursts, linear threshold with Blackman ENBW normalisation).
  - Downmix derivation: reference `burst_downmix.c:223-373`
    (250 kHz output rate, filter bank, CFO/correlation FFT sizing).
"""

from __future__ import annotations

import dataclasses
import math

from . import iridium


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    center_frequency: float = float(iridium.DEFAULT_CENTER_FREQ)
    sample_rate: int = 10_000_000
    fft_size: int = 0                 # 0 = derive (~1 ms, nearest pow2)
    burst_pre_len: int = 0            # 0 = 2 * fft_size
    burst_post_len: int = 0           # 0 = 16 ms
    burst_width_hz: int = iridium.DEFAULT_BURST_WIDTH_HZ
    max_bursts: int = 0               # 0 = derive
    max_burst_len: int = 0            # 0 = 90 ms
    threshold_db: float = iridium.DEFAULT_THRESHOLD_DB
    history_size: int = iridium.DEFAULT_HISTORY_SIZE

    # TPU batching knobs (no reference equivalent: the reference streams
    # sample-by-sample; we process fixed blocks of FFT frames).
    frames_per_block: int = 1024      # block = frames_per_block * fft_size samples
    burst_capacity: int = 256         # max simultaneous tracked bursts
    max_new_per_frame: int = 32       # greedy peak->burst creations per frame
    gone_capacity: int = 512          # max emitted bursts per block

    def derived(self) -> "DetectorParams":
        fft_size = self.fft_size
        if fft_size <= 0:
            n = round(math.log2(self.sample_rate / 1000.0))
            fft_size = 1 << int(n)
        pre = self.burst_pre_len if self.burst_pre_len > 0 else 2 * fft_size
        post = (self.burst_post_len if self.burst_post_len > 0
                else int(self.sample_rate * 16e-3))
        width_bins = self.burst_width_hz // (self.sample_rate // fft_size)
        max_bursts = (self.max_bursts if self.max_bursts > 0 else
                      int((self.sample_rate / float(self.burst_width_hz)) * 0.8))
        max_burst_len = (self.max_burst_len if self.max_burst_len > 0
                         else int(self.sample_rate * 0.09))
        # Linear threshold normalised by history size and Blackman ENBW
        threshold = (10.0 ** (self.threshold_db / 10.0)
                     / self.history_size / 1.72)
        # History tail carried between blocks: longest possible burst
        # extraction window ([start, stop + pre) with stop-start bounded by
        # max_burst_len + post + one frame, plus the pre-trigger lead-in).
        max_extract = max_burst_len + post + fft_size + 2 * pre
        return DetectorParams(
            center_frequency=self.center_frequency,
            sample_rate=self.sample_rate,
            fft_size=fft_size,
            burst_pre_len=pre,
            burst_post_len=post,
            burst_width_bins=width_bins,
            max_bursts=max_bursts,
            max_burst_len=max_burst_len,
            threshold=threshold,
            history_size=self.history_size,
            frames_per_block=self.frames_per_block,
            burst_capacity=self.burst_capacity,
            max_new_per_frame=self.max_new_per_frame,
            gone_capacity=self.gone_capacity,
            max_extract=max_extract,
        )


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    center_frequency: float
    sample_rate: int
    fft_size: int
    burst_pre_len: int
    burst_post_len: int
    burst_width_bins: int
    max_bursts: int
    max_burst_len: int
    threshold: float
    history_size: int
    frames_per_block: int
    burst_capacity: int
    max_new_per_frame: int
    gone_capacity: int
    max_extract: int

    @property
    def block_samples(self) -> int:
        return self.frames_per_block * self.fft_size


@dataclasses.dataclass(frozen=True)
class DownmixConfig:
    output_sample_rate: int = iridium.DEFAULT_SPS * iridium.SYMBOLS_PER_SECOND
    search_depth: int = 0             # 0 = output_sample_rate (1 second)

    def derived(self, det: DetectorParams) -> "DownmixParams":
        out_rate = self.output_sample_rate
        sps = out_rate / iridium.SYMBOLS_PER_SECOND
        search_depth = self.search_depth if self.search_depth > 0 else out_rate
        pre_start = int(100e-6 * out_rate)

        decimation = max(1, round(det.sample_rate / out_rate))

        # CFO FFT: floor-to-pow2 of 26 symbols, x16 zero-pad oversample
        raw = int(sps * 26)
        cfo_fft = 1
        while cfo_fft * 2 <= raw:
            cfo_fft *= 2
        cfo_fft_total = cfo_fft * 16

        # Correlation FFT sizing
        sync_search_len = int(
            (iridium.PREAMBLE_LENGTH_LONG + iridium.UW_LENGTH + 8) * sps)
        ul_sync_samples = int(
            (iridium.PREAMBLE_LENGTH_SHORT + iridium.UW_LENGTH) * sps)
        corr_fft = _next_pow2(sync_search_len + ul_sync_samples)

        # Padded per-burst decimated length
        input_ntaps = int(4.0 / (50_000.0 / 10_000_000.0)) | 1  # 801, fixed design
        dec_cap = (det.max_extract - input_ntaps + 1) // decimation
        dec_cap = min(dec_cap, 2 * 1024 * 1024 // decimation)
        # round up to a lane-friendly multiple
        dec_cap = ((dec_cap + 127) // 128) * 128

        max_frame_samples = int(iridium.MAX_FRAME_LENGTH_SIMPLEX * sps)

        return DownmixParams(
            output_sample_rate=out_rate,
            samples_per_symbol=sps,
            search_depth=search_depth,
            pre_start_samples=pre_start,
            decimation=decimation,
            cfo_fft_size=cfo_fft,
            cfo_fft_total=cfo_fft_total,
            sync_search_len=sync_search_len,
            corr_fft_size=corr_fft,
            dec_cap=dec_cap,
            max_frame_samples=max_frame_samples,
        )


@dataclasses.dataclass(frozen=True)
class DownmixParams:
    output_sample_rate: int
    samples_per_symbol: float
    search_depth: int
    pre_start_samples: int
    decimation: int
    cfo_fft_size: int
    cfo_fft_total: int
    sync_search_len: int
    corr_fft_size: int
    dec_cap: int                      # padded per-burst decimated length
    max_frame_samples: int

    @property
    def max_symbols(self) -> int:
        # Gardner advances by at least sps - 0.5 per step
        return int(self.max_frame_samples / (self.samples_per_symbol - 0.5)) + 4
