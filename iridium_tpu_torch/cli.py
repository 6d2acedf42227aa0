"""Command-line interface of the port: offline decode of a capture file to
`RAW:` lines on stdout, with the JAX package's RAW-mode flags
(iridium_tpu/cli.py) plus `--device`.

    iridium-tpu-torch -f capture.cf32            # on the GPU
    iridium-tpu-torch -f capture.cf32 --device cpu

Stats line: the gr-iridium-format 1 Hz stderr line (main.c:483-501).
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import DetectorConfig, DownmixConfig
from .output.raw import RawPrinter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iridium-tpu-torch",
        description="Iridium burst detector and demodulator on a GPU "
                    "(PyTorch/CUDA). Outputs iridium-toolkit compatible "
                    "RAW format to stdout.")
    p.add_argument("-f", "--file", help="read IQ samples from file")
    p.add_argument("--format", choices=("ci8", "ci16", "cf32"),
                   help="IQ file format (default: by extension, else ci8)")
    p.add_argument("-c", "--center-freq", type=float, default=1_622_000_000,
                   help="center frequency in Hz (default: 1622000000)")
    p.add_argument("-r", "--sample-rate", type=int, default=10_000_000,
                   help="sample rate in Hz (default: 10000000)")
    p.add_argument("-d", "--threshold", type=float, default=16.0,
                   help="burst detection threshold in dB (default: 16.0)")
    p.add_argument("--file-info", default=None,
                   help="file info string for output (default: auto)")
    p.add_argument("--no-gardner", action="store_true",
                   help="disable Gardner timing recovery")
    p.add_argument("--burst-batch", type=int, default=128,
                   help="device burst batch size")
    p.add_argument("--frames-per-block", type=int, default=512,
                   help="FFT frames per device block")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain versions of the kernels)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.file:
        print("error: -f/--file required", file=sys.stderr)
        return 2
    from .runtime.pipeline import Pipeline   # deferred: imports torch

    det = DetectorConfig(center_frequency=args.center_freq,
                         sample_rate=args.sample_rate,
                         threshold_db=args.threshold,
                         frames_per_block=args.frames_per_block)
    pipe = Pipeline(det_cfg=det, dm_cfg=DownmixConfig(),
                    burst_batch=args.burst_batch,
                    use_gardner=not args.no_gardner,
                    device=args.device)
    printer = RawPrinter(args.file_info)
    t_start = last = time.time()
    prev = dict(det=0, ok=0, handled=0, samples=0)

    def stats_line() -> None:
        nonlocal last, prev
        now = time.time()
        dt = now - last
        if dt < 1.0:
            return
        s = pipe.stats
        elapsed = now - t_start
        dd = s.n_detected - prev["det"]
        dk = s.n_ok - prev["ok"]
        dh = s.n_handled - prev["handled"]
        srr = (s.n_samples - prev["samples"]) / (args.sample_rate * dt) * 100
        in_ok = 100.0 * dk / dd if dd > 0 else 0
        ok_avg = 100.0 * s.n_ok / s.n_detected if s.n_detected else 0
        print(f"{int(now)} | srr: {srr:5.1f}%"
              f" | i_avg: {s.n_detected / elapsed:3.0f}/s"
              f" | i_ok: {in_ok:3.0f}%"
              f" | o: {dh / dt:4.0f}/s"
              f" | ok: {dk / dt:3.0f}/s"
              f" | ok_avg: {ok_avg:3.0f}%"
              f" | ok: {s.n_ok:10d}"
              f" | d: {s.n_dropped}", file=sys.stderr)
        last = now
        prev = dict(det=s.n_detected, ok=s.n_ok, handled=s.n_handled,
                    samples=s.n_samples)

    for frame in pipe.run_file(args.file, args.format):
        print(printer.format(frame))
        stats_line()
    print(f"burst_detect: tagged {pipe.stats.n_detected} bursts total",
          file=sys.stderr)
    if pipe.stats.n_em_dropped or pipe.stats.n_create_waits:
        print(f"burst_detect: {pipe.stats.n_em_dropped} emission-cap "
              f"drops, {pipe.stats.n_create_waits} deferred creations",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
