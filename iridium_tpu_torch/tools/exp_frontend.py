"""Fused front-end at the three burst classes' batches of a 10 MHz decode.

    python -m iridium_tpu_torch.tools.exp_frontend [--source PATH ...]
        [--phases]
    python -m iridium_tpu_torch.tools.exp_frontend --device cpu --small

The shapes are the batches the group program of
`Pipeline(DetectorConfig(sample_rate=10_000_000, frames_per_block=2048,
gone_capacity=2048))` runs for its three classes (jobs x bursts a job),
at the production 801 taps and decimation 40 (F = 8192): small normal
(B = 1,024, l_win = 327,680), small simplex (96, 327,680) and large (48,
1,126,400). Each class gets random planes of a 4-block group's streams
and random window starts and bin offsets from a seeded generator.

For the package's kernel and each `--source` (another kernel source with
the same C entry point, built through `tools/variants.py`; an earlier
design kept under build/, say) the tool checks the output against
`fused_plain` (max |err|), and prints the median single-call time, its
share of the bound, the plain version's time and the library call's
(elementwise rotate and a strided `conv1d` on windows gathered
beforehand). `--phases` also builds each source with its `// phase:`
markers turned into clock64() probes (`exp_scan.probed_source`) and
prints thread 0's share of cycles per phase. On the CPU (`--small`) the
package runs `fused_plain` at a small shape, timed with the host clock.

The bound is the larger of the bytes time (each covered stream sample
read once, each output written once, at 3.35 TB/s) and f32-grade
products on the tensor cores (3 TF32 multiply-adds per tap product at
495 TFLOP/s); the FP32-FMA time (67 TFLOP/s) is printed beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import _kernels, device as device_mod
from ..config import DetectorConfig, DownmixConfig
from ..dsp import downmix
from ..ops import fused_frontend as ff
from ..ops import window_gather as wg
from . import exp_scan, variants
from .exp_block_gather import single_ms

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

SEED = 1235
F, DECIM = 8192, 40
# samples of a 4-block group's planes, each block's stream
# [tail | block | zero pad]
GROUP_10MHZ = 4 * (2048 * 8192 + 2 * 1_126_400)
CLASSES = (("small_normal", 1024, 327_680), ("small_simplex", 96, 327_680),
           ("large", 48, 1_126_400))
SMALL = (("small", 4, 2 * wg.ALIGN),)


def production_taps() -> np.ndarray:
    p = DetectorConfig(sample_rate=10_000_000, frames_per_block=2048,
                       gone_capacity=2048).derived()
    return np.asarray(downmix.make_consts(DownmixConfig().derived(p))
                      .input_taps)


def frontend_inputs(dev, gen, B: int, l_win: int, fft_size: int,
                    n_stream: int):
    """Random (2, n_stream) planes, B window starts [tile, r < 40] that
    keep the windows inside the stream, and B bin offsets in
    [-F/2, F/2)."""
    planes = torch.randn((2, n_stream), device=dev, generator=gen)
    n_tiles = (n_stream - l_win - 4096) // wg.ALIGN
    tiles = torch.randint(0, n_tiles, (B,), device=dev, generator=gen)
    rs = torch.randint(0, 40, (B,), device=dev, generator=gen)
    starts2 = torch.stack([tiles, rs], 1).int().contiguous()
    ks = torch.randint(-fft_size // 2, fft_size // 2, (B,), device=dev,
                       generator=gen).int()
    return planes, starts2, ks


def covered_samples(starts2, span: int, n: int) -> int:
    """Distinct stream samples that the windows [start, start + span)
    cover: the input a gather must read at least once."""
    s = starts2[:, 0].long() * wg.ALIGN + starts2[:, 1].long()
    edge = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
    edge.index_add_(0, s.clamp(max=n), torch.ones_like(s))
    edge.index_add_(0, (s + span).clamp(max=n), -torch.ones_like(s))
    return int((edge.cumsum(0)[:n] > 0).sum())


def bound(planes, starts2, l_win: int, ntaps: int, decim: int) -> dict:
    """The least time of the front-end's work on these inputs: the bytes
    time and the f32-grade tensor time, the larger is the bound; the
    FP32-FMA time beside them."""
    B = starts2.shape[0]
    n_out = l_win // decim
    span = (n_out - 1) * decim + ntaps
    n_bytes = (8 * covered_samples(starts2, span, planes.shape[1])
               + 8 * B * n_out + 4 * ntaps)
    mads = 2.0 * ntaps * B * n_out         # tap products, both planes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    tensor_ms = 3 * 2 * mads / TF32_FLOP_PER_S * 1e3
    fp32_ms = 2 * mads / FP32_FLOP_PER_S * 1e3
    by = "bytes" if bytes_ms >= tensor_ms else "operations"
    return dict(bound_ms=max(bytes_ms, tensor_ms), bound_by=by,
                bytes_ms=bytes_ms, tensor_ms=tensor_ms, fp32_fma_ms=fp32_ms)


def time_ms(fn, dev: torch.device, reps: int = 11) -> float:
    """Median single-call CUDA-event time on the card; the host clock's
    mean over `reps` calls on the CPU."""
    if dev.type == "cuda":
        return single_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_shares(kernel: _kernels.Kernel, run) -> dict:
    """Thread 0's share of cycles per `// phase:` of `kernel`'s source,
    from a probed build, over one call of `run` after a warm-up call."""
    text, names = exp_scan.probed_source(kernel.source.read_text(),
                                         "fused_frontend")
    probed = variants.Variant(_kernels.FUSED_FRONTEND, text)
    with variants.swapped("FUSED_FRONTEND", probed):
        run()
        exp_scan.phases(probed)
        run()
        cyc, _ = exp_scan.phases(probed)
    total = sum(cyc[:len(names)]) or 1
    return {n: cyc[i] / total for i, n in enumerate(names)}


def run_class(name: str, B: int, l_win: int, dev: torch.device, cands,
              taps_np: np.ndarray, n_stream: int, phases: bool) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    planes, starts2, ks = frontend_inputs(dev, gen, B, l_win, F, n_stream)
    taps = torch.from_numpy(taps_np).to(dev)
    ramp = ff.ramp_table(F, dev)
    args = (planes, starts2, ks, taps, ramp, l_win, DECIM)
    want = ff.fused_plain(*args)
    plain_ms = time_ms(lambda: ff.fused_plain(*args), dev, reps=3)
    ntaps = taps.shape[0]
    n_out = l_win // DECIM
    x_re, x_im = wg.gather_plain(planes, starts2, (n_out - 1) * DECIM + ntaps)
    lib_ms = time_ms(lambda: ff.rotate_decimate(x_re, x_im, ks, ramp, taps,
                                                DECIM, n_out), dev, reps=3)
    del x_re, x_im
    bnd = bound(planes, starts2, l_win, ntaps, DECIM)
    rows = []
    for design, k in cands:
        with variants.swapped("FUSED_FRONTEND", k):
            err = max(float((a - b).abs().max())
                      for a, b in zip(ff.fused(*args), want))
            ms = time_ms(lambda: ff.fused(*args), dev)
            row = dict(shape=name, B=B, l_win=l_win, design=design,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, **bnd)
            # the bound is the card's: no share of it for a CPU time
            row["share_of_bound"] = (bnd["bound_ms"] / ms
                                     if dev.type == "cuda" else None)
            if phases:
                row["phases"] = phase_shares(k, lambda: ff.fused(*args))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_frontend",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="one small shape, for the CPU")
    ap.add_argument("--source", action="append", default=[],
                    help="kernel source to check and time beside the "
                    "package's, repeatable (card only)")
    ap.add_argument("--phases", action="store_true",
                    help="per-phase cycle shares from probed builds (card "
                    "only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if dev.type != "cuda" and (args.source or args.phases):
        ap.error("--source and --phases need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    cands = (variants.candidates(_kernels.FUSED_FRONTEND, args.source)
             if dev.type == "cuda" else [("package", _kernels.FUSED_FRONTEND)])
    shapes = SMALL if args.small else CLASSES
    taps = production_taps()
    for cls, B, l_win in shapes:
        n_stream = l_win + 4 * wg.ALIGN if args.small else GROUP_10MHZ
        for r in run_class(cls, B, l_win, dev, cands, taps, n_stream,
                           args.phases):
            share = r["share_of_bound"]
            share = "" if share is None else f"{100 * share:.1f}% of bound, "
            print(f"{r['shape']} {r['design']}: {r['ms']:.4f} ms, {share}"
                  f"max|err| {r['max_abs_err']:.3g} " + json.dumps(r),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
