"""Window gather at the burst classes' batches of the decodes that take
the window-gather path.

    python -m iridium_tpu_torch.tools.exp_window_gather [--rates 1,25]
        [--source PATH ...]
    python -m iridium_tpu_torch.tools.exp_window_gather --device cpu --small

The shapes follow the code: for each sample rate (in MHz; 1, 2.4, 5,
12.5 and 25 by default, whose decimations 4-100 have no fused front-end)
the tool reads the three classes' batches (B, l_win) from
`Pipeline(det_cfg=DetectorConfig(sample_rate=...), device="cpu")
.classes`, and the length of a group's stream (agg_blocks x stream_len).
Each shape gets random planes of that length and B random window starts
[tile, r < decimation] that keep the windows inside the stream; with
`--live N` only the first N windows do, and the rest start at [0, 0], as
the rows of a batch that no burst fills do in the pipeline.

For the package's kernel and each `--source` (another kernel source with
the same C entry point, built through `tools/variants.py`; a source whose
entry point takes no `order` scratch, as earlier designs did, gets an
adapter, so `git show <commit>:iridium_tpu_torch/csrc/window_gather.cu >
build/old.cu` can be timed as it is), the tool checks the output bit-equal
to `gather_plain` and prints its median single-call time (`ms`, which
holds the host's enqueue of the call), the time a call takes in a run
of calls launched back to back (`chained_ms`, the better of two runs),
the median single call after a 256 MB write that flushes L2
(`cold_ms`), the bound, the
share of the bound (single-call and chained), the time `fill_` takes to
write the same output bytes (`fill_ms`, the card's write rate at this
size), the plain version's time and advanced indexing's
(`planes[:, idx]`). The candidates are timed in turns, in order and then
in reverse. The bound counts each stream sample the windows cover read
once and each output byte written once, at 3.35 TB/s.

On the CPU (`--small`: 4 windows of 40,960 samples at decimation 100 from
a 163,840-sample stream) the package runs `gather_plain`, timed with the
host clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .. import _kernels, device as device_mod
from ..config import DetectorConfig
from ..ops import window_gather as wg
from . import variants
from .exp_block_gather import time_gather
from .exp_frontend import HBM_BYTES_PER_S, covered_samples

SEED = 1236
RATES_MHZ = (1.0, 2.4, 5.0, 12.5, 25.0)
CLASS_NAMES = ("small_normal", "small_simplex", "large")
SMALL = (dict(rate_mhz=0.0, shape="small", B=4, l_win=2 * wg.ALIGN,
              decim=100, n_stream=8 * wg.ALIGN),)
FLUSH_BYTES = 256 << 20


def class_shapes(rates_mhz=RATES_MHZ, **pipe_kw) -> list[dict]:
    """The three class batches of each rate's group program (the
    Pipeline's arguments `pipe_kw`, its defaults where none are given),
    with the decimation and the group stream's length."""
    from ..runtime.pipeline import Pipeline
    out = []
    for mhz in rates_mhz:
        pipe = Pipeline(det_cfg=DetectorConfig(
            sample_rate=int(round(mhz * 1e6))), device="cpu", **pipe_kw)
        for name, c in zip(CLASS_NAMES, pipe.classes):
            out.append(dict(rate_mhz=mhz, shape=name, B=c.batch,
                            l_win=c.l_win, decim=c.decim,
                            n_stream=pipe.agg_blocks * pipe.stream_len,
                            fused=c.fused))
    return out


def gather_inputs(dev, gen, B: int, l_win: int, decim: int,
                  n_stream: int):
    """Random (2, n_stream) planes and B window starts [tile, r < decim]
    whose windows lie inside the stream."""
    planes = torch.randn((2, n_stream), device=dev, generator=gen)
    n_tiles = (n_stream - l_win - decim) // wg.ALIGN + 1
    tiles = torch.randint(0, n_tiles, (B,), device=dev, generator=gen)
    rs = torch.randint(0, decim, (B,), device=dev, generator=gen)
    return planes, torch.stack([tiles, rs], 1).int().contiguous()


def bound_ms(starts2, l_win: int, n: int) -> float:
    """Each covered stream sample read once, each output byte written
    once (2 planes of f32), at the card's memory rate."""
    n_bytes = (8 * covered_samples(starts2, l_win, n)
               + 8 * starts2.shape[0] * l_win)
    return n_bytes / HBM_BYTES_PER_S * 1e3


def samples_ms(fn, dev: torch.device, reps: int, flush=None) -> list:
    """Single-call times after one warm-up call: CUDA events on the card
    (`flush` zeroed before each call, outside the events), the host clock
    on the CPU."""
    fn()
    out = []
    for _ in range(reps):
        if dev.type != "cuda":
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
            continue
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def adapted(text: str) -> str:
    """A source whose `window_gather` entry takes no `order` scratch,
    behind an entry with the package's argument list."""
    head = text[text.index('extern "C" int window_gather('):]
    if "order" in head[:head.index(")")]:
        return text
    text = text.replace('extern "C" int window_gather(',
                        'extern "C" int window_gather_unordered(', 1)
    return text + """
extern "C" int window_gather(const float* planes, long long n,
                             const int* starts2, int* order, int B,
                             int l_win, int align, float* out_re,
                             float* out_im, cudaStream_t stream) {
  return window_gather_unordered(planes, n, starts2, B, l_win, align,
                                 out_re, out_im, stream);
}
"""


def run_shape(sh: dict, dev: torch.device, cands, reps: int = 7
              ) -> list[dict]:
    """Each candidate at one shape: bit-equal to `gather_plain`, then timed
    in turns; one dict per candidate with the shape's bound, plain time
    and advanced indexing's time."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, l_win = sh["B"], sh["l_win"]
    planes, starts2 = gather_inputs(dev, gen, B, l_win, sh["decim"],
                                    sh["n_stream"])
    live = sh.get("live")
    if live is not None:
        starts2[live:] = 0
    want = wg.gather_plain(planes, starts2, l_win)
    fn = lambda: wg.gather(planes, starts2, l_win)  # noqa: E731
    for name, k in cands:
        with variants.swapped("WINDOW_GATHER", k):
            got = fn()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"window_gather {name} at {sh['shape']} "
                                 f"{sh['rate_mhz']} MHz: not bit-equal")
        del got
    del want
    flush = (torch.empty(FLUSH_BYTES // 4, device=dev)
             if dev.type == "cuda" else None)
    warm = {name: [] for name, _ in cands}
    cold = {name: [] for name, _ in cands}
    chain = {name: [] for name, _ in cands}
    for turn in (cands, cands[::-1]):
        for name, k in turn:
            with variants.swapped("WINDOW_GATHER", k):
                warm[name] += samples_ms(fn, dev, reps)
                chain[name].append(time_gather(fn, dev, reps))
                cold[name] += samples_ms(fn, dev, reps, flush)
    del flush
    # the card's write rate at this size: the same output bytes filled
    buf = torch.empty((2, B, l_win), device=dev)
    fill = time_gather(lambda: buf.fill_(1.0), dev, reps)
    del buf
    plain = statistics.median(samples_ms(
        lambda: wg.gather_plain(planes, starts2, l_win), dev, 3))
    idx = (starts2[:, 0].long() * wg.ALIGN
           + starts2[:, 1].long())[:, None] + torch.arange(l_win, device=dev)
    lib = statistics.median(samples_ms(lambda: planes[:, idx], dev, 3))
    del idx
    b_ms = bound_ms(starts2, l_win, planes.shape[1])
    out = []
    for name, _ in cands:
        ms = statistics.median(warm[name])
        ch = min(chain[name])
        out.append(dict(design=name, rate_mhz=sh["rate_mhz"],
                        shape=sh["shape"], B=B, l_win=l_win,
                        decim=sh["decim"], n_stream=sh["n_stream"],
                        live=live, max_abs_err=0.0, ms=ms, chained_ms=ch,
                        cold_ms=statistics.median(cold[name]),
                        bound_ms=b_ms, bound_by="bytes",
                        share_of_bound=b_ms / ms,
                        chained_share=b_ms / ch, fill_ms=fill,
                        plain_ms=plain, library_ms=lib))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_window_gather",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--rates", default=",".join(f"{r:g}" for r in RATES_MHZ),
                    help="comma-separated sample rates in MHz")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--live", type=int, default=None,
                    help="give only the first N windows of a batch random "
                    "starts and the rest [0, 0], as the pipeline's unused "
                    "batch rows have")
    ap.add_argument("--source", action="append", default=[],
                    help="time the package's kernel beside this kernel "
                    "source, repeatable (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if args.source and dev.type != "cuda":
        ap.error("--source needs the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    shapes = [dict(sh, live=args.live) for sh in (
        SMALL if args.small else
        class_shapes([float(r) for r in args.rates.split(",")]))]
    cands = (variants.candidates(_kernels.WINDOW_GATHER, args.source,
                                 adapted) if dev.type == "cuda"
             else [("package", _kernels.WINDOW_GATHER)])
    for sh in shapes:
        for r in run_shape(sh, dev, cands, reps=3 if args.small else 7):
            print(f"{r['rate_mhz']:g} MHz {r['shape']} {r['B']} x "
                  f"{r['l_win']} {r['design']}: {r['ms']:.4f} ms (chained "
                  f"{r['chained_ms']:.4f}, cold {r['cold_ms']:.4f}), bound "
                  f"{r['bound_ms']:.4f}, share {r['share_of_bound']:.3f} "
                  f"({r['chained_share']:.3f} chained), fill "
                  f"{r['fill_ms']:.4f}, plain {r['plain_ms']:.3f}, indexing "
                  f"{r['library_ms']:.3f} " + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
