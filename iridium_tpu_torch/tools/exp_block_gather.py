"""Aligned block-gather sweep: gather B windows of ~W samples at
R*640-aligned starts from a long two-plane stream, for each per-block row
count R, with the `block_gather` kernel.

    python -m iridium_tpu_torch.tools.exp_block_gather [--device cpu]
        [--rows 64,128,256] [--small]
    python -m iridium_tpu_torch.tools.exp_block_gather --source PATH
        [--source PATH ...] [--rows 64]

The port's counterpart of tools/exp_pallas_gather.py, with its inputs:
B = 128 windows of W = ceil(302,080 / (R*640)) * R*640 samples from a
38,000,960-sample stream held as (Mt, 640) planes filled with 1.0 and 2.0,
block starts from `np.random.default_rng(0)`, and its sum check. On the
card each R is timed with CUDA events over a chain of launches; `--small`
is a shape that the CPU runs in about a second. Prints one line per R:
milliseconds per gather, the output's GB/s, and the GB/s of all the bytes
moved (each covered input row read once, the output written once).

`--source` (card only) builds each given kernel source (the same C entry
point as csrc/block_gather.cu, for example an earlier design kept under
build/) and prints, for the package's kernel and each source at the full
shapes, its single-call median and chained time beside
`torch.index_select` (one call per plane), after checking it bit-equal
to the plain gather.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import _kernels, device as device_mod
from ..ops.block_gather import block_gather, block_gather_plain
from . import variants

TILE = 640
FULL = dict(B=128, M=38_000_960, window=302_080)
SMALL = dict(B=8, M=2_560_000, window=6_400)


def shapes(R: int, B: int, M: int, window: int) -> dict:
    """The tool's shapes and block starts for row block R."""
    W = -(-window // (R * TILE)) * R * TILE
    rng = np.random.default_rng(0)
    starts = (rng.integers(0, M - W, B) // (TILE * R)).astype(np.int32)
    return dict(R=R, B=B, Mt=M // TILE, nt=W // TILE, starts=starts)


def covered_rows(starts: np.ndarray, R: int, nt: int, mt: int) -> int:
    """Distinct plane rows the windows cover: the input that a gather
    must read at least once."""
    edge = np.zeros(mt + 1, np.int64)
    lo = np.clip(starts.astype(np.int64) * R, 0, mt)
    np.add.at(edge, lo, 1)
    np.add.at(edge, np.clip(lo + nt, 0, mt), -1)
    return int((np.cumsum(edge)[:mt] > 0).sum())


def moved_bytes(sh: dict) -> int:
    rows_in = covered_rows(sh["starts"], sh["R"], sh["nt"], sh["Mt"])
    return 2 * 4 * TILE * (rows_in + sh["B"] * sh["nt"])


def time_gather(fn, dev: torch.device, reps: int) -> float:
    """Milliseconds per call, after one warm-up call: CUDA events around
    `reps` chained launches on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_one(R: int, dev: torch.device, B: int, M: int, window: int,
            reps: int = 25) -> dict:
    sh = shapes(R, B, M, window)
    sre = torch.full((sh["Mt"], TILE), 1.0, device=dev)
    sim = torch.full((sh["Mt"], TILE), 2.0, device=dev)
    st = torch.from_numpy(sh["starts"]).to(dev)
    nt = sh["nt"]
    o_re, o_im = block_gather(sre, sim, st, R, nt)
    val = float(o_re[:, 0, 0].sum() + o_im[:, -1, -1].sum())
    if abs(val - (B * 1.0 + B * 2.0)) >= 1e-3:
        raise AssertionError(f"R={R}: sum check {val} != {3.0 * B}")
    del o_re, o_im
    ms = time_gather(lambda: block_gather(sre, sim, st, R, nt), dev, reps)
    out_bytes = 2 * B * nt * TILE * 4
    return dict(R=R, B=B, nt=nt, Mt=sh["Mt"], device=dev.type, ms=ms,
                out_mb=out_bytes / 1e6, out_gbps=out_bytes / ms / 1e6,
                moved_gbps=moved_bytes(sh) / ms / 1e6, sum=val)


def sweep(rows, dev: torch.device, small: bool = False,
          reps: int = 25) -> list[dict]:
    cfg = SMALL if small else FULL
    return [run_one(R, dev, reps=reps, **cfg) for R in rows]


def single_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of single calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def compare_sources(rows, dev: torch.device, sources) -> list[dict]:
    """The package's kernel and each other source at the full shapes on
    random planes: bit-equal to the plain gather, then timed."""
    cands = variants.candidates(_kernels.BLOCK_GATHER, sources)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mt = FULL["M"] // TILE
    sre = torch.randn((mt, TILE), device=dev, generator=gen)
    sim = torch.randn((mt, TILE), device=dev, generator=gen)
    out = []
    for R in rows:
        sh = shapes(R, **FULL)
        st = torch.from_numpy(sh["starts"]).to(dev)
        nt = sh["nt"]
        want = block_gather_plain(sre, sim, st, R, nt)
        idx = (st.long()[:, None] * R
               + torch.arange(nt, device=dev)).reshape(-1)
        lib = single_ms(lambda: (torch.index_select(sre, 0, idx),
                                 torch.index_select(sim, 0, idx)))
        n_bytes = moved_bytes(sh)
        for name, k in cands:
            with variants.swapped("BLOCK_GATHER", k):
                got = block_gather(sre, sim, st, R, nt)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} R={R}: not bit-equal")
                del got
                fn = lambda: block_gather(sre, sim, st, R, nt)  # noqa: E731
                ms = single_ms(fn)
                chained = time_gather(fn, dev, 25)
            out.append(dict(design=name, R=R, ms=ms, chained_ms=chained,
                            index_select_ms=lib,
                            bound_ms=n_bytes / 3.35e12 * 1e3))
        out.append(dict(design="index_select again", R=R,
                        ms=single_ms(lambda: (
                            torch.index_select(sre, 0, idx),
                            torch.index_select(sim, 0, idx)))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_block_gather",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--rows", default="64,128,256",
                    help="comma-separated rows per block R")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--source", action="append", default=[],
                    help="time the package's kernel beside this kernel "
                    "source, repeatable (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    rows = [int(r) for r in args.rows.split(",")]
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    if args.source:
        for r in compare_sources(rows, dev, args.source):
            print("design " + json.dumps(r), flush=True)
        return 0
    for r in sweep(rows, dev, args.small, reps=3 if args.small else 25):
        print(f"R={r['R']:3d}: {r['ms']:8.3f} ms for {r['out_mb']:.0f} MB "
              f"out ({r['out_gbps']:.1f} GB/s out, {r['moved_gbps']:.1f} "
              f"GB/s moved) " + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
