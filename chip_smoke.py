#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`iridium_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card's name and power limit, then the kernel build and its time;
  2. each hand-written kernel at the production shapes, launched on the
     card and held against its plain PyTorch version on the same inputs,
     with its time, the plain version's, a library call's where one
     computes the same function, and the bound (the scan on three
     blocks: synthetic, noise-only after priming, dense; the fused
     front-end at the three burst classes' batches of the 10 MHz group
     program, within max |err| 1e-5; the window gather at the 1 MHz
     small-normal batch, the 25 MHz small-normal and large batches and
     the 400 MHz decode's three, with fine shifts up to the decimation;
     the block gather single-call and chained, at R = 64, 128, 256; the
     demod loop at the three 10 MHz class batches and the 400 MHz and
     1.6 GHz decodes' three in both modes, through `tools/exp_demod.py`,
     bit-equal or not with the first symbol that parts, ns a symbol step
     beside the chain bound (`tools/sass_chain.py`), beside the plain
     loop eager and captured as a CUDA graph; the downmix FIR kernel's
     two launches (noise LPF + box filter; frame gather, fine rotation
     and RRC) at the three class batches of the 10 MHz, 400 MHz and 1.6
     GHz decodes, through `tools/exp_downmix.py`, bit-equal to their
     plain versions, beside them, three conv1d calls and the FIRs alone
     (the rotation taken out; with DOWNMIX_OLD_SOURCE naming the design
     before the fold, `git show
     8e9722b:iridium_tpu_torch/csrc/downmix_fir.cu`, that design too);
     the downmix chain's four launches (burst start, CFO peak, sync
     products, sync peaks and extraction; a row to a cluster of
     `downmix.plan`'s blocks) at the same nine batches, each with the
     layout it ran, through `tools/exp_downmix_chain.py`, each bit-equal
     to its twin on the twins' chain (and the FIR kernel's stage 1 with
     the sync search's input to its twin), beside the twins' graph and
     the bound; the demod tail (`pipeline.decide_pack`, one launch: the
     demodulator's decisions after its loop and the packing of the output
     rows) at the demod loop's eighteen batches, each with `tail_plan`'s
     layout, through `tools/exp_demod_tail.py`, bit-equal to its twin
     (`Demod.decide_plain` and `pack_plain` composed) on the loop
     kernel's output (edge rows among the bursts; with and without LLRs),
     beside the twins eager and as a graph and the bound, with `ptxas
     -v`'s registers and spills;
     the detect_fast kernel, one launch a
     block, on the production block (2,048 x 8,192, squelch and emission
     drops reached), bit-equal to `scan_fast_plain` on the card on every
     field of the state, through `tools/exp_fast.py`, beside the twin's
     time, with the device operations a block);
  3. the offline RAW decode at the production 10 MHz configuration: a
     synthetic capture file through `Pipeline.run_file` (the native
     reader; no LLRs) and
     `RawPrinter`, every injected payload bit-exact, scan and fused
     front-end launched, the group program replayed as a CUDA graph (after
     a warm-up decode that captures it), every class graph under 60
     nodes and the large and small-normal ones apart by less than their
     symbol counts (the demod loop and tail are kernel nodes); then the
     same
     decode under
     torch.profiler (device time, idle share); then `group_oracle`: the
     same capture through the host-routed flow gives the same lines, and
     the group program through its graphs is bit-equal to the same
     program run eagerly;
  3b. `decode_fast_10mhz`: the same capture through
     `Pipeline(detect_impl="fast")` on the card (the detect_fast kernel
     once a block, the scan kernel never), warm, every payload bit-exact,
     and through the same Pipeline on the CPU (the plain twin): the same
     RAW lines but for the frequency (±1 Hz) and the level's last digit;
  4. a short 1 MHz decode (decimation 4, so the window-gather path),
     whose gathers, downmix FIR and chain launches, demod loops and demod
     tail launches captured into its graphs are held to
     their plain versions after every replay (`ReplayCheck`), its burst
     detected and its wall taken on the captured graphs; then the
     demodulator alone at a 256-burst batch (`demod_loop`: the kernel and
     the plain tail, and the kernel alone);
  4b. `mesh`: the sharded pipeline (`parallel/stream.py`) in this
     process at world size 1 over NCCL: the RAW 10 MHz capture in
     replicated mode (lines with ids equal to phase 3's, every payload
     bit-exact, the scan and the fused front-end launched), the 1 MHz
     capture in binshard mode (detect_fast's kernel split around its
     per-frame all_reduce, a block's frames replayed as one CUDA graph,
     launched; lines, ids masked, equal to the single card's detect_fast
     decode; the window gather launched), the RAW 10 MHz capture in
     binshard mode (the split's cluster of 2 blocks: every payload
     bit-exact, lines, ids masked, equal to phase 3b's),
     the CLI with and without `--mesh 1`
     (one spawned rank), each its own process, on the 1 MHz capture: the
     same lines, and the RAW capture through the CLI from its file and,
     with `--mesh 1`, from stdin (rank 0 reads it and broadcasts each
     block): the same lines. The
     front-end, gather, downmix FIR and chain, demod-loop and demod-tail
     calls in the sharded graphs (the
     sharded capacities' batches, 256 and 48 bursts) are held to their
     plain versions after every replay of the warm-up runs
     (`ReplayCheck`); the class graphs' nodes as in phase 3.
     Walls and realtime factors beside the single card's, the
     collectives' ms;
  5. the protocol decode at the production 10 MHz configuration: a
     capture with injected IRA, IBC and IDA frames (one ACARS SBD message
     over two IDA bursts) through the pipeline with LLRs and the CLI's
     decoders; every IDA payload, the ACARS text and the IRA ids come
     back, and the unpacked LLRs are within one quantum of the f32 LLRs;
  6. the block-gather sweep tool (`iridium_tpu_torch.tools.
     exp_block_gather`) on the card, its sum check passing;
  7. `dense_10mhz`: 8 production blocks at a live band's density (~250
     bursts/s, 22-32 dB, over the whole band, simplex included) through
     the group flow, lines equal to the host-routed flow's, then the first
     block again with class batches of 16/24/24 bursts, so that
     overflow rounds run, against the host-routed flow at those batches;
     the group program through its graphs on that dense group and on
     an empty one, and each graph's replay alone; class graph nodes as in
     phase 3;
  8. `ingest`: the dense capture file through the native reader
     (`Pipeline.run_file`) and through `readers.read_blocks`: each reader
     alone in blocks/s, each decode's wall, realtime and `read` seconds
     and the share of the wall no stage counts; equal lines;
  9. `wideband_25mhz`: a 25 MHz capture (F = 32768) through
     `Pipeline.run_file`: the scan resolves to the scan kernel, which runs
     as a cluster of 4 blocks and launches, decimation 100 takes the window
     gather, every injected payload comes back bit-exact, realtime as
     measured;
  9b. `wideband_400mhz`: a 400 MHz capture (F = 524288, 2.8 s, 12 bursts
     from -150 to +170 MHz) written as ci8 chunk by chunk, through
     `Pipeline.run_file` at one block a group, one job a class and 16
     bursts a batch (the default batches run out of device memory at 400
     MHz), after a warm-up decode: the scan resolves to
     the kernel's grid of 4 clusters of 16 blocks, which launches,
     decimation 1,600 takes the window gather, every payload comes back
     bit-exact; wall, realtime, stages, peak device memory; then, in a
     process of its own, whether the decode fits at the Pipeline's
     default batches (a measurement: its peak and its payloads, or the
     allocation that failed; any other failure fails the run);
  9c. `wideband_1600mhz`: a 1.6 GHz capture (F = 2,097,152, 256 frames a
     block, six blocks, 2.01 s, 12 bursts from -700 to +700 MHz, one
     across sample 2^31) written as ci8 chunk by chunk, through
     `Pipeline.run_file` at the 400 MHz decode's batches, after a warm-up
     decode: the scan resolves to the kernel's tiled grid (7 clusters of
     16 blocks of 2 tiles), which launches, decimation 6,400 takes the
     window gather (the large class two windows at a time), every payload
     comes back bit-exact; wall, realtime, stages, peak device memory,
     class shapes; then the scan kernel on one of the warm-up decode's
     own blocks (256 x 2,097,152, its primed state) and the window gather
     at the large class's window length (4 windows of 180 M samples),
     held to their plain versions (in the `kernels` line); the decode's
     demod loop and tail and downmix FIR and chain batches must be those
     phase 2 held;
  10. the `kernels` JSON line: every kernel with its launches on the
     decode paths above (counts reset before each path and read after
     it; a graph replay adds the launches its capture recorded; per path
     in `detail.launches_by_path`; the downmix FIRs, the downmix chain,
     the demod loop and the demod tail must launch on every decode path),
     its times and
     its bound;
     `detail.path_checks` has the
     calls `ReplayCheck` held in phases 4 and 4b, and `max_abs_err`
     covers them.
Before the decodes, `scan_shapes` holds the scan kernel to the plain scan
at the shapes the Pallas scan's chunk rules refuse (frames_per_block 100
and 1000, history_size 16), at sizes its layout pads or splits unevenly
(1,152, 12,288, 16,384, 20,480 and 393,216 bins) and at the 25, 50, 100,
200, 400 and 800 MHz blocks (1,024 x 32,768 to 1,024 x 1,048,576, the
kernel as a cluster of 4, 8 and 16 blocks and, from 400 MHz, as a grid of
4 clusters of 16) and above the largest resident grid, tiled (1,835,136,
2,097,152 and 4,194,304 bins: 7 clusters of 16 blocks of 2, 2 and 3
tiles, from a state the plain scan primed, on the cluster edge block with
bursts across every tile and block edge), each timed with its layout (in
the `kernels` line's `detail.per_shape`), with `ptxas -v`'s registers and
spill bytes per instantiation (`detail.ptxas`), and `detect_fast_card`
holds the detect_fast kernel to `scan_fast_plain` on the card, bit for
bit, at the edge block (256 x 8,192, n_valid ending mid-block), 1,024 x
32,768, x 65,536 and x 262,144 (one cluster of 4, 8 and 16 blocks),
1,024 x 524,288 (a grid of 4 clusters of 16), 1,024 x 2,097,152 with
n_valid = 2^31 (the 1.6 GHz block the scan kernel refuses; 64 clusters
of 2) and a local bin range (ownership, id_stride 4, identity
coupling), each timed beside the twin with the bound, the device
operations a block and `ptxas -v`'s registers and spills (the
`detect_fast` row's `detail.per_shape`; with DETECT_FAST_OLD_SOURCE
naming the design before clusters, `git show
9568349:iridium_tpu_torch/csrc/detect_fast.cu`, that design's µs a frame
beside each), binshard's split (two launches a frame around the
coupling, a block's frames replayed as one CUDA graph) at 10 MHz world
size 1 (a cluster of 2), the local range and 1 MHz world size 1 (one
block of 2 bins a thread), bit-equal to the twin, to its eager steps and
to the one launch, and over 4 ranges of a 1 MHz block in lockstep
(eagerly and as one graph) against 4 threaded twins coupled by a
barrier sum, whose summed count squelches, then the kernel against the
twin on the CPU on the
production block and the exact scan (one small block) on the card
against the CPU; their launches are comparisons and are not counted.
Every printed number names the card (`card`: nvidia-smi's name and
power limit). The last line is the JSON result. Any failed check exits
non-zero; with no CUDA device, or without the port's package beside this
script, it fails before printing a result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEED = 1234


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of `reps` calls after one warm-up call."""
    import torch
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
    return statistics.median(times)


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of `reps` calls that end in a synchronise,
    after one warm-up call: for work with a host wait inside it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def once_ms(fn) -> float:
    """Host-clock time of one call that ends in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound(n_bytes: float, n_flop: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flop / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---- phase 2: kernels against their plain versions ----

def check_scan(p, dev, card: str) -> dict:
    """The scan kernel on the three inputs of `tools/exp_scan.py` at the
    production shape (2048 x 8192): the synthetic block (bursts, a long
    burst, a squelch blast), a noise-only block after priming, and a dense
    block (~0.21 creations per frame). Each is held against the plain scan
    and timed; the row reports the synthetic block, `detail` all three."""
    import torch
    from iridium_tpu_torch.dsp import detect_scan, state as st
    from iridium_tpu_torch.tools import exp_scan

    n_valid = p.block_samples
    per_input, err, plain_ms = [], 0.0, None
    for name, mag2, s0 in exp_scan.inputs(p, dev):
        got = detect_scan.scan(mag2, s0, n_valid, p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = detect_scan.scan_plain(mag2, s0, n_valid, p)
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, exp_scan.compare(got, want))
        g = dict(zip(st.INT_FIELDS, got.ints.tolist()))
        if name == "synthetic" and (g["g_count"] < 20
                                    or g["burst_dropped"] < 1):
            raise AssertionError(f"scan: synthetic input did not reach the "
                                 f"squelch and drop paths: {g}")
        ms = time_ms(lambda: detect_scan.scan(mag2, s0, n_valid, p))
        per_input.append(dict(input=name, ms=ms,
                              us_per_frame=ms * 1e3 / p.frames_per_block,
                              gone=g["g_count"], tagged=g["n_tagged"],
                              dropped=g["burst_dropped"]))
    b_ms, b_by = scan_bound(p)
    shape = dict(shape=[p.frames_per_block, p.fft_size], clusters=1,
                 ms=per_input[0]["ms"],
                 us_per_frame=per_input[0]["us_per_frame"],
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=err)
    return dict(name="detect_scan", route="cuda",
                source="iridium_tpu_torch/csrc/detect_scan.cu",
                replaces="iridium_tpu/dsp/detect_pallas.py:152",
                max_abs_err=err, ms=per_input[0]["ms"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                detail=dict(card=card, per_input=per_input,
                            per_shape=[shape]))


def scan_bound(p) -> tuple[float, str]:
    """The scan's bytes bound: the block's |X|^2 rows read once, the
    state (history and the 9 per-bin planes) read and written once."""
    F, H = p.fft_size, p.history_size
    state_bytes = 4 * (H * F + 9 * F)
    return bound(4 * F * p.frames_per_block + 2 * state_bytes, 0)


# the fused front-end's agreement with fused_plain: its 3xTF32 products
# are f32-grade (~1.3e-6 on the card); one TF32 pass is ~1e-4 off
FUSED_MAX_ERR = 1e-5


def check_fused(dev, card: str) -> dict:
    """The fused front-end at the three burst classes' shapes of the
    10 MHz decode's group program (`tools/exp_frontend.py`: 1,024 x
    327,680; 96 x 327,680; 48 x 1,126,400, from a 4-block group's
    planes), each held to `fused_plain` within max |err| 1e-5 and
    timed beside the plain version and the library call (rotate + strided
    `conv1d`). The row reports the small-normal shape, `detail` all three
    with the bound's parts (bytes, f32-grade tensor products, FP32 FMAs)."""
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_frontend as tool

    taps = tool.production_taps()
    per_shape = []
    for shape, B, l_win in tool.CLASSES:
        r = tool.run_class(shape, B, l_win, dev,
                           [("package", _kernels.FUSED_FRONTEND)], taps,
                           tool.GROUP_10MHZ, phases=False)[0]
        if not r["max_abs_err"] <= FUSED_MAX_ERR:
            raise AssertionError(f"fused_frontend {shape}: max |err| "
                                 f"{r['max_abs_err']} > {FUSED_MAX_ERR}")
        per_shape.append({k: r[k] for k in (
            "shape", "B", "l_win", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bytes_ms", "tensor_ms",
            "fp32_fma_ms", "share_of_bound")})
    row = per_shape[0]
    return dict(name="fused_frontend", route="cuda",
                source="iridium_tpu_torch/csrc/fused_frontend.cu",
                replaces="iridium_tpu/ops/fused_frontend.py:130",
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                detail=dict(card=card, max_err_limit=FUSED_MAX_ERR,
                            per_shape=per_shape))


def check_gather(dev, card: str) -> dict:
    """The window gather at the class batches of the group programs that
    gather (decimations with no fused front-end): the 1 MHz small-normal
    batch (the row), the 25 MHz small-normal and large batches, and the
    400 MHz decode's three (at WIDE_400_RUN: decimation 1,600, windows of
    7.6 M and 45 M samples), each from random planes of a group's length
    with random starts [tile, r < decimation]
    (`tools/exp_window_gather.py`). Each is bit-equal to the plain gather
    and timed beside it and advanced indexing; `detail.per_shape` has all
    six."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_window_gather as tool

    shapes = [s for s in tool.class_shapes((1.0, 25.0))
              if (s["rate_mhz"], s["shape"]) in (
                  (1.0, "small_normal"), (25.0, "small_normal"),
                  (25.0, "large"))]
    shapes += tool.class_shapes((400.0,), **WIDE_400_RUN)
    per_shape = []
    for sh in shapes:
        torch.cuda.empty_cache()    # the plain gather's ~35 GB at 400 MHz
        per_shape += tool.run_shape(sh, dev,
                                    [("package", _kernels.WINDOW_GATHER)])
    torch.cuda.empty_cache()
    row = per_shape[0]
    return dict(name="window_gather", route="cuda",
                source="iridium_tpu_torch/csrc/window_gather.cu",
                replaces="iridium_tpu/ops/window_gather.py:55",
                max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                detail=dict(card=card, per_shape=per_shape))


def check_block_gather(dev, card: str) -> dict:
    """The block gather at the sweep tool's shapes (B = 128 windows of
    512 rows from two (59,376, 640) planes) on random planes, for each
    row block R: single-call and chained (25 launches between two events)
    times. The row reports the fastest R, `detail` all of them."""
    import torch
    from iridium_tpu_torch.ops import block_gather as bg
    from iridium_tpu_torch.tools import exp_block_gather as tool

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    mt = tool.FULL["M"] // tool.TILE
    sre = torch.randn((mt, tool.TILE), device=dev, generator=gen)
    sim = torch.randn((mt, tool.TILE), device=dev, generator=gen)
    detail = []
    for R in (64, 128, 256):
        sh = tool.shapes(R, **tool.FULL)
        st = torch.from_numpy(sh["starts"]).to(dev)
        nt = sh["nt"]
        got = bg.block_gather(sre, sim, st, R, nt)
        want = bg.block_gather_plain(sre, sim, st, R, nt)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"block_gather R={R}: not bit-equal to "
                                 "plain")
        del got, want
        # single calls are ~0.2 ms with tens of us of host launch time in
        # them, so their median takes more samples than the others
        ms = time_ms(lambda: bg.block_gather(sre, sim, st, R, nt), reps=21)
        chained_ms = tool.time_gather(
            lambda: bg.block_gather(sre, sim, st, R, nt), dev, 25)
        plain_ms = time_ms(lambda: bg.block_gather_plain(sre, sim, st, R,
                                                         nt), reps=3)
        rows = (st.long()[:, None] * R
                + torch.arange(nt, device=dev)).reshape(-1)
        lib_ms = time_ms(lambda: (torch.index_select(sre, 0, rows),
                                  torch.index_select(sim, 0, rows)), reps=21)
        n_bytes = tool.moved_bytes(sh)
        b_ms, b_by = bound(n_bytes, 0)
        detail.append(dict(R=R, nt=nt, ms=ms, chained_ms=chained_ms,
                           plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                           gbps=n_bytes / ms / 1e6))
    best = min(detail, key=lambda d: d["ms"])
    return dict(name="block_gather", route="cuda",
                source="iridium_tpu_torch/csrc/block_gather.cu",
                replaces="tools/exp_pallas_gather.py:55",
                max_abs_err=0.0, ms=best["ms"], plain_ms=best["plain_ms"],
                bound_ms=best["bound_ms"], bound_by=best["bound_by"],
                library_ms=best["library_ms"],
                detail=dict(card=card, best_R=best["R"], per_R=detail))


def check_demod(dev, card: str) -> dict:
    """The demod loop kernel at the three class batches of the 10 MHz group
    program (1,024 x 1,918 x 205; 96 and 48 x 4,440 x 471), of the 400
    MHz decode's (at WIDE_400_RUN) and of the 1.6 GHz decode's (256 frames
    a block, WIDE_1600_RUN), both modes, on
    `tools/exp_demod.py`'s bursts (random lengths, 0, 1, 3, 4 and L among
    them; residual CFO; noise): held to `loop_plain` and, through
    `Demod.decide_plain`, the demodulator's fields to those on
    `loop_plain`'s output (`exp_demod.compare_loop`, `compare_demod`),
    each row with
    `bit_equal` and the first symbol where a burst parts (`first_diff`,
    -1 when none does); timed single-call and chained (`ns_per_step`)
    beside the chain bound of a symbol step (`chain_ns`, `chain_bound_ms`:
    `tools/sass_chain.py`), the plain loop eager and, in Gardner mode, the
    plain loop captured as a CUDA graph (nodes, capture s, replay ms; 10
    MHz only). The row reports the 10 MHz small-normal batch in Gardner
    mode, `detail` all eighteen, with the build's `ptxas -v` registers,
    stack frame and spills per kernel function (`detail.ptxas`)."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_demod as tool
    from iridium_tpu_torch.tools import sass_chain

    lat = sass_chain.latencies(dev)
    per_shape = []
    for sh in tool.class_shapes():
        per_shape += tool.run_shape(sh, dev, lat=lat)
        torch.cuda.empty_cache()
    for sh in (tool.class_shapes(400.0, **WIDE_400_RUN)
               + tool.class_shapes(1600.0, 256, **WIDE_1600_RUN)):
        per_shape += tool.run_shape(sh, dev, graphs=False, lat=lat)
    row = per_shape[0]
    return dict(name="demod_loop", route="cuda",
                source="iridium_tpu_torch/csrc/demod_loop.cu",
                replaces="iridium_tpu/dsp/demod.py:142",
                max_abs_err=max(r["out_max_abs_err"] for r in per_shape),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None,
                detail=dict(card=card, per_shape=per_shape,
                            bit_equal=all(r["bit_equal"] for r in per_shape),
                            latencies=lat,
                            ptxas=tool.ptxas_summary(_kernels.DEMOD_LOOP),
                            products=tool.product_forms(dev)))


def check_downmix(dev, card: str) -> dict:
    """The downmix FIR kernel's two launches (`downmix.noise_box`,
    `downmix.frame_rrc`) at the three class batches (batch x dec_cap) of
    the 10 MHz group program (1,024 and 96 x 8,172; 48 x 28,140), of the
    400 MHz decode's and of the 1.6 GHz decode's (256 frames a block), at
    WIDE_RUN, on `tools/exp_downmix.py`'s rows (lengths 0, 1, 19, 20, 24,
    25, 26 and L among them, shift_dec > 0 and past dec_len, starts past
    the row, u at -+cfo_total / 2, corr 0): bit-equal to `noise_box_plain`
    and `frame_rrc_plain` (the tool raises where they part), each row
    timed single-call (each launch and both), chained and as a CUDA
    graph, beside the plain versions, three conv1d calls (TF32 off) and
    the bound (bytes and FP32 operations, none fused, at the card's top SM
    clock). Beside them in each row's `designs`, the FIRs alone (stage 1
    from start 0, unturned, bit-equal to `rrc_plain`): the package's
    source with its rotation taken out (`fir_alone`) and, where
    DOWNMIX_OLD_SOURCE names it, the design before the fold, each with
    the bound of that work. The row reports the 10 MHz small-normal
    batch, `detail` all nine, with the builds' `ptxas -v` registers and
    spills per kernel function."""
    from iridium_tpu_torch.tools import exp_demod
    from iridium_tpu_torch.tools import exp_downmix as tool

    clock = tool.sm_clock_hz(dev)
    old = os.environ.get("DOWNMIX_OLD_SOURCE")
    cands = tool.candidates([old] if old else [])
    per_shape = [tool.run_shape(sh, dev, clock_hz=clock, cands=cands)
                 for rate in (10.0, 400.0, 1600.0)
                 for sh in tool.class_shapes(rate)]
    row = per_shape[0]
    return dict(name="downmix_fir", route="cuda",
                source="iridium_tpu_torch/csrc/downmix_fir.cu",
                replaces="iridium_tpu/dsp/downmix.py:132",
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                detail=dict(card=card, per_shape=per_shape,
                            bit_equal=all(r["bit_equal"] for r in per_shape),
                            library=row["library"],
                            ptxas={name: exp_demod.ptxas_summary(k)
                                   for name, k, _ in cands}))


def check_downmix_chain(dev, card: str) -> dict:
    """The downmix chain's four launches (`downmix.burst_start`,
    `cfo_peak`, `sync_products`, `sync_extract`) at the nine class batches
    of `check_downmix`, through `tools/exp_downmix_chain.py`: on the chain
    its twins run on that tool's rows (edges among them: dec_len 0, 1, 19,
    20, 21 and L, leads past dec_len and past the row, a window too short,
    a row of zeros), each launch bit-equal to its twin on the same inputs
    (the tool raises where one parts, with `first_diff`), and the FIR
    kernel's stage 1 with the sync search's input (`frame_rrc_sync`) to
    its twin; each launch timed single-call and as a graph of its own, the
    four as one CUDA graph (the row's `ms`), beside the twins' tensor code
    eagerly and as one graph and the bound (bytes, FP32 operations). The
    row reports the 10 MHz small-normal batch, `detail` all nine, each
    with the layout it ran (`downmix.plan`: a cluster of 1-8 blocks a
    row), with the build's `ptxas -v` registers and spills per kernel
    function."""
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_demod
    from iridium_tpu_torch.tools import exp_downmix
    from iridium_tpu_torch.tools import exp_downmix_chain as tool

    clock = exp_downmix.sm_clock_hz(dev)
    per_shape = [tool.run_shape(sh, dev, clock_hz=clock)
                 for rate in (10.0, 400.0, 1600.0)
                 for sh in tool.class_shapes(rate)]
    row = per_shape[0]
    return dict(name="downmix_chain", route="cuda",
                source="iridium_tpu_torch/csrc/downmix_chain.cu",
                replaces="iridium_tpu/dsp/downmix.py:410",
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None,
                detail=dict(card=card, per_shape=per_shape,
                            bit_equal=all(r["bit_equal"] for r in per_shape),
                            first_diff=next((r["first_diff"] for r in
                                             per_shape if r["first_diff"]),
                                            None),
                            library="none: no PyTorch call computes these "
                                    "steps",
                            ptxas=exp_demod.ptxas_summary(
                                _kernels.DOWNMIX_CHAIN)))


def check_demod_tail(dev, card: str) -> dict:
    """The demod tail's launch (`pipeline.decide_pack`) at the eighteen
    batches of `check_demod` (the 10 MHz, 400 MHz and 1.6 GHz decodes'
    three, both modes), through `tools/exp_demod_tail.py`: on the loop
    kernel's output of that tool's bursts (edge rows among them: a 20x
    magnitude drop, 8 symbols, noise, a UL and a DL burst, length 0, +-0
    components), bit-equal to its twin (`Demod.decide_plain` and
    `pack_plain` composed) on the same inputs with and without LLRs (the
    tool raises where they part, with `first_diff`); timed as a CUDA
    graph with LLRs (the row's `ms`) and without, and inside a graph
    (ten calls in one), beside the twins eagerly and as one graph and the
    bound (bytes, FP32 operations). The row reports the 10 MHz small-normal batch in Gardner
    mode, `detail` all eighteen, each with the layout it ran
    (`pipeline.tail_plan`), with the build's `ptxas -v` registers and
    spills per kernel function."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_demod
    from iridium_tpu_torch.tools import exp_demod_tail as tool

    per_shape = []
    for sh in (exp_demod.class_shapes()
               + exp_demod.class_shapes(400.0, **WIDE_400_RUN)
               + exp_demod.class_shapes(1600.0, 256, **WIDE_1600_RUN)):
        per_shape += tool.run_shape(sh, dev)
        torch.cuda.empty_cache()
    row = per_shape[0]
    return dict(name="demod_tail", route="cuda",
                source="iridium_tpu_torch/csrc/demod_tail.cu",
                replaces="iridium_tpu/dsp/demod.py:258",
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None,
                detail=dict(card=card, per_shape=per_shape,
                            bit_equal=all(r["bit_equal"] for r in per_shape),
                            first_diff=next((r["first_diff"] for r in
                                             per_shape if r["first_diff"]),
                                            None),
                            library="none: no PyTorch call computes these "
                                    "steps",
                            ptxas=exp_demod.ptxas_summary(
                                _kernels.DEMOD_TAIL)))


def check_fast(dev, card: str) -> dict:
    """The detect_fast kernel (one launch a block) on the production block
    (2,048 x 8,192, exp_scan's synthetic block from a fresh state: bursts, a
    long burst, a squelch blast with emission drops), held to
    `scan_fast_plain` on the card bit for bit on every field of the state
    and timed beside it (`tools/exp_fast.py` `run_case`: single-call and
    chained ms, the twin's ms, the bound, the device operations a block);
    the block must reach the squelch and drop paths. `detect_fast_card`
    adds the other shapes to `detail.per_shape`. `detail.scalar_division`:
    the share of PyTorch's divisions by a Python scalar on the card that
    are the product with the f32 reciprocal, which the kernel's noise dB
    copies."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_fast

    r = exp_fast.run_case(exp_fast.case("10mhz", dev), dev,
                          cands=old_fast_design())
    if r["gone"] < 20 or r["dropped"] < 1:
        raise AssertionError(f"detect_fast: the synthetic block did not "
                             f"reach the squelch and drop paths: {r}")
    torch.cuda.empty_cache()
    return dict(name="detect_fast", route="cuda",
                source="iridium_tpu_torch/csrc/detect_fast.cu",
                replaces="iridium_tpu/dsp/detect_fast.py:604",
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None,
                detail=dict(card=card, per_shape=[old_design(r)],
                            bit_equal=r["bit_equal"],
                            ptxas=exp_fast.ptxas_table(_kernels.DETECT_FAST),
                            scalar_division=exp_fast.scalar_division(dev)))


def old_fast_design():
    """The design of detect_fast before clusters, to time beside the
    kernel in the same run, where DETECT_FAST_OLD_SOURCE names its source
    (`git show 9568349:iridium_tpu_torch/csrc/detect_fast.cu`): the
    candidates `tools/exp_fast.py` runs (None without it)."""
    path = os.environ.get("DETECT_FAST_OLD_SOURCE")
    if not path:
        return None
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_fast, variants
    return variants.candidates(_kernels.DETECT_FAST, [path], exp_fast.adapted)


def old_design(r: dict) -> dict:
    """A detect_fast shape's row with the old design's µs a frame, ptxas
    and bit-equality beside the kernel's (None: not measured)."""
    old = next(iter(r.get("sources", {}).values()), {})
    return dict(r, old_us_per_frame=old.get("us_per_frame"),
                old_eager_us_per_frame=old.get("eager_us_per_frame"),
                old_bit_equal=old.get("bit_equal"),
                old_ptxas=old.get("ptxas"))


def kernel_phase(dev, card: str) -> list[dict]:
    from iridium_tpu_torch.config import DetectorConfig

    p = DetectorConfig(sample_rate=10_000_000, frames_per_block=2048,
                       gone_capacity=2048).derived()
    rows = [check_scan(p, dev, card),
            check_fused(dev, card),
            check_gather(dev, card),
            check_block_gather(dev, card),
            check_demod(dev, card),
            check_downmix(dev, card),
            check_downmix_chain(dev, card),
            check_demod_tail(dev, card),
            check_fast(dev, card)]
    for r in rows:
        print("kernel_check " + json.dumps(r), flush=True)
    return rows


# ---- phases 3 and 4: the offline decode through Pipeline.run_file ----

GRAPH_PARTS = ("route", "small_normal", "small_simplex", "large")


def graph_info(graphs: dict) -> dict:
    """CUDA graphs (GroupGraphs by group arity, or the sharded process
    step's), by part (the routing, then each burst class; those never run
    are not captured): capture and instantiate seconds, node count, memory
    pool, kernel launches per replay, and the replay's ms alone on its
    last inputs."""
    return {nb: {name: dict(capture_s=c.capture_s,
                            instantiate_s=c.instantiate_s, nodes=c.nodes,
                            pool_mib=c.pool_bytes / 2**20,
                            replay_ms=time_ms(c.graph.replay, reps=3),
                            launches_per_replay={k.name: n for k, n
                                                 in c.launches.items()})
                 for name, c in zip(GRAPH_PARTS, g.parts) if c.graph}
            for nb, g in graphs.items()}


# a class graph held ~130 nodes a symbol while the demod loop was a Python
# loop (26,877-60,929 at 10 MHz), ~200 with the demod tail's tensor code;
# with every chain a kernel or a cuFFT call it holds 26 (the fused path)
# to 40 (the gather path), and must not grow with the symbols
MAX_CLASS_NODES = 60


def check_class_nodes(info: dict, classes, where: str) -> None:
    """Every class graph of `info` (graph_info's) under MAX_CLASS_NODES
    nodes, and the small-normal and large graphs' counts apart by less
    than their classes' symbol counts are."""
    spread = classes[2].demod.S - classes[0].demod.S
    for key, parts in info.items():
        for name in GRAPH_PARTS[1:]:
            if name in parts and not parts[name]["nodes"] < MAX_CLASS_NODES:
                raise AssertionError(f"{where}: class graph {name} (arity "
                                     f"{key}) has {parts[name]['nodes']} "
                                     "nodes")
        if spread > 0 and "small_normal" in parts and "large" in parts:
            d = abs(parts["large"]["nodes"] - parts["small_normal"]["nodes"])
            if not d < spread:
                raise AssertionError(f"{where}: the large and small-normal "
                                     f"class graphs differ by {d} nodes, "
                                     f"their symbols by {spread}")


def graph_run(pipe, g):
    """The group program on the graph `g`'s current inputs, through its
    graphs (skips as loaded)."""
    return pipe.group_program(g.planes, g.tables, g.scal,
                              g.scal[1:].tolist(), g)


T0 = 1_700_000_000_000_000_000


def missing_payloads(frames, bursts, det) -> list:
    """The injected (start, offset) whose payload no frame carries
    bit-exact within 2 kHz of its frequency."""
    from iridium_tpu_torch.io import synth
    missing = []
    for start, off, bits in bursts:
        exp = synth.expected_bits(bits, "DL")
        if not any(len(f["bits"]) >= len(exp)
                   and np.array_equal(np.asarray(f["bits"][:len(exp)]), exp)
                   and abs(f["frequency"] - (det.center_frequency + off))
                   < 2e3 for f in frames):
            missing.append((start, off))
    return missing


def decode_phase(dev, tmp) -> tuple[dict, dict]:
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools.captures import (PROD, production_capture,
                                                  write_cf32)

    cap, bursts = production_capture(SEED)
    path = os.path.join(tmp, "capture_10mhz.cf32")
    write_cf32(path, cap)
    seconds = len(cap) / PROD["sample_rate"]
    det = DetectorConfig(**PROD)
    pipe = Pipeline(det_cfg=det, start_time_ns=T0, device=dev,
                    want_llr=False)
    # warm-up decode (cuFFT plans, allocator, the group graph's capture);
    # then the counted run on the same pipeline
    t = time.perf_counter()
    list(pipe.run_file(path))
    warmup_s = time.perf_counter() - t
    pipe.reset(T0)
    printer = RawPrinter()
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    lines = [printer.format(f) for f in frames]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    for name in ("detect_scan", "fused_frontend"):
        if counts[name] == 0:
            raise AssertionError(f"10 MHz decode never launched {name}")
    missing = missing_payloads(frames, bursts, det)
    if missing:
        raise AssertionError(f"payloads not decoded bit-exact: {missing}")
    if not pipe.graphs:
        raise AssertionError("the decode replayed no group graph")
    graphs = graph_info(pipe.graphs)
    check_class_nodes(graphs, pipe.classes, "RAW decode")
    st = pipe.stats
    return dict(phase="decode_10mhz", capture_s=seconds, wall_s=wall,
                realtime_x=seconds / wall, raw_lines=len(lines),
                raw_per_s=len(lines) / wall, injected=len(bursts),
                detected=st.n_detected, ok=st.n_ok,
                ok_pct=100.0 * st.n_ok / max(st.n_detected, 1),
                q_peak=pipe.take_q_peak(), warmup_s=warmup_s,
                stages=dict(pipe.timing), graphs=graphs,
                launches=counts), dict(pipe=pipe, path=path, lines=lines,
                                       bursts=bursts)


def profile_phase(pipe, path: str, wall_s: float) -> dict:
    """The same 10 MHz decode on the same pipeline (its graph captured)
    under torch.profiler: device time summed over kernels and copies, the
    number of device operations, and the device's idle share against the
    unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe.reset(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        list(pipe.run_file(path))
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in cuda) / 1e3
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:6]
    return dict(phase="profile_10mhz", device_ms=device_ms,
                device_ops=sum(e.count for e in cuda),
                idle_share=1.0 - device_ms / 1e3 / wall_s,
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top])


def group_oracle_phase(pipe, path: str, lines: list) -> dict:
    """The RAW capture through the host-routed flow (gone tables to the
    host, routing in numpy, eager class batches) on the same pipeline:
    the same lines as the group flow's. Then the group program through
    its graphs on their last inputs, bit-equal to the program run
    eagerly on them."""
    import torch
    from iridium_tpu_torch.output.raw import RawPrinter

    pipe.reset(T0)
    pipe.host_routed = True
    try:
        printer = RawPrinter()
        host = [printer.format(f) for f in pipe.run_file(path)]
    finally:
        pipe.host_routed = False
    if host != lines:
        raise AssertionError(f"host-routed lines differ: {len(host)} "
                             f"against {len(lines)}")
    res = dict(phase="group_oracle", lines=len(lines), host_lines_equal=True)
    for nb, g in pipe.graphs.items():
        replayed = graph_run(pipe, g)
        eager = pipe.group_program(g.planes, g.tables, g.scal,
                                   g.scal[1:].tolist())
        torch.cuda.synchronize()
        if not torch.equal(replayed, eager):
            raise AssertionError(
                f"graph of arity {nb}: {int((replayed != eager).sum())} of "
                f"{eager.numel()} words differ from the eager program")
        res[f"arity_{nb}_words_bit_equal"] = eager.numel()
    return res


def raw_parity(got: list, want: list) -> dict:
    """Two decodes' RAW lines of one capture, field for field, but for the
    frequency within ±1 Hz and the level within its last digit (ROADMAP,
    "RAW parity at bench scale"): raises on any other difference; counts
    the lines whose frequency, or level, differ."""
    import re
    pat = re.compile(r"^(RAW: \S+ \S+) (\d+) (N:\S+ I:\d+ +\d+%) (\S+) "
                     r"(.*)$")
    if len(got) != len(want) or not want:
        raise AssertionError(f"{len(got)} lines against {len(want)}")
    n_freq = n_level = 0
    for g, w in zip(got, want):
        a, b = pat.match(g), pat.match(w)
        if not (a and b and a[1] == b[1] and a[3] == b[3] and a[5] == b[5]
                and abs(int(a[2]) - int(b[2])) <= 1
                and abs(float(a[4]) - float(b[4])) < 1.5e-5):
            raise AssertionError(f"RAW lines differ:\n{g}\n{w}")
        n_freq += a[2] != b[2]
        n_level += a[4] != b[4]
    return dict(lines=len(want), freq_1hz=n_freq, level_last_digit=n_level)


def decode_fast_phase(dev, single: dict) -> dict:
    """The RAW 10 MHz capture through `Pipeline(detect_impl="fast")` on the
    card (the detect_fast kernel, one launch a block), after a warm-up
    decode, and through the same Pipeline on the CPU (the plain twin): the
    same RAW lines but for the frequency (±1 Hz) and the level's last digit
    (`raw_parity`), every injected payload bit-exact, detect_fast launched
    once a block and the scan kernel never."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools.captures import PROD

    path = single["path"]
    det = DetectorConfig(**PROD)
    pipe = Pipeline(det_cfg=det, start_time_ns=T0, device=dev,
                    want_llr=False, detect_impl="fast")
    list(pipe.run_file(path))
    pipe.reset(T0)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    printer = RawPrinter()
    lines = [printer.format(f) for f in frames]
    n_blocks = -(-os.path.getsize(path) // (8 * det.derived().block_samples))
    if counts["detect_fast"] != n_blocks or counts["detect_scan"] != 0:
        raise AssertionError(f"detect_impl='fast' decode launches: {counts}")
    missing = missing_payloads(frames, single["bursts"], det)
    if missing:
        raise AssertionError(f"detect_impl='fast' decode: payloads not "
                             f"decoded bit-exact: {missing}")
    stages = dict(pipe.timing)
    # the mesh phase's binshard decode of the capture is held to these
    single["fast_lines"], single["fast_wall_s"] = lines, wall
    del pipe, frames
    cpu = Pipeline(det_cfg=det, start_time_ns=T0, device="cpu",
                   want_llr=False, detect_impl="fast")
    t = time.perf_counter()
    printer = RawPrinter()
    want = [printer.format(f) for f in cpu.run_file(path)]
    cpu_s = time.perf_counter() - t
    parity = raw_parity(lines, want)
    return dict(phase="decode_fast_10mhz", detect_impl="fast",
                capture_s=single["capture_s"], wall_s=wall,
                realtime_x=single["capture_s"] / wall, raw_lines=len(lines),
                payloads_bit_exact=len(single["bursts"]),
                cpu_wall_s=cpu_s, cpu_parity=parity, stages=stages,
                launches=counts)


# the downmix's wrappers that `ReplayCheck` holds to their twins, with the
# kernel each launches
DOWNMIX_WRAPPERS = {
    "noise_box": "downmix_fir", "frame_rrc_sync": "downmix_fir",
    "burst_start": "downmix_chain", "cfo_peak": "downmix_chain",
    "sync_products": "downmix_chain", "sync_extract": "downmix_chain"}


class ReplayCheck:
    """Holds every kernel call captured into a pipeline's CUDA graphs to
    its plain version after each replay of that graph: the fused
    front-end within FUSED_MAX_ERR of `fused_plain`, the window gather
    bit-equal to `gather_plain`, the demod loop to `loop_plain` within
    `tools/exp_demod.py`'s limits, and the demodulator's decisions on the
    kernel's loop output to the twin's decisions on `loop_plain`'s
    (`compare_demod`; counted under `demod_loop` as `decide_calls`), the
    demod tail's launch (`pipeline.decide_pack`) bit-equal to the two
    twins composed on the same inputs (under `demod_tail`, with the calls
    per launch in `by_launch`), the downmix FIR kernel's two
    launches (`downmix.noise_box`, `downmix.frame_rrc_sync`) bit-equal to
    their plain versions (counted under `downmix_fir`), and the downmix
    chain's four (`downmix.burst_start`, `cfo_peak`, `sync_products`,
    `sync_extract`) bit-equal to theirs (under `downmix_chain`, with the
    calls per launch in `by_launch`). A graph reads
    static buffers and rewrites its other tensors at each replay, so after
    a replay the recorded inputs and outputs are that replay's. Used as a
    context around a decode that captures its graphs; `summary` has, per
    kernel, the calls checked, their shapes ((B, l_win); the demod's (B, L,
    S)) and the largest |err|. The comparisons launch no kernel; a check
    entered again adds to its summary."""

    def __init__(self):
        self.summary: dict = {}

    def __enter__(self):
        import torch
        from iridium_tpu_torch.dsp import demod, downmix
        from iridium_tpu_torch.ops import fused_frontend as ff
        from iridium_tpu_torch.ops import window_gather as wg
        from iridium_tpu_torch.runtime import pipeline as pl

        self.calls: dict = {}       # Captured -> [(kernel, args, out)]
        self._plain: dict = {}      # loop output's id -> loop_plain's
        self._cur = None
        saved = self._saved = (ff.fused, wg.gather, demod.loop,
                               pl.decide_pack, pl.Captured._capture,
                               pl.Captured.replay)
        (fused, gather, loop, decide_pack, capture, replay) = saved
        self._downmix = {name: getattr(downmix, name)
                         for name in DOWNMIX_WRAPPERS}

        def record(name, fn):
            def wrapped(*args):
                out = fn(*args)
                if torch.cuda.is_current_stream_capturing():
                    self.calls.setdefault(self._cur, []).append(
                        (name, args, out))
                return out
            return wrapped

        def capturing(part, fn):
            self._cur = part
            try:
                capture(part, fn)
            finally:
                self._cur = None

        def replaying(part, fn):
            out = replay(part, fn)
            for name, args, got in self.calls.get(part, ()):
                self._check(name, args, got)
            return out

        ff.fused = record("fused_frontend", fused)
        wg.gather = record("window_gather", gather)
        demod.loop = record("demod_loop", loop)
        pl.decide_pack = record("decide_pack", decide_pack)
        for name, fn in self._downmix.items():
            setattr(downmix, name, record("downmix." + name, fn))
        pl.Captured._capture = capturing
        pl.Captured.replay = replaying
        return self

    def __exit__(self, *exc):
        from iridium_tpu_torch.dsp import demod, downmix
        from iridium_tpu_torch.ops import fused_frontend as ff
        from iridium_tpu_torch.ops import window_gather as wg
        from iridium_tpu_torch.runtime import pipeline as pl
        (ff.fused, wg.gather, demod.loop, pl.decide_pack,
         pl.Captured._capture, pl.Captured.replay) = self._saved
        for name, fn in self._downmix.items():
            setattr(downmix, name, fn)
        self.calls.clear()
        self._plain.clear()
        return False

    def _check(self, name: str, args, got) -> None:
        import torch
        from iridium_tpu_torch.dsp import demod, downmix
        from iridium_tpu_torch.ops import fused_frontend as ff
        from iridium_tpu_torch.ops import window_gather as wg
        from iridium_tpu_torch.runtime import pipeline as pl
        from iridium_tpu_torch.tools import exp_demod, exp_downmix_chain
        if name.startswith("downmix."):
            fn = name.split(".")[1]
            res = exp_downmix_chain.compare(
                got, getattr(downmix, fn + "_plain")(*args))
            shape = list(args[0].shape)
            if not res["bit_equal"]:
                raise AssertionError(f"{name} {shape} in a graph replay "
                                     f"against its plain version: {res}")
            s = self._tally(DOWNMIX_WRAPPERS[fn], shape, 0.0)
            s["bit_equal"] = True
            by = s.setdefault("by_launch", {})
            by[fn] = by.get(fn, 0) + 1
            return
        if name == "demod_loop":
            want = demod.loop_plain(*args)
            try:
                res = exp_demod.compare_loop(got, want)
            except AssertionError as e:
                raise AssertionError(f"demod_loop in a graph replay: {e}")
            # the decisions made on this output are checked next
            self._plain[id(got[0])] = want
            s = self._tally(name, list(args[0].shape) + [args[3]],
                            res["out_max_abs_err"])
            s["bit_equal"] = s.get("bit_equal", True) and res["out_bit_equal"]
            return
        if name == "decide_pack":
            dmd, pll_out, dm = args[0], args[1], args[4]
            # the kernel against the two twins composed on the same
            # inputs, bit for bit
            want = pl.decide_pack_plain(*args)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"decide_pack {list(got.shape)} in a graph replay: "
                    f"{int((got != want).sum())} words differ from the "
                    "twins'")
            self._tally_tail("decide_pack", list(pll_out.shape))
            # the decisions on the loop kernel's output against those on
            # loop_plain's
            try:
                res = exp_demod.compare_demod(
                    dmd.decide_plain(*args[1:4], dm.direction),
                    dmd.decide_plain(*self._plain.pop(id(pll_out)),
                                     dm.direction))
            except AssertionError as e:
                raise AssertionError(f"Demod in a graph replay: {e}")
            s = self.summary["demod_loop"]
            s["decide_calls"] = s.get("decide_calls", 0) + 1
            s["decide_max_abs_err"] = max(s.get("decide_max_abs_err", 0.0),
                                          *res.values())
            return
        if name == "fused_frontend":
            want = ff.fused_plain(*args)
            err = max(float((a - b).abs().max()) if a.numel() else 0.0
                      for a, b in zip(got, want))
            l_win, bad = args[5], not err <= FUSED_MAX_ERR
        else:
            want = wg.gather_plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            err = 0.0 if same else max(float((a - b).abs().max())
                                       for a, b in zip(got, want))
            l_win, bad = args[2], not same
        shape = [args[1].shape[0], l_win]
        if bad:
            raise AssertionError(f"{name} {shape} in a graph replay: max "
                                 f"|err| {err} against its plain version")
        self._tally(name, shape, err)

    def _tally_tail(self, launch: str, shape: list) -> None:
        s = self._tally("demod_tail", shape, 0.0)
        s["bit_equal"] = True
        by = s.setdefault("by_launch", {})
        by[launch] = by.get(launch, 0) + 1

    def _tally(self, name: str, shape: list, err: float) -> dict:
        s = self.summary.setdefault(name, dict(calls=0, shapes=[],
                                               max_abs_err=0.0))
        s["calls"] += 1
        if shape not in s["shapes"]:
            s["shapes"].append(shape)
        s["max_abs_err"] = max(s["max_abs_err"], err)
        return s


def gather_phase(dev, tmp) -> dict:
    """1 MHz (decimation 4): the fused shape is unsupported, so the
    group program gathers windows; each gather captured into a graph is
    held bit-equal to the plain gather after every replay (`ReplayCheck`),
    and the burst is detected. The launches are the first run's; the wall
    is a second run's, on the captured graphs."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.runtime import pipeline as pl
    from iridium_tpu_torch.tools.captures import capture_1mhz, write_cf32

    cap = capture_1mhz(SEED + 3)
    path = os.path.join(tmp, "capture_1mhz.cf32")
    write_cf32(path, cap)
    pipe = pl.Pipeline(det_cfg=DetectorConfig(sample_rate=1_000_000),
                       start_time_ns=0, device=dev, want_llr=False)
    _kernels.reset_counts()
    with ReplayCheck() as chk:
        list(pipe.run_file(path))
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    # the same decode again on the captured graphs, for its wall
    pipe.reset(0)
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if counts["window_gather"] == 0 or counts["detect_scan"] == 0:
        raise AssertionError(f"1 MHz decode launches: {counts}")
    if counts["fused_frontend"] != 0:
        raise AssertionError("1 MHz decode took the fused path")
    if "window_gather" not in chk.summary:
        raise AssertionError("no gather was captured into a group graph")
    for name in ("demod_loop", "downmix_fir", "downmix_chain",
                 "demod_tail"):
        if name not in chk.summary:
            raise AssertionError(f"no {name} call was captured into a "
                                 "group graph")
    if pipe.stats.n_detected < 1 or not frames:
        raise AssertionError("1 MHz decode: the burst was not detected")
    seconds = len(cap) / 1_000_000
    return dict(phase="decode_1mhz", detected=pipe.stats.n_detected,
                raw_lines=len(frames),
                gathers_checked=chk.summary["window_gather"]["calls"],
                capture_s=seconds, wall_s=wall, realtime_x=seconds / wall,
                kernel_checks=chk.summary, launches=counts)


def demod_phase(dev) -> dict:
    """The demodulator alone (the loop kernel and the plain tail) at a
    256-burst batch of the small-normal class's shape (1,918 samples, 205
    symbols), and the loop alone."""
    import torch
    from iridium_tpu_torch.dsp import demod
    from iridium_tpu_torch.io import synth
    rng = np.random.default_rng(SEED + 4)
    B, L, S = 256, 1918, 205
    x = np.zeros((B, L), np.complex64)
    for b in range(B):
        sym = synth.burst_symbols(rng.integers(0, 2, 300))[28:]
        w = synth.modulate(sym)[:L]
        x[b, :len(w)] = w
    xt = torch.from_numpy(x).to(dev)
    n = torch.full((B,), L, dtype=torch.int32, device=dev)
    direc = torch.zeros(B, dtype=torch.int32, device=dev)
    dm = demod.Demod(S, 10.0, device=dev)
    ms = time_ms(lambda: dm.decide_plain(*dm.loop(xt, n), direc), reps=3)
    loop_ms = time_ms(lambda: demod.loop(xt, n.long(), 10.0, S, True),
                      reps=3)
    return dict(phase="demod_loop", batch=B, symbols=S, ms=ms,
                loop_ms=loop_ms)


# ---- mesh: the sharded pipeline at world size 1 over NCCL ----

def strip_id(line: str) -> str:
    import re
    return re.sub(r"I:\d{11}", "I:-----------", line)


def cli_lines(*runs) -> list:
    """RAW lines of the port's CLI, each run (its arguments, or (its
    arguments, a file fed to its stdin)) as its own process, all at once:
    per run the lines from the frequency on (the first fields hold the
    wall-clock start)."""
    procs, out = [], []
    try:
        for run in runs:
            args, src = (run, None) if isinstance(run, list) else run
            with open(src or os.devnull, "rb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "iridium_tpu_torch.cli"] + args,
                    cwd=HERE, stdin=f, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
        for args, p in zip(runs, procs):
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"CLI {args}: exit {p.returncode}\n"
                                     f"{stderr[-2000:]}")
            out.append([x.split(" ")[3:] for x in stdout.splitlines()])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def mesh_phase(dev, tmp, single: dict) -> dict:
    """The sharded pipeline (`parallel/stream.py`) in this process at world
    size 1 over NCCL: (1) replicated detect on the RAW 10 MHz capture file
    (the scan kernel, the fused front-end), warm (graphs captured by a
    first run): the single card's lines, ids included, and every payload
    bit-exact; (2) binshard detect on the 1 MHz capture (detect_fast's
    kernel cut at the coupling seam: launch A, the all_reduce of the
    pair, launch B, a frame, a block's frames replayed as one CUDA graph
    captured by the first run; the window gather), warm: the lines of the
    single card's Pipeline(detect_impl="fast") with the ids masked; (2b)
    binshard detect on the RAW 10 MHz capture (the split's cluster of 2
    blocks, the fused front-end), warm: every payload bit-exact, the lines
    of phase 3b's Pipeline(detect_impl="fast") with the ids masked; (3)
    the CLI with `--mesh 1` (one spawned rank) and
    without it, each its own process, on the 1 MHz capture: the same
    lines; (4) the CLI on the RAW 10 MHz capture as a file, and from
    stdin with `--mesh 1` (rank 0 reads it and broadcasts each block): the
    same lines (the four processes run side by side). The warm-up runs of
    (1)
    and (2) capture the graphs and hold every kernel call in them to its
    plain version after each replay (`ReplayCheck`), at the shapes of the
    sharded capacities. Walls and realtime factors beside the single
    card's, the collectives' device ms, the kernel launches of (1) and
    (2)."""
    import torch
    import torch.distributed as dist
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.parallel import distributed
    from iridium_tpu_torch.parallel.stream import ShardedPipeline
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools.captures import PROD

    reduces = [0]
    all_reduce = dist.all_reduce

    def counted_all_reduce(*a, **k):
        reduces[0] += 1
        return all_reduce(*a, **k)

    def timed(pipe, path, check=None):
        """A warm-up decode (under `check`, where given), then a counted
        one: (lines, frames, wall, launches), and in `reduces` the counted
        decode's calls of `dist.all_reduce` from the host."""
        with check or contextlib.nullcontext():
            list(pipe.run_file(path))
        pipe.reset(T0)
        torch.cuda.synchronize()
        _kernels.reset_counts()
        reduces[0] = 0
        dist.all_reduce = counted_all_reduce
        try:
            t = time.perf_counter()
            frames = list(pipe.run_file(path))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            dist.all_reduce = all_reduce
        printer = RawPrinter()
        return ([printer.format(f) for f in frames], frames, wall,
                {k.name: k.launches for k in _kernels.KERNELS})

    def graph_loop(sb, launches: dict, name: str) -> dict:
        """Binshard's detect ran as one graph replay a block: a replay a
        block of the counted decode, 2 detect_fast launches an active
        frame counted by the replays, no all_reduce called from the
        host."""
        g = sb.split_graphs
        blocks = sb.timing["n_blocks"]  # the counted decode's (the warm-up
        # decode replayed as many)
        if (reduces[0] != 0 or g.replays != 2 * blocks
                or launches["detect_fast"] % 2
                or sb.timing["detect_graph"] <= 0):
            raise AssertionError(f"mesh {name}: the frame loop did not run "
                                 f"as one graph a block: {reduces[0]} host "
                                 f"all_reduces, {g.replays} replays")
        return dict(graph_replays=g.replays, host_all_reduces=reduces[0],
                    graphs_captured=len(g._graphs),
                    detect_graph_ms=1e3 * sb.timing["detect_graph"])

    made = distributed.initialize(device="cuda")
    try:
        mesh = distributed.make_mesh()
        res = dict(phase="mesh", world_size=mesh.n,
                   backend=dist.get_backend())
        det = DetectorConfig(**PROD)
        sp = ShardedPipeline(det, mesh=mesh, start_time_ns=T0,
                             want_llr=False, burst_batch=128)
        chk = ReplayCheck()
        lines, frames, wall, rep = timed(sp, single["path"], chk)
        if lines != single["lines"]:
            raise AssertionError(f"mesh replicated 10 MHz: {len(lines)} lines "
                                 f"differ from the single card's "
                                 f"{len(single['lines'])}")
        missing = missing_payloads(frames, single["bursts"], det)
        if missing:
            raise AssertionError(f"mesh replicated 10 MHz: payloads not "
                                 f"decoded bit-exact: {missing}")
        for name in ("detect_scan", "fused_frontend"):
            if rep[name] == 0:
                raise AssertionError(f"mesh replicated never launched {name}")
        for name in ("fused_frontend", "demod_loop", "downmix_fir",
                     "downmix_chain", "demod_tail"):
            if name not in chk.summary:
                raise AssertionError(f"mesh replicated: no {name} call was "
                                     "checked")
        demod_calls = chk.summary["demod_loop"]["calls"]
        fir_calls = chk.summary["downmix_fir"]["calls"]
        chain_calls = chk.summary["downmix_chain"]["calls"]
        tail_calls = chk.summary["demod_tail"]["calls"]
        seconds = single["capture_s"]
        res["replicated_10mhz"] = dict(
            detect_impl=sp.detect_impl, lines=len(lines),
            lines_equal_with_ids=True,
            payloads_bit_exact=len(single["bursts"]), wall_s=wall,
            realtime_x=seconds / wall, single_wall_s=single["wall_s"],
            single_realtime_x=seconds / single["wall_s"],
            collectives_ms=1e3 * sp.timing["collectives"],
            n_collectives=sp.timing["n_collectives"],
            stages=dict(sp.timing), launches=rep,
            graphs=graph_info({"block": sp._graph}))
        check_class_nodes(res["replicated_10mhz"]["graphs"], sp.classes,
                          "mesh replicated")
        del sp

        path1 = os.path.join(tmp, "capture_1mhz.cf32")
        det1 = DetectorConfig(sample_rate=1_000_000)
        one = Pipeline(det_cfg=det1, start_time_ns=T0, device=dev,
                       want_llr=False, detect_impl="fast")
        want, _, wall1, one_c = timed(one, path1)
        del one
        sb = ShardedPipeline(det1, mesh=mesh, start_time_ns=T0,
                             want_llr=False, burst_batch=128,
                             detect_mode="binshard")
        got, _, wall_b, binc = timed(sb, path1, chk)
        if not want or list(map(strip_id, got)) != list(map(strip_id, want)):
            raise AssertionError(f"mesh binshard 1 MHz: {len(got)} lines "
                                 f"against {len(want)}")
        # binshard runs detect_fast's kernel split around its all_reduce
        # a frame (two launches a frame); the single card the one launch
        if (binc["window_gather"] == 0 or binc["detect_scan"] != 0
                or binc["detect_fast"] == 0 or one_c["detect_fast"] == 0):
            raise AssertionError(f"mesh binshard 1 MHz launches: {binc}, "
                                 f"the single card's: {one_c}")
        if ("window_gather" not in chk.summary
                or chk.summary["demod_loop"]["calls"] == demod_calls
                or chk.summary["downmix_fir"]["calls"] == fir_calls
                or chk.summary["downmix_chain"]["calls"] == chain_calls
                or chk.summary["demod_tail"]["calls"] == tail_calls):
            raise AssertionError("mesh binshard: no gather, demod loop, "
                                 "downmix FIR or chain or demod tail was "
                                 "checked")
        seconds1 = os.path.getsize(path1) / 8 / 1_000_000
        loop1 = graph_loop(sb, binc, "binshard 1 MHz")
        res["binshard_1mhz"] = dict(
            graph_loop=loop1, detect_impl=sb.detect_impl, lines=len(got),
            lines_equal_ids_masked=True, wall_s=wall_b,
            realtime_x=seconds1 / wall_b, single_fast_wall_s=wall1,
            single_fast_realtime_x=seconds1 / wall1,
            collectives_ms=1e3 * sb.timing["collectives"],
            n_collectives=sb.timing["n_collectives"],
            stages=dict(sb.timing), launches=binc,
            single_fast_launches=one_c,
            graphs=graph_info({"block": sb._graph}))
        check_class_nodes(res["binshard_1mhz"]["graphs"], sb.classes,
                          "mesh binshard")
        del sb

        # the split's cluster end to end: binshard on the RAW 10 MHz capture
        sb = ShardedPipeline(det, mesh=mesh, start_time_ns=T0,
                             want_llr=False, burst_batch=128,
                             detect_mode="binshard")
        got10, frames10, wall10, b10c = timed(sb, single["path"])
        want10 = single["fast_lines"]
        if list(map(strip_id, got10)) != list(map(strip_id, want10)):
            raise AssertionError(f"mesh binshard 10 MHz: {len(got10)} lines "
                                 f"against the fast decode's {len(want10)}")
        missing = missing_payloads(frames10, single["bursts"], det)
        if missing:
            raise AssertionError(f"mesh binshard 10 MHz: payloads not "
                                 f"decoded bit-exact: {missing}")
        if (b10c["detect_fast"] == 0 or b10c["detect_scan"] != 0
                or b10c["fused_frontend"] == 0):
            raise AssertionError(f"mesh binshard 10 MHz launches: {b10c}")
        loop10 = graph_loop(sb, b10c, "binshard 10 MHz")
        res["binshard_10mhz"] = dict(
            graph_loop=loop10,
            detect_impl=sb.detect_impl, lines=len(got10),
            lines_equal_ids_masked=True,
            payloads_bit_exact=len(single["bursts"]), wall_s=wall10,
            realtime_x=seconds / wall10,
            single_fast_wall_s=single["fast_wall_s"],
            collectives_ms=1e3 * sb.timing["collectives"],
            n_collectives=sb.timing["n_collectives"],
            stages=dict(sb.timing), launches=b10c)
        del sb
    finally:
        if made:
            distributed.shutdown()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    args = ["-f", path1, "-r", "1000000"]
    raw = ["--format", "cf32"]
    plain, meshed, raw_file, raw_stdin = cli_lines(
        args, args + ["--mesh", "1"], ["-f", single["path"]] + raw,
        (["-f", "-", "--mesh", "1"] + raw, single["path"]))
    if not plain or meshed != plain:
        raise AssertionError(f"CLI --mesh 1: {len(meshed)} lines against "
                             f"{len(plain)} without --mesh")
    if not raw_file or raw_stdin != raw_file:
        raise AssertionError(f"CLI --mesh 1 -f -: {len(raw_stdin)} lines "
                             f"against {len(raw_file)} from the file")
    res["cli_1mhz"] = dict(lines=len(plain), mesh_1_lines_equal=True)
    res["cli_stdin_10mhz"] = dict(lines=len(raw_file),
                                  mesh_1_stdin_lines_equal=True)
    res["cli_processes_s"] = time.perf_counter() - t
    res["launches"] = {k: rep[k] + binc[k] + one_c[k] + b10c[k]
                       for k in rep}
    # detect_fast's launches by the split (binshard) on this path
    res["split_launches"] = {"binshard_1mhz": binc["detect_fast"],
                             "binshard_10mhz": b10c["detect_fast"]}
    res["kernel_checks"] = chk.summary
    return res


# ---- phase 5: the protocol decode (--parsed, ACARS) at 10 MHz ----

ACARS_TEXT = b"SMOKE TEST 1"


def frames_capture(rng):
    """Three production blocks of 10 MHz noise (the last one partial)
    with IRA and IBC frames in the simplex band and IDA frames in the
    duplex band: five single-burst messages (one straddling the first
    block boundary) and one ACARS SBD message over two IDA bursts 90 ms
    apart on one channel. Returns the capture and what was injected."""
    from iridium_tpu_torch.io import synth, synth_frames as sf
    from iridium_tpu_torch.tools.captures import PROD
    fs = PROD["sample_rate"]
    block = PROD["frames_per_block"] * 8192
    cap = synth.noise(2 * block + 4_000_000, seed=SEED + 6)
    ira = [(55, 21, (1000, -500, 1200)), (12, 3, (500, 600, -700)),
           (77, 40, (-1200, 300, 900))]
    ibc = [(33, 9), (70, 12)]
    ida = [b"HELLO-IRIDIUM", b"0123456789ABCDEFGHIJ", b"SMOKE", b"IRIDIUM",
           b"BLOCK-EDGE"]
    acars = sf.ida_message_bursts(
        sf.sbd_ida_message(sf.acars_sbd(ACARS_TEXT)), lcw_code=6)
    plan = [(sf.ira_payload_bits(sat, beam, xyz), 4_100_000.0 + 80_000 * k)
            for k, (sat, beam, xyz) in enumerate(ira)]
    plan += [(sf.ibc_payload_bits(sat, beam, iri_time=1000 + k),
              4_200_000.0 + 80_000 * k) for k, (sat, beam) in enumerate(ibc)]
    plan += [(sf.ida_payload_bits(t, lcw_code=6, lcw3_val=0x12345 + k),
              off) for k, (t, off) in enumerate(zip(
                  ida, (137_000.0, -2_310_000.0, 1_020_000.0, 3_050_000.0,
                        -220_000.0)))]
    starts = [5_000_000, 7_400_000, 9_800_000, 12_200_000, 14_600_000,
              19_000_000, 21_400_000, 23_800_000, 26_200_000, block - 30_000]
    plan = [(bits, off, start) for (bits, off), start in zip(plan, starts)]
    plan += [(acars[0], -880_000.0, 29_000_000),
             (acars[1], -880_000.0, 29_900_000)]
    for bits, off, start in plan:
        # 8 guard bits after the frame, as in production_capture
        b = np.concatenate([bits, rng.integers(0, 2, 8).astype(np.uint8)])
        synth.add_burst(cap, synth.burst_waveform(b, fs, off), start,
                        snr_db=float(rng.uniform(22.0, 32.0)))
    return cap, dict(ira=[(sat, beam) for sat, beam, _ in ira],
                     ibc=ibc, ida=ida, bursts=len(plan))


def parsed_phase(dev, tmp) -> dict:
    """`--parsed --acars-json` at the production configuration, through
    the calls the CLI's decode loop makes: the pipeline with LLRs, one
    block-batched protocol decode per block, `IDA:` lines, the ACARS
    reassembler and decoder. Every packed batch captured into the group
    graph is recorded (`decide_pack`'s inputs and rows), and after the
    counted decode its unpacked LLRs (those of the graph's last replay)
    are held against the demod's f32 LLRs of that replay (the twin's
    decisions on the recorded loop output)."""
    import io
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.decode import batch, ida as ida_mod, sbd_acars
    from iridium_tpu_torch.io import native
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime import pipeline as pl
    from iridium_tpu_torch.tools.captures import PROD, write_cf32

    cap, want = frames_capture(np.random.default_rng(SEED + 7))
    path = os.path.join(tmp, "frames_10mhz.cf32")
    write_cf32(path, cap)
    seconds = len(cap) / PROD["sample_rate"]
    det = DetectorConfig(**PROD)
    packed = []
    kernel_pack = pl.decide_pack

    def recording(*args):
        out = kernel_pack(*args)
        if torch.cuda.is_current_stream_capturing():
            packed.append((args, out, args[5] // 2))
        return out

    pipe = pl.Pipeline(det_cfg=det, device=dev, want_llr=True)

    def decode():
        pipe.reset(T0)
        printer, reasm = RawPrinter(), ida_mod.IdaReassembler()
        acars = sbd_acars.AcarsDecoder(json_out=True, text_out=io.StringIO(),
                                       station="SMOKE")
        lines, decoded = [], []
        for frames in pipe.run_blocks(native.read_blocks(
                path, pipe.p.block_samples, None, pipe.device)):
            for f, (d, b) in zip(frames, batch.decode_block(frames)):
                lines.append(printer.format_ida(b) if b is not None
                             else printer.format(f))
                if d is not None:
                    decoded.append(d)
                if b is not None:
                    reasm.push(b, acars.process)
                reasm.flush(f["timestamp_ns"])
        return lines, decoded, acars

    pl.decide_pack = recording
    try:
        decode()                               # warm-up, graph capture
    finally:
        pl.decide_pack = kernel_pack
    if not packed:
        raise AssertionError("no packed batch was captured")
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t = time.perf_counter()
    lines, decoded, acars = decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    for name in ("detect_scan", "fused_frontend"):
        if counts[name] == 0:
            raise AssertionError(f"parsed decode never launched {name}")
    ida_lines = [x for x in lines if x.startswith("IDA:")]
    missing = [t for t in want["ida"]
               if not any(f"[{'.'.join(f'{c:02x}' for c in t)}]" in x
                          and "CRC:OK" in x for x in ida_lines)]
    if missing:
        raise AssertionError(f"IDA payloads not recovered: {missing}")
    ira = {(d.sat_id, d.beam_id) for k, d in decoded if k == "IRA"}
    ibc = {(d.sat_id, d.beam_id) for k, d in decoded if k == "IBC"}
    if not set(want["ira"]) <= ira or not set(want["ibc"]) <= ibc:
        raise AssertionError(f"IRA/IBC ids: got {ira} / {ibc}, want "
                             f"{want['ira']} / {want['ibc']}")
    texts = [json.loads(x)["iridium"]["acars"].get("msg_text")
             for x in acars.text_out.getvalue().splitlines()]
    if texts != [ACARS_TEXT.decode()]:
        raise AssertionError(f"ACARS text: {texts}")
    # unpacked LLRs within one quantum (scale / 65535) of the f32 LLRs
    worst = 0.0
    for (dmd, pll_out, valid, total, dm, *_), out, ms in packed:
        u = pl.unpack_outputs(out.cpu().numpy(), ms, True)["llr"]
        f32 = dmd.decide_plain(pll_out, valid, total,
                               dm.direction).llr.cpu().numpy()
        q = f32.max(1, keepdims=True) / 65535.0
        err = np.abs(u[:, :f32.shape[1]] - f32)
        if (err > q + 1e-7 * np.abs(f32)).any():
            raise AssertionError("unpacked LLRs beyond one quantum")
        worst = max(worst, float((err / np.maximum(q, 1e-30)).max()))
    st = pipe.stats
    return dict(phase="decode_parsed_10mhz", capture_s=seconds, wall_s=wall,
                realtime_x=seconds / wall, injected=want["bursts"],
                detected=st.n_detected, ok=st.n_ok, lines=len(lines),
                ida_lines=len(ida_lines), ira=len(ira), ibc=len(ibc),
                acars=len(texts), llr_batches=len(packed),
                llr_err_quanta=worst, stages=dict(pipe.timing),
                graphs=graph_info(pipe.graphs), launches=counts)


def tool_phase(dev) -> dict:
    """The block-gather sweep tool on the card: R = 64, 128, 256 at the
    tool's shapes; each run's sum check must pass."""
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.tools import exp_block_gather as tool
    _kernels.reset_counts()
    res = tool.sweep((64, 128, 256), dev)
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    if counts["block_gather"] == 0:
        raise AssertionError("the sweep tool never launched block_gather")
    return dict(phase="tool_block_gather", launches=counts,
                sweep=[{k: r[k] for k in ("R", "nt", "ms", "out_gbps",
                                          "moved_gbps", "sum")}
                       for r in res])


# ---- phase 7: a live band's density through the group flow ----

def dense_phase(dev, tmp) -> tuple[dict, dict]:
    """The dense capture through the group flow (after a warm-up on its
    first group that captures the graph), with its host-routed run on the
    same pipeline; then its first block with class batches of 16, 24 and
    24 bursts (`group_jobs=1, burst_batch=8`), group flow against
    host-routed flow. Then the group program through its graphs on its
    last (dense) group and on the same group emptied (head counts
    zeroed), and each graph's replay alone."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools.captures import (PROD, dense_capture,
                                                  write_cf32)

    t = time.perf_counter()
    cap, injected = dense_capture(SEED + 8)
    path = os.path.join(tmp, "dense_10mhz.cf32")
    write_cf32(path, cap)
    make_s = time.perf_counter() - t
    bs = PROD["frames_per_block"] * 8192
    seconds = len(cap) / PROD["sample_rate"]
    det = DetectorConfig(**PROD)

    def lines_of(pipe, host_routed, source):
        pipe.reset(T0)
        pipe.host_routed = host_routed
        try:
            printer = RawPrinter()
            return [printer.format(f) for f in source()]
        finally:
            pipe.host_routed = False

    pipe = Pipeline(det_cfg=det, device=dev, want_llr=False)
    lines_of(pipe, False, lambda: pipe.run_array(cap[:4 * bs]))  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t = time.perf_counter()
    lines = lines_of(pipe, False, lambda: pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    st, timing, q_peak = pipe.stats, dict(pipe.timing), pipe.take_q_peak()
    host = lines_of(pipe, True, lambda: pipe.run_file(path))
    if host != lines:
        raise AssertionError(f"dense: host-routed lines differ "
                             f"({len(host)} against {len(lines)})")

    g = pipe.graphs[4]
    g.scal[1:] = 0                  # the first round: every class runs
    dense_ms = host_ms(lambda: graph_run(pipe, g))
    class_ms = {name: time_ms(c.graph.replay, reps=3)
                for name, c in zip(GRAPH_PARTS, g.parts) if c.graph}
    busy = g.tables[:, 0, 0].clone()
    g.tables[:, 0, 0] = 0
    empty_ms = host_ms(lambda: graph_run(pipe, g))
    g.tables[:, 0, 0] = busy

    small = Pipeline(det_cfg=det, device=dev, want_llr=False,
                     group_jobs=1, burst_batch=8)
    first = cap[:bs]
    got = lines_of(small, False, lambda: small.run_array(first))
    overflow = small.timing["n_overflow_rounds"]
    want = lines_of(small, True, lambda: small.run_array(first))
    if got != want or overflow < 1:
        raise AssertionError(f"dense, small batches: {len(got)} lines "
                             f"against {len(want)}, {overflow} overflow "
                             "rounds")
    block_ms = 1e3 * bs / PROD["sample_rate"]
    graphs, small_graphs = graph_info(pipe.graphs), graph_info(small.graphs)
    check_class_nodes(graphs, pipe.classes, "dense decode")
    check_class_nodes(small_graphs, small.classes, "dense, small batches")
    return dict(phase="dense_10mhz", capture_s=seconds, make_s=make_s,
                injected=injected, wall_s=wall, realtime_x=seconds / wall,
                raw_lines=len(lines), raw_per_s=len(lines) / wall,
                detected=st.n_detected, ok=st.n_ok,
                ok_pct=100.0 * st.n_ok / max(st.n_detected, 1),
                n_groups=timing["n_groups"],
                n_overflow_rounds=timing["n_overflow_rounds"],
                q_peak=q_peak, stages=timing, host_lines_equal=True,
                small_batches=dict(lines=len(got), equal=True,
                                   n_overflow_rounds=overflow,
                                   graphs=small_graphs),
                graph=dict(parts=graphs[4], replay_ms=class_ms,
                           group_dense_ms=dense_ms, group_empty_ms=empty_ms,
                           all_classes_share_of_block=sum(
                               class_ms.values()) / block_ms,
                           empty_share_of_block=empty_ms / block_ms),
                launches=counts), dict(pipe=pipe, path=path, lines=lines,
                                       seconds=seconds)


# ---- scan_shapes: the kernel at the shapes the chunk rules refused ----

SCAN_SHAPES = (dict(frames_per_block=100, history_size=32),
               dict(frames_per_block=1000),
               dict(frames_per_block=2048, history_size=16))


# the derived configurations above 16,384 bins: 1,024 frames of 32,768,
# 65,536, 131,072 and 262,144 bins, clusters of 4, 8 and 16 blocks of
# 8,192 bins and 16 blocks of 16,384 (the wide path); 524,288 and
# 1,048,576, grids of 4 clusters of 16 blocks of 8,192 and 16,384
WIDE_RATES = (25_000_000, 50_000_000, 100_000_000, 200_000_000,
              400_000_000, 800_000_000)
# (sample rate, fft_size) of shapes whose layout pads or splits unevenly:
# 1,152 (one block of 576 threads of 2 bins), 12,288 and 20,480 (clusters
# of 2 and 4 blocks of 6,144 and 5,120 bins on 768 and 640 threads),
# 16,384 (2 blocks of 8,192: 20 MHz) and 393,216 (a grid of 3 clusters of
# 16 blocks of 8,192, no power of two)
ODD_SHAPES = ((1_000_000, 1152), (12_000_000, 12288), (20_000_000, 16384),
              (20_000_000, 20480), (300_000_000, 393216))


def check_odd_shape(rate: int, F: int, dev) -> dict:
    """The scan kernel at `rate` with `fft_size` F (1,024 frames, history
    512, max_bursts 20) against the plain scan on `tools/exp_scan.py`'s
    shape edge block from a fresh state (bursts beside the DC notch, a tie
    and a dilation across a thread or block edge, a burst by the last
    eligible bins, squelch drops): bit-equal, dB fields within rtol 1e-5;
    timed with its layout."""
    import torch
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan, state as st
    from iridium_tpu_torch.tools import exp_scan

    p = DetectorConfig(sample_rate=rate, fft_size=F, max_bursts=20).derived()
    nv = p.block_samples
    mag2 = torch.from_numpy(exp_scan.shape_edge_spectrogram(p, seed=11)).to(
        dev)
    s0 = st.init_state(p, dev)
    got = detect_scan.scan(mag2, s0, nv, p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = detect_scan.scan_plain(mag2, s0, nv, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = exp_scan.compare(got, want)
    if int(got.burst_dropped) < 1:
        raise AssertionError(f"scan at F = {F}: no squelch drops")
    ms = time_ms(lambda: detect_scan.scan(mag2, s0, nv, p))
    b_ms, b_by = scan_bound(p)
    return dict(shape=[p.frames_per_block, F], sample_rate=rate,
                layout=list(detect_scan.layout(F)),
                resolves=detect_scan.resolve_impl(p), ms=ms,
                us_per_frame=ms * 1e3 / p.frames_per_block,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, gone=int(got.g_count),
                tagged=int(got.n_tagged), dropped=int(got.burst_dropped))


def check_cluster_shape(rate: int, dev) -> dict:
    """The scan kernel at the derived configuration of `rate` (1,024 frames
    of 32,768 to 262,144 bins, which it runs as a cluster of 4 to 16
    blocks, and of 524,288 and 1,048,576, a grid of 4 clusters of 16)
    against the plain scan: `tools/exp_scan.py`'s synthetic block
    from a fresh state (its first 512 frames prime the history; bursts, a
    long burst), timed, then its cluster edge block from the state that
    block left (bursts beside the DC notch on a block edge, ties and
    dilations across the other edges, a comb). Bit-equal, dB fields
    within rtol 1e-5. Also how many such clusters the card holds at once
    (`max_active_clusters`: a cluster of 16 is a non-portable size; a
    grid's clusters must all fit)."""
    import torch
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan, state as st
    from iridium_tpu_torch.tools import exp_scan

    p = DetectorConfig(sample_rate=rate).derived()
    nv = p.block_samples
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    synth = exp_scan.synthetic_spectrogram(p, gen)
    s0 = st.init_state(p, dev)
    got = detect_scan.scan(synth, s0, nv, p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = detect_scan.scan_plain(synth, s0, nv, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = exp_scan.compare(got, want)
    ms = time_ms(lambda: detect_scan.scan(synth, s0, nv, p))
    del synth
    st.rebase_(want, nv)
    edge = torch.from_numpy(exp_scan.cluster_edge_spectrogram(
        p, seed=11)).to(dev)
    got_e = detect_scan.scan(edge, want, nv, p)
    err = max(err, exp_scan.compare(
        got_e, detect_scan.scan_plain(edge, want, nv, p)))
    b_ms, b_by = scan_bound(p)
    return dict(shape=[p.frames_per_block, p.fft_size],
                sample_rate=rate, clusters=detect_scan.clusters(p.fft_size),
                grid_clusters=detect_scan.grid_clusters(p.fft_size),
                layout=list(detect_scan.layout(p.fft_size)),
                max_active_clusters=detect_scan.max_active_clusters(
                    p.fft_size),
                resolves=detect_scan.resolve_impl(p), ms=ms,
                us_per_frame=ms * 1e3 / p.frames_per_block,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, gone=int(got.g_count),
                tagged=int(got.n_tagged), edge_gone=int(got_e.g_count),
                edge_tagged=int(got_e.n_tagged),
                edge_dropped=int(got_e.burst_dropped))


# shapes above the largest resident grid (MAX_RESIDENT, 1,835,008 bins),
# which the kernel runs tiled: (sample rate, fft_size, frames a block) of
# the first F above it (2 tiles a block), 1.6 GHz (2 tiles) and 3.2 GHz (3
# tiles); the frames keep a block under 2^31 samples (int32 positions)
TILED_SHAPES = ((1_400_000_000, 1835136, 1024),
                (1_600_000_000, 2097152, 512),
                (3_200_000_000, 4194304, 256))


def check_tiled_shape(rate: int, F: int, frames: int, dev) -> dict:
    """The scan kernel at F bins above MAX_RESIDENT (history 512,
    max_bursts 20, `frames` a block), which it runs as its tiled grid:
    from a state the plain scan primed on noise blocks, against the plain
    scan on `tools/exp_scan.py`'s cluster edge block drawn on the card
    (ties, dilations and bursts across every tile and block edge, the DC
    pair, the squelch comb with drops): bit-equal, dB fields within rtol
    1e-5; timed with its layout, tiles and `max_active_clusters`."""
    import torch
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan, state as st
    from iridium_tpu_torch.tools import exp_scan

    p = DetectorConfig(sample_rate=rate, fft_size=F, frames_per_block=frames,
                       max_bursts=20).derived()
    nv = p.block_samples
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    s0 = st.init_state(p, dev)
    while int(s0.ints[1]) < p.history_size:
        noise = torch.empty((frames, F), device=dev).exponential_(
            generator=gen)
        s0 = detect_scan.scan_plain(noise, s0, nv, p)
        st.rebase_(s0, nv)
        del noise
    edge = exp_scan.cluster_edge_spectrogram(p, seed=11, gen=gen, t0=8)
    got = detect_scan.scan(edge, s0, nv, p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = detect_scan.scan_plain(edge, s0, nv, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = exp_scan.compare(got, want)
    if int(got.burst_dropped) < 1:
        raise AssertionError(f"scan at F = {F}: no squelch drops")
    res = dict(gone=int(got.g_count), tagged=int(got.n_tagged),
               dropped=int(got.burst_dropped))
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: detect_scan.scan(edge, s0, nv, p))
    b_ms, b_by = scan_bound(p)
    lay = detect_scan.layout(F)
    return dict(shape=[frames, F], sample_rate=rate, layout=list(lay),
                tiles=lay[5], grid_clusters=lay[4],
                max_active_clusters=detect_scan.max_active_clusters(F),
                resolves=detect_scan.resolve_impl(p), ms=ms,
                us_per_frame=ms * 1e3 / frames, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                max_abs_err=err, **res)


def scan_shapes_phase(dev, spills: dict) -> dict:
    """The scan kernel against the plain scan at 10 MHz (F = 8192) at the
    shapes the Pallas scan's chunk rules refuse (frames_per_block 100 and
    1000; history_size 16), on `tools/exp_scan.py`'s edge block (bursts
    across thread edges, an exact tie, a squelch blast): bit-equal, timed,
    with the scan each shape resolves to; then at the odd sizes of
    ODD_SHAPES (`check_odd_shape`) and at 25, 50, 100, 200, 400 and 800
    MHz (F = 32768 to 1048576), which must resolve to the kernel, as its
    cluster of 4, 8 and 16 blocks or its grid of clusters, all of which
    the card holds at once (`check_cluster_shape`). `spills`: `ptxas -v`'s
    registers and spill bytes per instantiation of the kernel."""
    import torch
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan, state as st
    from iridium_tpu_torch.tools import exp_scan

    shapes = []
    for kw in SCAN_SHAPES:
        p = DetectorConfig(sample_rate=10_000_000, max_bursts=20,
                           **kw).derived()
        mag2 = torch.from_numpy(exp_scan.edge_spectrogram(p, seed=11)).to(
            dev)
        s0 = st.init_state(p, dev)
        got = detect_scan.scan(mag2, s0, p.block_samples, p)
        err = exp_scan.compare(got, detect_scan.scan_plain(
            mag2, s0, p.block_samples, p))
        shapes.append(dict(
            frames_per_block=p.frames_per_block,
            history_size=p.history_size,
            resolves=detect_scan.resolve_impl(p), max_abs_err=err,
            gone=int(got.g_count), tagged=int(got.n_tagged),
            ms=time_ms(lambda: detect_scan.scan(mag2, s0, p.block_samples,
                                                p))))
    if any(sh["resolves"] != "scan" for sh in shapes):
        raise AssertionError(f"a chunk shape does not resolve to the "
                             f"kernel: {shapes}")
    odd = [check_odd_shape(rate, F, dev) for rate, F in ODD_SHAPES]
    if any(o["resolves"] != "scan" for o in odd):
        raise AssertionError(f"an odd shape does not resolve to the "
                             f"kernel: {odd}")
    wide = [check_cluster_shape(rate, dev) for rate in WIDE_RATES]
    if any(w["resolves"] != "scan" or w["clusters"] < 2
           or w["max_active_clusters"] < w["grid_clusters"] for w in wide):
        raise AssertionError(f"a wideband shape does not resolve to the "
                             f"cluster kernel: {wide}")
    torch.cuda.empty_cache()
    tiled = []
    for rate, F, frames in TILED_SHAPES:
        tiled.append(check_tiled_shape(rate, F, frames, dev))
        torch.cuda.empty_cache()
    if any(t["resolves"] != "scan" or t["tiles"] < 2
           or t["max_active_clusters"] < t["grid_clusters"] for t in tiled):
        raise AssertionError(f"a shape above the resident grid does not "
                             f"resolve to the tiled kernel: {tiled}")
    return dict(phase="scan_shapes", shapes=shapes, odd=odd, wide=wide,
                tiled=tiled, ptxas=spills)


# ---- detect_fast_card: the other scans on the card against the CPU ----

def _to(state, dev):
    return type(state)(**{f: getattr(state, f).to(dev)
                          for f in state.__dataclass_fields__})


def detect_fast_card_phase(dev) -> dict:
    """The detect_fast kernel held to `scan_fast_plain` on the card bit for
    bit on every field of the state, at the shapes after the production
    block (`tools/exp_fast.py`, its doc): the edge block (256 x 8,192,
    n_valid ending mid-block), 1,024 x 32,768, x 65,536 and x 262,144
    (one cluster of 4, 8 and 16 blocks: each cluster size the layout
    uses, 2 being split1's), 1,024 x 524,288 (a grid of 4 clusters of
    16), 1,024 x 2,097,152 with n_valid = 2^31 (the 1.6 GHz block the
    scan kernel refuses; 64 clusters of 2 blocks of 16 bins a thread),
    and a local bin range (rank 1 of 4 at 10 MHz, ownership, id_stride 4,
    identity coupling), each timed with the twin's ms, the bound, the
    device operations a block and its instantiation's registers and
    spills, and beside the old design where DETECT_FAST_OLD_SOURCE names
    its source (`old_fast_design`); then binshard's split shapes, a
    block's frames replayed as one CUDA graph, held to the twins, to the
    eager steps and to the one launch (in the `kernels` line's
    `detail.per_shape`). Then the kernel on the card against the twin on
    the CPU on the production block (integer fields, baseline sums and
    history bit-equal, dB fields within rtol 1e-5: the CPU's log10 and
    division differ in the last ulp); and the exact scan (detect.py) on
    the card against the CPU on the edge block, held the same way."""
    import torch
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect, detect_fast, state as st
    from iridium_tpu_torch.tools import exp_fast, exp_scan

    cands = old_fast_design()
    per_shape = []
    for name in exp_fast.SHAPES[1:]:
        per_shape.append(old_design(exp_fast.run_case(
            exp_fast.case(name, dev), dev, cands=cands)))
        torch.cuda.empty_cache()
    by = {r["case"]: r for r in per_shape}
    if by["1600mhz"]["n_act"] != 1024 or by["1600mhz"]["n_valid"] != 2**31:
        raise AssertionError("the 1.6 GHz block did not run 2^31 samples")
    if by["edge"]["gone"] < 20 or by["edge"]["dropped"] < 1:
        raise AssertionError(f"detect_fast: the edge block did not reach "
                             f"the squelch and drop paths: {by['edge']}")
    for r in per_shape:
        if r["old_bit_equal"] is False:
            raise AssertionError(f"detect_fast's old design: {r}")
    # one cluster of each size the layout uses (2 is split1's)
    sizes = {r["case"]: r["layout"]["clusters"] for r in per_shape}
    if (sizes["25mhz"], sizes["50mhz"], sizes["200mhz"]) != (4, 8, 16):
        raise AssertionError(f"detect_fast cluster shapes: {sizes}")
    # binshard's split, its frames replayed as one CUDA graph: bit-equal to
    # the twins (exp_fast.compare_bits raises on any field but the dB
    # ones), to its eager steps and to the one launch
    for name in exp_fast.SPLIT_SHAPES:
        r = by[name] = old_design(exp_fast.run_split_case(
            exp_fast.split_case(name, dev), dev, cands=cands))
        per_shape.append(r)
        torch.cuda.empty_cache()
        if (not r["bit_equal"] or not r["eager_bit_equal"]
                or r["one_launch_bit_equal"] is False
                or r["old_bit_equal"] is False
                or r["kernel_launches"] != 2 * r["n_act"] * r["ranges"]):
            raise AssertionError(f"detect_fast split {name}: {r}")
    if by["split1"]["layout"]["clusters"] != 2:
        raise AssertionError("detect_fast split split1: not a cluster of 2")
    if by["split1_1mhz"]["layout"]["bins_per_thread"] != 2:
        raise AssertionError("detect_fast split split1_1mhz: not the 2 "
                             "bins a thread binshard's 1 MHz range runs")
    for name in ("split1_1mhz", "lockstep4"):
        if by[name]["squelch_rows"] < 1:
            raise AssertionError(f"detect_fast split {name}: the "
                                 f"(summed) count squelched nothing")

    c = exp_fast.case("10mhz", dev)
    p = c.p
    run = detect_fast.make_scan_fast(p)
    got = run(c.mag2, c.state, p.block_samples)
    t = time.perf_counter()
    want = run(c.mag2.cpu(), st.init_state(p, "cpu"), p.block_samples)
    cpu_ms = (time.perf_counter() - t) * 1e3
    err = exp_scan.compare(got, _to(want, dev))
    del c, got, want

    pe = DetectorConfig(sample_rate=10_000_000, history_size=64,
                        frames_per_block=256, max_new_per_frame=8,
                        gone_capacity=64, max_bursts=20).derived()
    m = torch.from_numpy(exp_scan.edge_spectrogram(pe, seed=11))
    idxs = np.arange(pe.frames_per_block) * pe.fft_size
    act = idxs + pe.fft_size <= pe.block_samples
    step = detect.make_frame_step(pe)
    t = time.perf_counter()
    ge = detect.run_state_machine(m.to(dev), idxs, act,
                                  detect.init_state(pe, dev), step)
    torch.cuda.synchronize()
    exact_ms = (time.perf_counter() - t) * 1e3
    we = _to(detect.run_state_machine(m, idxs, act,
                                      detect.init_state(pe, "cpu"), step),
             dev)
    for name in ("ints", "a_valid", "a_id", "a_start", "a_last", "a_bin",
                 "mask_count", "g_id", "g_start", "g_stop", "g_last",
                 "g_bin", "baseline_sum", "baseline_hist"):
        if not torch.equal(getattr(ge, name), getattr(we, name)):
            raise AssertionError(f"exact scan: {name} differs on the card")
    for name in ("g_mag", "g_noise", "a_mag", "a_noise", "floats"):
        torch.testing.assert_close(getattr(ge, name), getattr(we, name),
                                   rtol=1e-5, atol=0)
    return dict(phase="detect_fast_card", per_shape=per_shape,
                block=[p.frames_per_block, p.fft_size],
                fast_cpu_ms=cpu_ms, cpu_max_db_err=err,
                exact_block=[pe.frames_per_block, pe.fft_size],
                exact_card_ms=exact_ms, exact_gone=int(ge.g_count))


# ---- wideband_25mhz: F = 32768, the scan kernel as a cluster ----

WIDE = dict(sample_rate=25_000_000)


def wideband_capture(rng):
    """Two 25 MHz blocks (1024 frames of 32768, 1.342 s each) and part of
    a third, noise with 10 DL bursts after the detector's priming, one
    across the first block boundary, two 500-bit frames in the simplex
    band, two beyond the 10 MHz band. Returns the capture and the injected
    (start, offset Hz, payload bits)."""
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.io import synth
    p = DetectorConfig(**WIDE).derived()
    fs, block = p.sample_rate, p.block_samples
    cap = synth.noise(2 * block + 8_000_000, seed=SEED + 9)
    plan = [(18_500_000, 137_000.0), (23_500_000, -2_310_000.0),
            (28_500_000, 4_300_000.0), (block - 60_000, -9_100_000.0),
            (38_500_000, 10_200_000.0), (43_500_000, 1_020_000.0),
            (48_500_000, 4_150_000.0), (53_500_000, -4_400_000.0),
            (60_000_000, 3_050_000.0), (66_000_000, -700_000.0)]
    bursts = []
    for start, off in plan:
        n_bits = 500 if 4e6 < off < 4.5e6 else 300
        bits = rng.integers(0, 2, n_bits + 8).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, fs, off), start,
                        snr_db=float(rng.uniform(22.0, 32.0)))
        bursts.append((start, off, bits[:n_bits]))
    return cap, bursts


def wideband_phase(dev, tmp) -> dict:
    """A 25 MHz capture file through `Pipeline.run_file` on the card
    (after a warm-up decode that captures the group graphs): the scan
    resolves to the scan kernel (F = 32768: a cluster of 4 blocks), which
    launches, decimation 100 takes the window gather, and every injected
    payload comes back bit-exact."""
    import gc
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools.captures import write_cf32

    t = time.perf_counter()
    cap, bursts = wideband_capture(np.random.default_rng(SEED + 9))
    path = os.path.join(tmp, "capture_25mhz.cf32")
    write_cf32(path, cap)
    make_s = time.perf_counter() - t
    seconds = len(cap) / WIDE["sample_rate"]
    det = DetectorConfig(**WIDE)
    pipe = Pipeline(det_cfg=det, start_time_ns=T0, device=dev,
                    want_llr=False)
    if pipe.detect_impl != "scan":
        raise AssertionError(f"25 MHz resolved to {pipe.detect_impl}")
    t = time.perf_counter()
    list(pipe.run_file(path))
    warmup_s = time.perf_counter() - t
    pipe.reset(T0)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    if (counts["window_gather"] == 0 or counts["detect_scan"] == 0
            or counts["fused_frontend"] != 0):
        raise AssertionError(f"25 MHz decode launches: {counts}")
    missing = missing_payloads(frames, bursts, det)
    if missing:
        raise AssertionError(f"25 MHz payloads not decoded bit-exact: "
                             f"{missing}")
    st, timing = pipe.stats, dict(pipe.timing)
    res = dict(phase="wideband_25mhz", fft_size=pipe.p.fft_size,
               detect_impl=pipe.detect_impl, decimation=pipe.dmp.decimation,
               capture_s=seconds, make_s=make_s, warmup_s=warmup_s,
               wall_s=wall, realtime_x=seconds / wall, injected=len(bursts),
               payloads_bit_exact=len(bursts), detected=st.n_detected,
               ok=st.n_ok, raw_lines=len(frames), stages=timing,
               launches=counts)
    del pipe, frames
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---- wideband_400mhz: F = 524288, the scan kernel as a grid of clusters ----

# the 400 MHz decode's batches: every burst at 400 MHz takes the large
# class (its window, pre + post + burst, is longer than the small classes'
# 120,000 samples beyond pre + post), 24 windows of 45 M samples a round;
# one block a group, one job a class
WIDE_400_RUN = dict(burst_batch=16, agg_blocks=1, group_jobs=1)


def wideband_400_capture(dev, path: str) -> tuple[float, list, float]:
    """`captures.wideband_400mhz_plan` written to `path` as ci8, chunk by
    chunk (a 400 MHz block is 537 M samples). Returns the capture's
    seconds, the injected (start, offset Hz, payload bits) and the
    seconds it took to make."""
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.tools import captures
    t = time.perf_counter()
    p = DetectorConfig(**captures.WIDE_400).derived()
    n, plan = captures.wideband_400mhz_plan(SEED + 12, p.block_samples)
    captures.write_ci8(path, n, plan, SEED + 12, dev)
    return (n / p.sample_rate, [(s, o, b) for s, o, b, _, _ in plan],
            time.perf_counter() - t)


# a decode of the 400 MHz capture at the Pipeline's default batches, in a
# process of its own (an allocation that fails inside a graph capture
# leaves the process's stream unusable): its frames' frequencies and bits
# and its peak device memory, or the allocation that failed
DEFAULTS_DECODE = """
import json, sys, numpy as np, torch
sys.path.insert(0, {here!r})
from iridium_tpu_torch.config import DetectorConfig
from iridium_tpu_torch.runtime.pipeline import Pipeline
from iridium_tpu_torch.tools import captures
pipe = Pipeline(det_cfg=DetectorConfig(**captures.WIDE_400), device="cuda",
                want_llr=False, start_time_ns=0)
try:
    frames = [dict(frequency=float(f["frequency"]),
                   bits="".join(map(str, np.asarray(f["bits"]).tolist())))
              for f in pipe.run_file({path!r})]
    out = dict(fits=True, raw_lines=len(frames), frames=frames)
except torch.OutOfMemoryError as e:
    out = dict(fits=False, error=str(e).splitlines()[0][:300])
out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
print(json.dumps(out))
"""


def defaults_fit(path: str, bursts, det) -> dict:
    """Whether the 400 MHz decode fits the card at the Pipeline's default
    batches (burst_batch 128, agg_blocks 4, group_jobs 8): a measurement,
    not a check, of which only running out of device memory is an
    answer. Any other failure of the decode raises, and so does a decode
    that fits and misses one of `bursts`' payloads."""
    res = subprocess.run(
        [sys.executable, "-c", DEFAULTS_DECODE.format(here=HERE, path=path)],
        capture_output=True, text=True, timeout=300)
    last = (res.stdout.strip().splitlines() or [""])[-1]
    try:
        out = json.loads(last)
    except json.JSONDecodeError:
        out = None
    if res.returncode != 0 or not isinstance(out, dict):
        raise AssertionError(f"400 MHz decode at the default batches "
                             f"failed (rc {res.returncode}): "
                             f"{res.stderr.strip()[-600:]}")
    if out["fits"]:
        frames = [dict(frequency=f["frequency"],
                       bits=[int(c) for c in f["bits"]])
                  for f in out.pop("frames")]
        out["missing"] = missing_payloads(frames, bursts, det)
        if out["missing"]:
            raise AssertionError(f"400 MHz decode at the default batches: "
                                 f"payloads not bit-exact: {out}")
    return out


def wideband_400_phase(dev, tmp) -> dict:
    """A 400 MHz capture (F = 524288, 1,024 frames a block, decimation
    1,600) through `Pipeline.run_file` on the card at WIDE_400_RUN (the
    default batches are measured apart, `defaults_fit`), after a warm-up
    decode that captures the group graphs: the scan
    resolves to the kernel's grid of 4 clusters of 16 blocks, which
    launches, decimation 1,600 takes the window gather and not the fused
    front-end, and every injected payload comes back bit-exact. Wall,
    realtime factor, stages, peak device memory and launches."""
    import gc
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools import captures

    path = os.path.join(tmp, "capture_400mhz.ci8")
    seconds, bursts, make_s = wideband_400_capture(dev, path)
    det = DetectorConfig(**captures.WIDE_400)
    pipe = Pipeline(det_cfg=det, start_time_ns=T0, device=dev,
                    want_llr=False, **WIDE_400_RUN)
    if pipe.detect_impl != "scan":
        raise AssertionError(f"400 MHz resolved to {pipe.detect_impl}")
    t = time.perf_counter()
    list(pipe.run_file(path))
    warmup_s = time.perf_counter() - t
    pipe.reset(T0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if (counts["window_gather"] == 0 or counts["detect_scan"] == 0
            or counts["fused_frontend"] != 0):
        raise AssertionError(f"400 MHz decode launches: {counts}")
    missing = missing_payloads(frames, bursts, det)
    st, timing = pipe.stats, dict(pipe.timing)
    res = dict(phase="wideband_400mhz", fft_size=pipe.p.fft_size,
               layout=list(detect_scan.layout(pipe.p.fft_size)),
               detect_impl=pipe.detect_impl, decimation=pipe.dmp.decimation,
               args=WIDE_400_RUN, classes=[[c.batch, c.l_win]
                                           for c in pipe.classes],
               capture_s=seconds, make_s=make_s, warmup_s=warmup_s,
               wall_s=wall, realtime_x=seconds / wall,
               peak_device_gb=peak,
               injected=len(bursts), missing=missing,
               payloads_bit_exact=len(bursts) - len(missing),
               detected=st.n_detected, ok=st.n_ok, raw_lines=len(frames),
               stages=timing, launches=counts)
    del pipe, frames
    gc.collect()
    torch.cuda.empty_cache()
    if missing:
        raise AssertionError(f"400 MHz payloads not decoded bit-exact: "
                             f"{missing} ({res})")
    res["defaults"] = defaults_fit(path, bursts, det)
    os.remove(path)
    return res


WIDE_1600_RUN = WIDE_400_RUN
# windows of the 1.6 GHz large class held to the plain gather (its index
# and output are ~3x the windows' bytes: 4 windows of 180 M samples)
WIDE_1600_GATHER_WINDOWS = 4
# the block of the 1.6 GHz warm-up decode whose scan inputs are kept and
# held to the plain scan: the fourth, the first two having primed the
# history, in which two bursts end and the one across sample 2^31 begins
WIDE_1600_CHECK_BLOCK = 3


def check_decode_block(kept: dict, p, dev) -> dict:
    """The scan kernel on the 1.6 GHz decode's own block (its |X|^2 rows,
    256 x 2,097,152, and the primed state the decode handed the scan,
    kept on the host), against the plain scan on the same inputs:
    bit-equal, dB fields within rtol 1e-5; timed with its bound."""
    import torch
    from iridium_tpu_torch.dsp import detect_scan
    from iridium_tpu_torch.tools import exp_scan

    mag2, s0, nv = kept["mag2"].to(dev), _to(kept["state"], dev), \
        kept["n_valid"]
    if int(s0.ints[1]) < p.history_size:
        raise AssertionError("1.6 GHz decode block: the history is not "
                             "primed")
    got = detect_scan.scan(mag2, s0, nv, p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = detect_scan.scan_plain(mag2, s0, nv, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = exp_scan.compare(got, want)
    res = dict(gone=int(got.g_count), tagged=int(got.n_tagged),
               active=int(got.a_valid.sum()))
    if res["gone"] + res["active"] < 1:
        raise AssertionError(f"1.6 GHz decode block: no burst in it {res}")
    del got, want
    ms = time_ms(lambda: detect_scan.scan(mag2, s0, nv, p))
    b_ms, b_by = scan_bound(p)
    lay = detect_scan.layout(p.fft_size)
    return dict(input=f"wideband_1600mhz decode, block "
                      f"{WIDE_1600_CHECK_BLOCK}",
                shape=[p.frames_per_block, p.fft_size], layout=list(lay),
                tiles=lay[5], history_size=p.history_size, n_valid=nv,
                ms=ms, us_per_frame=ms * 1e3 / p.frames_per_block,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms, max_abs_err=err, **res)


def wideband_1600_phase(dev, tmp) -> dict:
    """A 1.6 GHz capture (F = 2,097,152, 256 frames a block, decimation
    6,400; six blocks, 2.01 s) written as ci8 chunk by chunk, through
    `Pipeline.run_file` on the card at WIDE_1600_RUN, after a warm-up
    decode: the scan resolves to the kernel's tiled grid (7 clusters of 16
    blocks of 2 tiles), which launches, decimation 6,400 takes the window
    gather (the large class in slices of windows) and not the fused
    front-end, and every injected payload comes back bit-exact. Wall,
    realtime factor, stages, peak device memory, class shapes and
    launches, and the class batches of its demod loop (which `check_demod`
    holds at the same batches). Then the scan kernel on the warm-up
    decode's block WIDE_1600_CHECK_BLOCK (`check_decode_block`) and the
    window gather at the large class's window length
    (WIDE_1600_GATHER_WINDOWS windows of the group's stream), held to
    their plain versions (in the `kernels` line)."""
    import gc
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.dsp import detect_scan
    from iridium_tpu_torch.runtime.pipeline import Pipeline
    from iridium_tpu_torch.tools import captures
    from iridium_tpu_torch.tools import exp_window_gather as wg_tool

    path = os.path.join(tmp, "capture_1600mhz.ci8")
    t = time.perf_counter()
    det = DetectorConfig(**captures.WIDE_1600)
    p = det.derived()
    n, plan = captures.wideband_1600mhz_plan(SEED + 16, p.block_samples)
    captures.write_ci8(path, n, plan, SEED + 16, dev)
    bursts = [(s0, o, b) for s0, o, b, _, _ in plan]
    del plan
    make_s, seconds = time.perf_counter() - t, n / p.sample_rate
    pipe = Pipeline(det_cfg=det, start_time_ns=T0, device=dev,
                    want_llr=False, **WIDE_1600_RUN)
    if pipe.detect_impl != "scan" or detect_scan.tiles(p.fft_size) < 2:
        raise AssertionError(f"1.6 GHz resolved to {pipe.detect_impl}, "
                             f"layout {detect_scan.layout(p.fft_size)}")
    # the warm-up keeps one block's scan inputs on the host
    kept, calls, scan = {}, [0], detect_scan.scan

    def keep(mag2, state, n_valid, p_):
        if calls[0] == WIDE_1600_CHECK_BLOCK:
            kept.update(mag2=mag2.cpu(), state=_to(state, "cpu"),
                        n_valid=int(n_valid))
        calls[0] += 1
        return scan(mag2, state, n_valid, p_)

    detect_scan.scan = keep
    try:
        t = time.perf_counter()
        list(pipe.run_file(path))
        warmup_s = time.perf_counter() - t
    finally:
        detect_scan.scan = scan
    if not kept:
        raise AssertionError(f"1.6 GHz warm-up: {calls[0]} scans")
    pipe.reset(T0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    os.remove(path)
    if (counts["window_gather"] == 0 or counts["detect_scan"] == 0
            or counts["fused_frontend"] != 0):
        raise AssertionError(f"1.6 GHz decode launches: {counts}")
    missing = missing_payloads(frames, bursts, det)
    stats, timing = pipe.stats, dict(pipe.timing)
    large = pipe.classes[2]
    gather_shape = dict(rate_mhz=1600.0, shape="large",
                        B=WIDE_1600_GATHER_WINDOWS, l_win=large.l_win,
                        decim=large.decim, n_stream=pipe.stream_len,
                        fused=False)
    demod_batches = [[c.batch, c.downmix.max_frame_cap, c.demod.S]
                     for c in pipe.classes]
    downmix_batches = [[c.batch, c.dec_cap] for c in pipe.classes]
    res = dict(phase="wideband_1600mhz", fft_size=p.fft_size,
               layout=list(detect_scan.layout(p.fft_size)),
               detect_impl=pipe.detect_impl, decimation=pipe.dmp.decimation,
               args=WIDE_1600_RUN, classes=[[c.batch, c.l_win]
                                            for c in pipe.classes],
               capture_s=seconds, make_s=make_s, warmup_s=warmup_s,
               wall_s=wall, realtime_x=seconds / wall,
               peak_device_gb=peak,
               injected=len(bursts), missing=missing,
               payloads_bit_exact=len(bursts) - len(missing),
               detected=stats.n_detected, ok=stats.n_ok,
               raw_lines=len(frames), stages=timing, launches=counts,
               demod_batches=demod_batches, downmix_batches=downmix_batches)
    del pipe, frames
    gc.collect()
    torch.cuda.empty_cache()
    if missing:
        raise AssertionError(f"1.6 GHz payloads not decoded bit-exact: "
                             f"{missing} ({res})")
    res["kernel_rows"] = dict(
        detect_scan=[check_decode_block(kept, p, dev)],
        window_gather=wg_tool.run_shape(
            gather_shape, dev, [("package", _kernels.WINDOW_GATHER)]))
    torch.cuda.empty_cache()
    return res


# ---- ingest: the native reader against the Python reader ----

STAGES = ("read", "step_dispatch", "group_dispatch", "result_fetch_wait",
          "host_parse")        # host_format is inside host_parse


def ingest_phase(dev, pipe, path: str, lines: list, seconds: float) -> dict:
    """The dense capture file (8 production blocks) through the native
    reader (`Pipeline.run_file`: a C++ thread converting into pinned
    buffers) and through `readers.read_blocks` (numpy, then a copy into
    the pipeline's pinned upload buffer), on the dense phase's warm
    pipeline, after one plain read of the file so that both find it in the
    page cache: blocks/s of each reader alone, the decode's wall, realtime
    and `read` seconds, and the share of the wall no stage counts. Both
    decodes give the dense phase's lines."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.io import native, readers
    from iridium_tpu_torch.output.raw import RawPrinter

    with open(path, "rb") as f:
        while f.read(1 << 26):
            pass
    bs = pipe.p.block_samples
    sources = {
        "native": (lambda: native.read_blocks(path, bs, None, dev),
                   lambda: pipe.run_file(path)),
        "python": (lambda: readers.read_blocks(path, bs),
                   lambda: (f for fr in pipe.run_blocks(
                       readers.read_blocks(path, bs)) for f in fr))}
    res, counts = dict(phase="ingest", capture_s=seconds), {}
    for name, (alone, decode) in sources.items():
        t = time.perf_counter()
        n = sum(1 for _ in alone())
        alone_s = time.perf_counter() - t
        pipe.reset(T0)
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t = time.perf_counter()
        printer = RawPrinter()
        got = [printer.format(f) for f in decode()]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for k in _kernels.KERNELS:
            counts[k.name] = counts.get(k.name, 0) + k.launches
        if got != lines:
            raise AssertionError(f"ingest: {name} reader gives other lines "
                                 f"({len(got)} against {len(lines)})")
        timing = dict(pipe.timing)
        res[name] = dict(
            reader_blocks_per_s=n / alone_s, wall_s=wall,
            realtime_x=seconds / wall, read_s=timing["read"],
            uncounted_share=1.0 - sum(timing[k] for k in STAGES) / wall,
            stages=timing)
    res.update(lines=len(lines), lines_equal=True, launches=counts)
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        import iridium_tpu_torch
    except ImportError:
        return fail("the iridium_tpu_torch package is not beside this "
                    "script")
    if not os.path.abspath(iridium_tpu_torch.__file__).startswith(HERE):
        return fail("iridium_tpu_torch was not imported from this checkout")
    from iridium_tpu_torch import _kernels, device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    dev = device.resolve("cuda")
    from iridium_tpu_torch.tools import exp_scan
    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"build: {len(_kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    card = smi.stdout.strip()
    clock = [time.perf_counter()]
    def emit(res: dict) -> dict:
        """Print a phase's line with the card and the phase's seconds."""
        now = time.perf_counter()
        print(json.dumps(dict(res, card=card, phase_s=now - clock[0])),
              flush=True)
        clock[0] = now
        return res

    rows = kernel_phase(dev, card)
    clock[0] = time.perf_counter()
    # the scan's `ptxas -v` report, kept by its build
    shp = emit(scan_shapes_phase(dev, exp_scan.spill_table(
        exp_scan.ptxas_report(_kernels.DETECT_SCAN))))
    shapes = shp["odd"] + shp["wide"] + shp["tiled"]
    rows[0]["detail"]["per_shape"] += shapes
    rows[0]["detail"]["ptxas"] = shp["ptxas"]
    rows[0]["max_abs_err"] = max([rows[0]["max_abs_err"]]
                                 + [w["max_abs_err"] for w in shapes])
    fc = emit(detect_fast_card_phase(dev))
    fast_row = next(r for r in rows if r["name"] == "detect_fast")
    fast_row["detail"]["per_shape"] += fc["per_shape"]
    fast_row["detail"]["bit_equal"] = all(
        r["bit_equal"] for r in fast_row["detail"]["per_shape"])
    fast_row["max_abs_err"] = max(r["max_abs_err"]
                                  for r in fast_row["detail"]["per_shape"])
    with tempfile.TemporaryDirectory() as tmp:
        dec, ctx = decode_phase(dev, tmp)
        emit(dec)
        emit(profile_phase(ctx["pipe"], ctx["path"], dec["wall_s"]))
        emit(group_oracle_phase(ctx["pipe"], ctx["path"], ctx["lines"]))
        single = dict(path=ctx["path"], lines=ctx["lines"],
                      bursts=ctx["bursts"], wall_s=dec["wall_s"],
                      capture_s=dec["capture_s"])
        del ctx
        fast = emit(decode_fast_phase(dev, single))
        gat = emit(gather_phase(dev, tmp))
        mesh = emit(mesh_phase(dev, tmp, single))
        emit(demod_phase(dev))
        par = emit(parsed_phase(dev, tmp))
        tool = emit(tool_phase(dev))
        den, ctx = dense_phase(dev, tmp)
        emit(den)
        ing = emit(ingest_phase(dev, **ctx))
        del ctx
        wide = emit(wideband_phase(dev, tmp))
        w400 = emit(wideband_400_phase(dev, tmp))
        w1600 = emit(wideband_1600_phase(dev, tmp))
    # the 1.6 GHz decode's scan and gather checks join the kernels'; its
    # demod loop batches are those check_demod held
    for name in ("demod_loop", "demod_tail"):
        dm_row = next(r for r in rows if r["name"] == name)
        held = {(r["B"], r["L"], r["S"])
                for r in dm_row["detail"]["per_shape"]
                if r["rate_mhz"] == 1600.0}
        if {tuple(b) for b in w1600["demod_batches"]} != held:
            return fail(f"the 1.6 GHz decode's demod batches "
                        f"{w1600['demod_batches']} are not those {name} "
                        f"held: {held}")
    for name in ("downmix_fir", "downmix_chain"):
        dm_rows = next(r for r in rows if r["name"] == name)
        held = {(r["B"], r["L"]) for r in dm_rows["detail"]["per_shape"]
                if r["rate_mhz"] == 1600.0}
        if {tuple(b) for b in w1600["downmix_batches"]} != held:
            return fail(f"the 1.6 GHz decode's downmix batches "
                        f"{w1600['downmix_batches']} are not those {name} "
                        f"held: {held}")
    for r in rows:
        extra = w1600["kernel_rows"].get(r["name"])
        if extra:
            r["detail"]["per_shape"] += extra
        if r["name"] == "detect_scan" and extra:
            r["max_abs_err"] = max([r["max_abs_err"]]
                                   + [e["max_abs_err"] for e in extra])
    paths = (dec, fast, gat, mesh, par, tool, den, ing, wide, w400, w1600)
    fast_row["detail"]["split_launches_by_path"] = {
        mesh["phase"]: mesh["split_launches"]}
    for r in rows:
        by_path = {ph["phase"]: ph["launches"][r["name"]] for ph in paths}
        r["launches"] = sum(by_path.values())
        r["detail"]["launches_by_path"] = by_path
        if r["launches"] == 0:
            return fail(f"{r['name']} was launched on no path")
        # the downmix and the demodulator run on every decode path
        if r["name"] in ("demod_loop", "downmix_fir", "downmix_chain",
                         "demod_tail") and not all(
                n for ph, n in by_path.items() if ph != tool["phase"]):
            return fail(f"{r['name']} was not launched on every decode "
                        f"path: {by_path}")
        # the calls checked inside the decodes' graphs (ReplayCheck)
        for ph in paths:
            c = ph.get("kernel_checks", {}).get(r["name"])
            if c:
                r["detail"].setdefault("path_checks", {})[ph["phase"]] = c
                r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
    if "jax" in sys.modules or "iridium_tpu" in sys.modules:
        return fail("JAX or the JAX package was imported")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
