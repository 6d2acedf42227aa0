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
     front-end at the three burst classes' shapes, within max |err| 1e-5;
     the block gather single-call and chained, at R = 64, 128, 256);
  3. the offline RAW decode at the production 10 MHz configuration: a
     synthetic capture file through `Pipeline.run_file` (no LLRs) and
     `RawPrinter`, every injected payload bit-exact, scan and fused
     front-end launched; then the same decode under torch.profiler
     (device time, idle share);
  4. a short 1 MHz decode (decimation 4, so the window-gather path),
     whose gather launches are checked against the plain gather, and the
     per-symbol demod loop alone at a 256-burst batch;
  5. the protocol decode at the production 10 MHz configuration: a
     capture with injected IRA, IBC and IDA frames (one ACARS SBD message
     over two IDA bursts) through the pipeline with LLRs and the CLI's
     decoders; every IDA payload, the ACARS text and the IRA ids come
     back, and the unpacked LLRs are within one quantum of the f32 LLRs;
  6. the block-gather sweep tool (`iridium_tpu_torch.tools.
     exp_block_gather`) on the card, its sum check passing;
  7. the `kernels` JSON line: every kernel with its launches on the
     paths above (counts reset before each path and read after it), its
     times and its bound.
Every printed number names the card (`card`: nvidia-smi's name and
power limit). The last line is the JSON result. Any failed check exits
non-zero; with no CUDA device, or without the port's package beside this
script, it fails before printing a result. It imports nothing of JAX.
"""

from __future__ import annotations

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
    F, H = p.fft_size, p.history_size
    state_bytes = 4 * (H * F + 9 * F)
    n_bytes = 4 * F * p.frames_per_block + 2 * state_bytes
    b_ms, b_by = bound(n_bytes, 0)
    return dict(name="detect_scan", route="cuda",
                source="iridium_tpu_torch/csrc/detect_scan.cu",
                replaces="iridium_tpu/dsp/detect_pallas.py:152",
                max_abs_err=err, ms=per_input[0]["ms"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                detail=dict(card=card, per_input=per_input))


# the fused front-end's agreement with fused_plain: its 3xTF32 products
# are f32-grade (~1.3e-6 on the card); one TF32 pass is ~1e-4 off
FUSED_MAX_ERR = 1e-5


def check_fused(dev, card: str) -> dict:
    """The fused front-end at the three burst classes' shapes of the
    10 MHz decode (`tools/exp_frontend.py`: 256 x 327,680; 48 x 327,680;
    48 x 1,126,400), each held to `fused_plain` within max |err| 1e-5 and
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
                           tool.STREAM_10MHZ, phases=False)[0]
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


def check_gather(dev, F, B, l_win, card: str) -> dict:
    import torch
    from iridium_tpu_torch.ops import window_gather as wg
    from iridium_tpu_torch.tools import exp_frontend as tool

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    planes, starts2, _ = tool.frontend_inputs(dev, gen, B, l_win, F,
                                              tool.STREAM_10MHZ)
    got = wg.gather(planes, starts2, l_win)
    want = wg.gather_plain(planes, starts2, l_win)
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError("window_gather: not bit-equal to plain")
    ms = time_ms(lambda: wg.gather(planes, starts2, l_win))
    plain_ms = time_ms(lambda: wg.gather_plain(planes, starts2, l_win),
                       reps=3)
    idx = (starts2[:, 0].long() * wg.ALIGN + starts2[:, 1].long())[:, None] \
        + torch.arange(l_win, device=dev)
    lib_ms = time_ms(lambda: planes[:, idx], reps=3)
    n_bytes = (8 * tool.covered_samples(starts2, l_win, planes.shape[1])
               + 8 * B * l_win)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(name="window_gather", route="cuda",
                source="iridium_tpu_torch/csrc/window_gather.cu",
                replaces="iridium_tpu/ops/window_gather.py:55",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, detail=dict(card=card))


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


def kernel_phase(dev, card: str) -> list[dict]:
    from iridium_tpu_torch.config import DetectorConfig

    p = DetectorConfig(sample_rate=10_000_000, frames_per_block=2048,
                       gone_capacity=2048).derived()
    B, l_win = 256, 327_680
    rows = [check_scan(p, dev, card),
            check_fused(dev, card),
            check_gather(dev, p.fft_size, B, l_win, card),
            check_block_gather(dev, card)]
    for r in rows:
        print("kernel_check " + json.dumps(r), flush=True)
    return rows


# ---- phases 3 and 4: the offline decode through Pipeline.run_file ----

PROD = dict(sample_rate=10_000_000, frames_per_block=2048,
            gone_capacity=2048)


def production_capture(rng):
    """Three blocks of 10 MHz noise (the last one partial) with 13 DL
    bursts:
    two in the simplex band with frames longer than the normal band
    allows, one straddling the first block boundary. Returns the capture
    and the injected (start, offset Hz, payload bits). (UL bursts are left
    out: the reference's uw_start arithmetic rejects them, and so does
    the port; test_e2e.py's test_ul_burst_rejected_like_reference.)"""
    from iridium_tpu_torch.io import synth
    fs = PROD["sample_rate"]
    block = PROD["frames_per_block"] * 8192
    total = 2 * block + 4_000_000
    cap = synth.noise(total, seed=SEED)
    plan = [(5_000_000, 137_000.0), (6_900_000, -2_310_000.0),
            (8_800_000, 4_300_000.0), (10_700_000, 1_020_000.0),
            (12_600_000, -4_400_000.0), (14_500_000, 3_050_000.0),
            (block - 30_000, -220_000.0), (19_000_000, 4_650_000.0),
            (21_500_000, -1_480_000.0), (24_000_000, 2_270_000.0),
            (26_500_000, -3_330_000.0), (29_000_000, 620_000.0),
            (31_500_000, -880_000.0)]
    bursts = []
    for start, off in plan:
        n_bits = 500 if off > 4e6 else 300
        # 8 guard bits after the payload: the end-of-frame magnitude drop
        # (qpsk_demod.c:199-260) may trim the last symbols on the ramp
        bits = rng.integers(0, 2, n_bits + 8).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, fs, off), start,
                        snr_db=float(rng.uniform(22.0, 32.0)))
        bursts.append((start, off, bits[:n_bits]))
    return cap, bursts


def write_cf32(path, cap):
    np.ascontiguousarray(cap, np.complex64).view(np.float32).tofile(path)


def decode_phase(dev, tmp) -> dict:
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.io import synth
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime.pipeline import Pipeline

    cap, bursts = production_capture(np.random.default_rng(SEED))
    path = os.path.join(tmp, "capture_10mhz.cf32")
    write_cf32(path, cap)
    seconds = len(cap) / PROD["sample_rate"]
    det = DetectorConfig(**PROD)
    t0 = 1_700_000_000_000_000_000
    # warm-up decode (cuFFT plans, allocator); then the counted run
    list(Pipeline(det_cfg=det, start_time_ns=t0, device=dev,
                  want_llr=False).run_file(path))
    pipe = Pipeline(det_cfg=det, start_time_ns=t0, device=dev,
                    want_llr=False)
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
    missing = []
    for start, off, bits in bursts:
        exp = synth.expected_bits(bits, "DL")
        hit = [f for f in frames
               if len(f["bits"]) >= len(exp)
               and np.array_equal(np.asarray(f["bits"][:len(exp)]), exp)
               and abs(f["frequency"] - (det.center_frequency + off)) < 2e3]
        if not hit:
            missing.append((start, off))
    if missing:
        raise AssertionError(f"payloads not decoded bit-exact: {missing}")
    st = pipe.stats
    return dict(phase="decode_10mhz", capture_s=seconds, wall_s=wall,
                realtime_x=seconds / wall, raw_lines=len(lines),
                raw_per_s=len(lines) / wall, injected=len(bursts),
                detected=st.n_detected, ok=st.n_ok,
                ok_pct=100.0 * st.n_ok / max(st.n_detected, 1),
                stages=dict(pipe.timing), launches=counts, path=path)


def profile_phase(dev, path: str, wall_s: float) -> dict:
    """The same 10 MHz decode under torch.profiler: device time summed
    over kernels and copies, the number of device operations, and the
    device's idle share against the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.runtime.pipeline import Pipeline

    pipe = Pipeline(det_cfg=DetectorConfig(**PROD), start_time_ns=0,
                    device=dev, want_llr=False)
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


def gather_phase(dev, tmp) -> dict:
    """1 MHz (decimation 4): the fused shape is unsupported, so the
    pipeline gathers windows; every gather it launches is checked
    against the plain gather on the same stream."""
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.io import synth
    from iridium_tpu_torch.ops import window_gather as wg
    from iridium_tpu_torch.runtime import pipeline as pl

    bits = np.random.default_rng(SEED + 3).integers(0, 2, 300).astype(
        np.uint8)
    cap = synth.make_capture(bits, sample_rate=1_000_000,
                             freq_offset_hz=100_000.0, snr_db=30.0)
    path = os.path.join(tmp, "capture_1mhz.cf32")
    write_cf32(path, cap)
    calls = []
    kernel_gather = wg.gather

    def recording(planes, starts2, l_win):
        out = kernel_gather(planes, starts2, l_win)
        calls.append((planes, starts2, l_win, out))
        return out

    pipe = pl.Pipeline(det_cfg=DetectorConfig(sample_rate=1_000_000),
                       start_time_ns=0, device=dev, want_llr=False)
    _kernels.reset_counts()
    pl.window_gather.gather = recording
    try:
        list(pipe.run_file(path))
    finally:
        pl.window_gather.gather = kernel_gather
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _kernels.KERNELS}
    if counts["window_gather"] == 0 or counts["detect_scan"] == 0:
        raise AssertionError(f"1 MHz decode launches: {counts}")
    if counts["fused_frontend"] != 0:
        raise AssertionError("1 MHz decode took the fused path")
    for planes, starts2, l_win, out in calls:
        want = wg.gather_plain(planes, starts2, l_win)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError("pipeline gather differs from plain")
    return dict(phase="decode_1mhz", detected=pipe.stats.n_detected,
                gathers_checked=len(calls), launches=counts)


def demod_phase(dev) -> dict:
    """The per-symbol demod loop alone, at the small-normal class's batch
    (256 bursts, 205 symbols): the time the Python symbol loop costs."""
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
    dm = demod.Demod(S, 10.0)
    ms = time_ms(lambda: dm(xt, n, direc), reps=3)
    return dict(phase="demod_loop", batch=B, symbols=S, ms=ms)


# ---- phase 5: the protocol decode (--parsed, ACARS) at 10 MHz ----

ACARS_TEXT = b"SMOKE TEST 1"


def frames_capture(rng):
    """Three production blocks of 10 MHz noise (the last one partial)
    with IRA and IBC frames in the simplex band and IDA frames in the
    duplex band: five single-burst messages (one straddling the first
    block boundary) and one ACARS SBD message over two IDA bursts 90 ms
    apart on one channel. Returns the capture and what was injected."""
    from iridium_tpu_torch.io import synth, synth_frames as sf
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
    reassembler and decoder. Every packed batch is recorded, and its
    unpacked LLRs are held against the demod's f32 LLRs."""
    import io
    import torch
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.decode import batch, ida as ida_mod, sbd_acars
    from iridium_tpu_torch.io import readers
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime import pipeline as pl

    cap, want = frames_capture(np.random.default_rng(SEED + 7))
    path = os.path.join(tmp, "frames_10mhz.cf32")
    write_cf32(path, cap)
    seconds = len(cap) / PROD["sample_rate"]
    det = DetectorConfig(**PROD)
    packed = []
    kernel_pack = pl.pack_outputs

    def recording(dm, dd, s2_pad, want_llr):
        out = kernel_pack(dm, dd, s2_pad, want_llr)
        packed.append((dd.llr, out, s2_pad // 2))
        return out

    def decode():
        pipe = pl.Pipeline(det_cfg=det, start_time_ns=1_700_000_000 * 10**9,
                           device=dev, want_llr=True)
        printer, reasm = RawPrinter(), ida_mod.IdaReassembler()
        acars = sbd_acars.AcarsDecoder(json_out=True, text_out=io.StringIO(),
                                       station="SMOKE")
        lines, decoded = [], []
        for frames in pipe.run_blocks(readers.read_blocks(
                path, pipe.p.block_samples)):
            for f, (d, b) in zip(frames, batch.decode_block(frames)):
                lines.append(printer.format_ida(b) if b is not None
                             else printer.format(f))
                if d is not None:
                    decoded.append(d)
                if b is not None:
                    reasm.push(b, acars.process)
                reasm.flush(f["timestamp_ns"])
        return pipe, lines, decoded, acars

    decode()                                   # warm-up
    torch.cuda.synchronize()
    _kernels.reset_counts()
    pl.pack_outputs = recording
    try:
        t = time.perf_counter()
        pipe, lines, decoded, acars = decode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        pl.pack_outputs = kernel_pack
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
    for llr, out, ms in packed:
        u = pl.unpack_outputs(out.cpu().numpy(), ms, True)["llr"]
        f32 = llr.cpu().numpy()
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
                launches=counts)


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
    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"build: {len(_kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    card = smi.stdout.strip()
    rows = kernel_phase(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        dec = decode_phase(dev, tmp)
        path = dec.pop("path")
        print(json.dumps(dict(dec, card=card)), flush=True)
        print(json.dumps(dict(profile_phase(dev, path, dec["wall_s"]),
                              card=card)), flush=True)
        gat = gather_phase(dev, tmp)
        print(json.dumps(dict(gat, card=card)), flush=True)
        print(json.dumps(dict(demod_phase(dev), card=card)), flush=True)
        par = parsed_phase(dev, tmp)
        print(json.dumps(dict(par, card=card)), flush=True)
    tool = tool_phase(dev)
    print(json.dumps(dict(tool, card=card)), flush=True)
    for r in rows:
        r["launches"] = sum(ph["launches"][r["name"]]
                            for ph in (dec, gat, par, tool))
        if r["launches"] == 0:
            return fail(f"{r['name']} was launched on no path")
    if "jax" in sys.modules or "iridium_tpu" in sys.modules:
        return fail("JAX or the JAX package was imported")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
