"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics and the check against the plain reference.

The window drives the port's `Pipeline.run_blocks` in a closed loop: the
next block (a complex64 tensor in pinned host memory, as the port's file
reader hands it over) is handed over when `run_blocks` asks for it, and
every yielded frame is formatted by the port's `RawPrinter`, as its CLI
does. The stream starts with the set-up's warm pass over the cell's pool
of blocks and is never reset: the window continues it, cycling through
the pool, past 2^31 and 2^32 samples.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

import compare
import devtrace
import traffic
from reference import decode as ref_decode
from reference import scan as ref_scan

# the stream's clock: a fixed start, so that every run prints the same
# timestamps
START_NS = 1_700_000_000_000_000_000
# `run_blocks`' depth, as the CLI runs it
DEPTH = 3
# window blocks the reference checks besides the stream's first block: the
# blocks handed over at seed-drawn times in these parts of the window (one:
# the check takes ~4 s a block at 10 MHz, and stays shorter than the
# window)
SAMPLE_PARTS = ((0.05, 0.95),)
FORBIDDEN = ("jax", "jaxlib", "flax", "iridium_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    per_layer: list      # names of the per-layer metrics this cell reports
    limits: dict


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Held:
    """Wraps the pipeline's detect step to keep copies of the detector
    states the reference check needs: the input of each checked block's
    scan, and the state after it (the next block's rebase changes that
    state in place)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.inner = pipe._detect
        self.k = 0                 # blocks detected so far in the stream
        self.want_in: set = set()
        self.want_out: set = set()
        self.states_in: dict = {}
        self.states_out: dict = {}
        pipe._detect = self

    def __call__(self, x, st, n_valid, window):
        k = self.k
        self.k += 1
        if k in self.want_in:
            self.states_in[k] = st.clone()
        out = self.inner(x, st, n_valid, window)
        if k in self.want_out:
            self.states_out[k] = out.clone()
        return out

    def check_block(self, k: int) -> None:
        self.want_in.add(k)
        self.want_out.add(k)


def add_spans(pipe) -> None:
    """`record_function` spans around the calls into the program's
    layers, for the device trace's attribution."""
    rf = torch.profiler.record_function
    for attr, name in (("_dispatch_step", "bench.step"),
                       ("_dispatch_group", "bench.group"),
                       ("_finish_group", "bench.finish")):
        inner = getattr(pipe, attr)

        def wrapped(*a, _inner=inner, _name=name):
            with rf(_name):
                return _inner(*a)
        setattr(pipe, attr, wrapped)


class FrontendProbe:
    """After each round of the group program, copies the routing's window
    starts and class counts to pinned host memory (traced runs only): the
    bytes and operations the front-end's inputs need."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.rounds = []
        inner = pipe._dispatch_group

        def wrapped(group, skips, _inner=inner):
            _inner(group, skips)
            self.take(len(group.bases), [int(s) for s in skips])
        pipe._dispatch_group = wrapped

    def take(self, nb: int, skips: list) -> None:
        g = self.pipe.graphs.get(nb)
        if g is None or g.parts[0].out is None:
            return
        ncs, routed = g.parts[0].out
        with torch.profiler.record_function("bench.probe"):
            counts = torch.empty(3, dtype=torch.int32, pin_memory=True)
            counts.copy_(ncs, non_blocking=True)
            starts = []
            for _, _, params in routed:
                h = torch.empty((2, params.shape[1]), dtype=torch.int32,
                                pin_memory=True)
                h.copy_(params[:2], non_blocking=True)
                starts.append(h)
        self.rounds.append((nb, skips, counts, starts))

    def launches(self, stream_len: int) -> list:
        """(class, live rows, window starts, planes' samples) of every
        front-end launch the probed rounds made (after a synchronise)."""
        out = []
        for nb, skips, counts, starts in self.rounds:
            for c, cls in enumerate(self.pipe.classes):
                if int(counts[c]) <= skips[c]:
                    continue
                live = min(int(counts[c]) - skips[c], cls.batch)
                st = starts[c][:, :live].numpy().astype(np.int64)
                out.append((c, live, (st[0] * ref_decode.ALIGN
                                      + st[1]).tolist(), nb * stream_len))
        return out


def capture_missing_classes(pipe, agg: int) -> None:
    """Capture the class graphs of arity `agg` that the warm pass left
    uncaptured (a class with no member runs no batch), as the group
    program would capture them, so that nothing is captured in the
    window."""
    g = pipe.graphs.get(agg)
    if g is None or g.parts[0].out is None:
        return
    _, routed = g.parts[0].out
    for c, cls in enumerate(pipe.classes):
        part = g.parts[1 + c]
        if part.graph is None:
            params = routed[c][2]
            part.replay(lambda cls=cls, params=params:
                        cls.run_jobs(g.planes, params).reshape(-1))


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str, t_process: float, control: bool = False,
             log=None) -> dict:
    """One run: returns the result line's object (and, under `control`,
    the control's numbers under "control")."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from iridium_tpu_torch import _kernels
    from iridium_tpu_torch.config import DetectorConfig
    from iridium_tpu_torch.output.raw import RawPrinter
    from iridium_tpu_torch.runtime.pipeline import Pipeline

    cfg, mix = cell.config, cell.mix
    if cuda:
        _kernels.build_all()
    dec = ref_decode.Decoder(cfg["sample_rate"], cfg["frames_per_block"],
                             cfg["gone_capacity"], cfg["use_gardner"], dev)
    p = dec.p
    bs, rate = p.block_samples, p.sample_rate
    pool, plan = traffic.capture(mix, rate, p.fft_size, bs, seed, dev)
    n_pool = pool.shape[0]
    pipe = Pipeline(
        det_cfg=DetectorConfig(sample_rate=rate,
                               frames_per_block=cfg["frames_per_block"],
                               gone_capacity=cfg["gone_capacity"]),
        burst_batch=cfg["burst_batch"], use_gardner=cfg["use_gardner"],
        start_time_ns=START_NS, device=dev, want_llr=cfg["want_llr"],
        agg_blocks=cfg["agg_blocks"], group_jobs=cfg["group_jobs"],
        detect_impl=cfg["detect_impl"])
    agg = pipe.agg_blocks
    if n_pool % agg:
        raise ValueError(f"a pool of {n_pool} blocks is no whole number of "
                         f"groups of {agg}")
    held = Held(pipe)
    held.check_block(0)
    printer = RawPrinter()
    kept: dict = {}          # stream block -> [(line, frame)]

    def consume(frames_iter, first_block: int, keep: set, on_yield=None):
        for j, frames in enumerate(frames_iter):
            if on_yield is not None:
                on_yield(j, len(frames))
            k = first_block + j
            lines = [printer.format(f) for f in frames]
            if k in keep:
                kept[k] = list(zip(lines, frames))

    # set-up: one pass over the pool (the stream's start), every class
    # graph captured
    consume(pipe.run_blocks(((pool[i], bs) for i in range(n_pool)),
                            depth=DEPTH), 0, {0})
    if cuda:
        capture_missing_classes(pipe, agg)
        torch.cuda.synchronize()
    probe = FrontendProbe(pipe) if traced and cuda else None
    if traced:
        add_spans(pipe)
    rng = np.random.default_rng(seed)
    sample_at = sorted(float(rng.uniform(a, b)) for a, b in SAMPLE_PARTS)
    checked = {0}            # the stream blocks the reference checks

    t_hand, t_yield, n_lines = [], [], []
    before = dict(pipe.timing)
    st0 = dataclasses.replace(pipe.stats)
    k0 = n_pool              # the window's first stream block

    def feed(t_end, t_start):
        k = 0
        while True:
            now = time.perf_counter()
            if k % agg == 0 and now >= t_end:
                return
            if sample_at and now - t_start >= sample_at[0] * seconds:
                sample_at.pop(0)
                held.check_block(k0 + k)
                checked.add(k0 + k)
            x = pool[(k0 + k) % n_pool]
            t_hand.append(time.perf_counter())
            k += 1
            yield x, bs

    def on_yield(j, n):
        t_yield.append(time.perf_counter())
        n_lines.append(n)

    def window():
        t_start = time.perf_counter()
        consume(pipe.run_blocks(feed(t_start + seconds, t_start),
                                depth=DEPTH),
                k0, checked, on_yield)
        if cuda:
            torch.cuda.synchronize()
        return t_start, time.perf_counter()

    # the set-up's objects (the pool, the reference's constants, the
    # program's graphs) out of the collector's way in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    gc0 = gc_count()
    prof = None
    if traced and cuda:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                t_start, t_end = window()
    else:
        t_start, t_end = window()
    window_s = t_end - t_start
    blocks = len(t_hand)
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    timing = {k: pipe.timing[k] - before.get(k, 0) for k in pipe.timing}
    detected = pipe.stats.n_detected - st0.n_detected
    n_ok = pipe.stats.n_ok - st0.n_ok
    block_ms = (np.asarray(t_yield) - np.asarray(t_hand)) * 1e3
    # every line counts its block's latency; a window without lines (a
    # fault the check refuses) reports its blocks'
    lat_ms = np.repeat(block_ms, n_lines) if sum(n_lines) else block_ms

    result = dict(correct=False, attempted=blocks,
                  failed=blocks - len(t_yield), metrics={},
                  device=dict(platform="gpu" if cuda else "cpu",
                              kind=(torch.cuda.get_device_name(dev)
                                    if cuda else "cpu"),
                              count=1, memory_peak_bytes=int(mem_peak)))
    log(f"window: {blocks} blocks in {window_s:.4f} s, {detected} detected, "
        f"{n_ok} ok, {len(lat_ms)} lines; set-up {setup_s:.4f} s; "
        f"{result['device']['kind']} ({card_note() if cuda else 'cpu'})")
    per_s = np.bincount((np.asarray(t_hand) - t_start).astype(int))
    log(f"blocks handed over in each second of the window: {per_s.tolist()}"
        f"; garbage collections: {gc_count() - gc0}; host CPUs "
        f"{sorted(os.sched_getaffinity(0))}, on CPU {host_cpu()}")
    if blocks == 0:
        raise RuntimeError("the window decoded no block")

    if traced:
        tr = None
        if prof is not None:
            path = os.path.join(tempfile.gettempdir(),
                                f"bench-trace-{cell.name}.json")
            prof.export_chrome_trace(path)
            del prof
            tr = devtrace.load(path)
            os.remove(path)
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s()
            result["breakdown"] = dict(device_ops=tr.top_ops(),
                                       idle_gaps=tr.idle_gaps())
        ctx = types.SimpleNamespace(
            trace=tr, timing=timing, blocks=blocks, detected=detected,
            groups=timing.get("n_groups", 0), lat_ms=lat_ms,
            block_bytes=8 * bs, p=p, dec=dec,
            frontend=(probe.launches(pipe.stream_len)
                      if probe is not None else []))
        for name in cell.per_layer:
            v = importlib.import_module(f"metrics.{name}").read(ctx)
            if v is not None:
                result["metrics"][name] = dict(
                    value=float(v), unit=metric_unit(name))
    else:
        result["metrics"] = dict(
            realtime_x=dict(value=blocks * bs / rate / window_s, unit="x"),
            line_latency_p95_ms=dict(
                value=float(np.percentile(lat_ms, 95)), unit="ms"),
            setup_s=dict(value=setup_s, unit="s"))

    # the check, once the window has closed and the program is freed
    states_in = {k: ref_state(s) for k, s in held.states_in.items()
                 if k > 0}
    states_out = {k: ref_state(s) for k, s in held.states_out.items()}
    del held, pipe, probe
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums, ctl = check(dec, pool, checked, agg, states_in, states_out, kept,
                      control, log)
    correct, checks = compare.verdict(nums, cell.limits)
    log(f"check: {len(checked)} blocks, {nums['lines']} lines, "
        f"{nums['paired']} paired, {time.perf_counter() - t_check:.2f} s")
    if ctl is not None:
        result["control"] = {name: {k: c[k] for k in compare.NUMBERS}
                             for name, c in ctl.items()}
        log("control: " + json.dumps(result["control"]))
    result["correct"] = correct
    result["checks"] = checks
    return result


def host_cpu() -> int:
    """The CPU this process last ran on (/proc/self/stat, field 39)."""
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def gc_count() -> int:
    return sum(g["collections"] for g in gc.get_stats())


def ref_state(st) -> ref_scan.ScanState:
    """A copy of a detector state as the reference's type (by field)."""
    return ref_scan.ScanState(**{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(ref_scan.ScanState)})


def check(dec, pool, checked, agg: int, states_in: dict, states_out: dict,
          kept: dict, control: bool, log=None):
    """The reference's decode of every checked block, compared with the
    program's output: (numbers, the controls' numbers or None). The
    stream's first block starts from the detector's initial state; a
    later one from the program's state before it."""
    n_pool = pool.shape[0]
    bs = dec.p.block_samples
    t0 = file_info = None
    detect, parts = [], []
    ctl = dict(frontend_tf32=([], []), detect_bf16=([], []))
    for k in sorted(checked):
        tc = time.perf_counter()
        x, bi = pool[k % n_pool], k % agg
        base0 = (k - bi) * bs
        if k == 0:
            tail = torch.zeros(dec.l_ext, dtype=torch.complex64)
            s_in = ref_scan.init_state(dec.p, dec.device)
        else:
            tail = pool[(k - 1) % n_pool][bs - dec.l_ext:]
            s_in = states_in[k]
        state = dec.detect(x, s_in)
        detect.append(compare.detect_numbers(states_out[k], state))
        td = time.perf_counter()
        frames = dec.decode(x, tail, state, bi, agg, base0, START_NS)
        if t0 is None:
            # the printer's clock: the stream's first frame, floored to
            # the second (a block is longer than the detector's priming,
            # so the first block holds it)
            if not frames:
                raise RuntimeError("the reference decoded no frame in the "
                                   "stream's first block")
            t0 = frames[0]["timestamp_ns"] // 10**9 * 10**9
            file_info = f"i-{t0 // 10**9}-t1"

        def lines(fr):
            return [(ref_decode.format_raw(f, t0, file_info), f)
                    for f in fr]
        ref = lines(frames)
        parts.append(compare.lines_numbers(kept.get(k, []), ref))
        if log:
            log(f"check block {k}: detect {td - tc:.2f} s, classes "
                f"{time.perf_counter() - td:.2f} s, {len(ref)} lines")
        if control:
            d, p = ctl["frontend_tf32"]
            d.append((0, 0.0))
            p.append(compare.lines_numbers(lines(dec.decode(
                x, tail, state, bi, agg, base0, START_NS, tf32=True)), ref))
            d, p = ctl["detect_bf16"]
            c_state = dec.detect(x, s_in, bf16=True)
            d.append(compare.detect_numbers(c_state, state))
            p.append(compare.lines_numbers(lines(dec.decode(
                x, tail, c_state, bi, agg, base0, START_NS)), ref))
    nums = compare.numbers(detect, parts)
    if not control:
        return nums, None
    return nums, {name: compare.numbers(d, p) for name, (d, p) in ctl.items()}


def metric_unit(name: str) -> str:
    return importlib.import_module(f"metrics.{name}").UNIT
