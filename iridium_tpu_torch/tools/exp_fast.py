"""detect_fast's kernel against its plain twin, per shape.

    python -m iridium_tpu_torch.tools.exp_fast [--shapes 10mhz,edge,...]
        [--source PATH ...] [--reps N]
    python -m iridium_tpu_torch.tools.exp_fast --shapes split1,split_local,split1_1mhz,lockstep4
    python -m iridium_tpu_torch.tools.exp_fast --phases --shapes 10mhz,25mhz
    python -m iridium_tpu_torch.tools.exp_fast --device cpu --small

Each shape is a block of |X|^2 rows and the state it starts from, in the
layout `detect_fast.plan` gives it:
  - `10mhz`: the production block (2,048 x 8,192, exp_scan's synthetic
    block: bursts, a long burst, a squelch blast with emission drops),
    from a fresh state: one thread block;
  - `edge`: exp_scan's edge block (256 x 8,192, history 64, gone table of
    64: ties across segment edges, bursts across thread edges, a squelch
    comb), n_valid ending 3.5 frames before the block's end;
  - `25mhz`, `50mhz`, `200mhz`: the 1,024 x 32,768, x 65,536 and x
    262,144 synthetic blocks: one cluster of 4, 8 and 16 blocks (16 of 16
    bins a thread);
  - `400mhz`: the 1,024 x 524,288 synthetic block: a grid of 4 clusters
    of 16;
  - `1600mhz`: the 1,024 x 2,097,152 synthetic block with n_valid = 2^31,
    the block `resolve_impl` gives detect_fast at 1.6 GHz (the scan
    kernel's positions stop below 2^31): a grid of 64 clusters of 2
    blocks of 16 bins a thread;
  - `local`: rank 1 of 4 of a 10 MHz bin split (2,114 local bins from
    global bin 2,015, owning [2,048, 4,096), id_stride 4) on the
    production block's columns, under the identity coupling.
The split's shapes (card only), binshard's two launches a frame around
the coupling, the block's frames replayed as one CUDA graph
(`scan_fast_split`):
  - `split1`: binshard's range at 10 MHz and world size 1 (8,258 bins from
    global bin -33, the spectrum's own edges as halos) on the production
    block, identity coupling: a cluster of 2 blocks;
  - `split_local`: the `local` range (2,114 bins, one block), identity
    coupling;
  - `split1_1mhz`: binshard's range at 1 MHz and world size 1 (1,106 bins
    from global bin -41: one block of 2 bins a thread) on `lockstep4`'s
    block, whose comb the one range squelches, identity coupling;
  - `lockstep4`: a 1 MHz block (1,024 x 1,024: bursts, a long burst, a
    comb that only the 4 ranges' summed count squelches) over binshard's 4
    ranges of 338 bins, their splits driven in lockstep on one card with
    each frame's pairs summed by a tensor add (eagerly, and captured once
    as one graph), held to 4 twins in 4 threads coupled by a barrier sum
    (`barrier_twins`).
Each is held bit for bit to the twins, to its eager steps (`SplitScan`)
and, with one range, to the one-launch kernel (`one_launch_bit_equal`),
and timed (the graph's replay with one range, the eager steps, the one
launch at the same width): ms, µs a frame, the launches a frame, the
device operations of the eager steps.
Per shape the kernel (`make_scan_fast`: one launch a block) is held to
`scan_fast_plain` on the same device bit for bit on every field of the
state (`first_diff`: the first field and index that part), and timed:
single-call and chained ms (CUDA events), µs a frame, the twin's ms,
the bound (the rows of the active frames read once, the state read and
written once, at 3.35 TB/s; the division and compare a bin a frame at
67 TFLOP/s FP32), the kernel's launches, the device operations a block
(torch.profiler: the state's clone, the gone table's zeroing, the
scratch and the kernel) and `ptxas -v`'s registers and spills of the
instantiation it runs. `--source x.cu` (card only, repeatable) builds
another source and times it beside the package's kernel on the same
inputs, held to the twin the same way, in its own layout where it is the
design before clusters (`legacy`: `git show
9568349:iridium_tpu_torch/csrc/detect_fast.cu`). `--phases` (card only)
times the one launch at each shape and splits its µs a frame between the
source's `// phase:` markers as thread 0 of block 0 sees them (a probed
copy: `exp_scan.probed_source`). On the CPU (`--small`) the wrapper is
the twin: the tool's own run at a small shape.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import threading
import time

import numpy as np
import torch

from .. import _kernels
from .. import device as device_mod
from ..config import DetectorConfig
from ..dsp import detect_fast, state as st
from ..runtime import pipeline
from . import exp_demod, exp_scan, variants
from .exp_block_gather import single_ms

SEED = 1234
SHAPES = ("10mhz", "edge", "25mhz", "50mhz", "200mhz", "400mhz", "1600mhz",
          "local")
SPLIT_SHAPES = ("split1", "split_local", "split1_1mhz", "lockstep4")
WIDE_RATES = {"25mhz": 25_000_000, "50mhz": 50_000_000,
              "200mhz": 200_000_000, "400mhz": 400_000_000,
              "1600mhz": 1_600_000_000}
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
DB_FIELDS = ("g_mag", "g_noise", "a_mag", "a_noise", "floats")


@dataclasses.dataclass
class Case:
    name: str
    p: object
    mag2: torch.Tensor
    state: st.ScanState
    n_valid: int
    n_bins: int | None = None
    id_stride: int = 1
    rng: dict = dataclasses.field(default_factory=dict)

    @property
    def FL(self) -> int:
        return self.n_bins if self.n_bins is not None else self.p.fft_size


def _synthetic(p, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return exp_scan.synthetic_spectrogram(p, gen)


def bin_ranges(p, mag2: torch.Tensor, n: int, ranks=None) -> list:
    """binshard's bin ranges of the block (parallel/stream.py): for each
    rank r of n (all by default), (its columns of mag2 with `halo` bins
    each side, wrapped at the spectrum's edges; its fresh state; its range
    (bin_lo, own_lo, own_hi)), over n_bins = F / n + 2 halo bins."""
    F = p.fft_size
    own, halo = F // n, 2 * (p.burst_width_bins // 2) + 1
    FL = own + 2 * halo
    out = []
    for r in range(n) if ranks is None else ranks:
        bin_lo = r * own - halo
        cols = torch.from_numpy((np.arange(FL) + bin_lo) % F).to(mag2.device)
        out.append((mag2[:, cols].contiguous(),
                    st.init_state(p, mag2.device, id_offset=r, n_bins=FL),
                    dict(bin_lo=bin_lo, own_lo=r * own, own_hi=(r + 1) * own)))
    return out


def coupled_spectrogram(p, gen):
    """(frames, F) |X|^2 for binshard's ranges: exponential noise; once the
    history is primed, 3-bin bursts a range apart, one longer than
    max_burst_len, whose deletion forces every range's noise update
    through the coupling; after it, a comb with one peak every 2 half_bw
    + 2 bins, more than max_bursts over the band but fewer in any quarter
    of it, so that only the summed count squelches."""
    F, n = p.fft_size, p.frames_per_block
    t0 = p.history_size + 8
    long_frames = p.max_burst_len // F + 8
    t_comb = t0 + 3 + long_frames + 10
    if t_comb + 20 > n:
        raise ValueError(f"{n} frames a block: too few for the bursts")
    mag2 = torch.empty((n, F), device=gen.device).exponential_(generator=gen)
    for f0, nf, b in [(t0, 20, F // 5), (t0 + 3, long_frames, F // 3),
                      (t0 + 6, 4, F // 2 + 40), (t0 + 12, 30, 3 * F // 4)]:
        mag2[f0:f0 + nf, b - 1:b + 2] += 500.0
    step = p.burst_width_bins + 2
    comb = torch.arange(p.burst_width_bins, F - p.burst_width_bins, step,
                        device=gen.device)
    comb = comb[(comb - F // 2).abs() > 8]
    mag2[t_comb:t_comb + 20, comb] += 800.0
    return mag2


def summed(pairs: list) -> list:
    """Each range's coupled pair: the sum of every range's."""
    return [torch.stack(pairs).sum(0)] * len(pairs)


def lockstep(p, ranges: list, n_valid: int, n_bins: int, id_stride: int,
             mix=summed, graph: bool = False) -> list:
    """`detect_fast.SplitScan` over the ranges [(mag2, state, range)] on
    one card, in lockstep: each frame launch A on every range, the pairs
    combined (`mix(pairs)` -> the pair each range takes, written into its
    scratch in place), launch B on every range. With `graph` the frame
    loop is captured as one CUDA graph and replayed once. The new
    ScanStates."""
    scans = [detect_fast.SplitScan(m, s, n_valid, p, n_bins, id_stride,
                                   **r) for m, s, r in ranges]

    def frames():
        for f in range(scans[0].n_act):
            for s, pair in zip(scans, mix([s.a(f) for s in scans])):
                s.pair.copy_(pair)
            for s in scans:
                s.b(f)
    if graph:
        pipeline.Captured(warm=False).replay(frames)
    else:
        frames()
    return [s.end() for s in scans]


def barrier_twins(p, ranges: list, n_valid: int, n_bins: int,
                  id_stride: int, mix=summed) -> list:
    """`scan_fast_plain` over each range [(mag2, state, range)] in a
    thread of its own, each frame's pairs combined across the threads at a
    barrier (`mix`, as `lockstep`'s). The new ScanStates. A thread that
    fails breaks the barrier for the others, and the failure is raised."""
    n = len(ranges)
    # far above any frame's wait: a broken run fails instead of hanging
    barrier = threading.Barrier(n, timeout=600)
    vals, outs, errs = [None] * n, [None] * n, []

    def run(k):
        def coupling(x):
            vals[k] = x.clone()
            barrier.wait()
            pair = mix(vals)[k]
            barrier.wait()
            return pair
        m, s, r = ranges[k]
        try:
            outs[k] = detect_fast.scan_fast_plain(
                m, s, n_valid, p, n_bins, coupling, id_stride, **r)
        except Exception as e:  # noqa: BLE001  (raised below)
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs


def case(name: str, dev: torch.device) -> Case:
    """The shape's block, start state and range on `dev`."""
    if name == "10mhz":
        p = exp_scan.production_params()
        return Case(name, p, _synthetic(p, dev), st.init_state(p, dev),
                    p.block_samples)
    if name == "edge":
        p = DetectorConfig(sample_rate=10_000_000, history_size=64,
                           frames_per_block=256, max_new_per_frame=8,
                           gone_capacity=64, max_bursts=20).derived()
        m = torch.from_numpy(exp_scan.edge_spectrogram(p, seed=11)).to(dev)
        return Case(name, p, m, st.init_state(p, dev),
                    p.block_samples - 7 * p.fft_size // 2)
    if name in WIDE_RATES:
        p = DetectorConfig(sample_rate=WIDE_RATES[name]).derived()
        return Case(name, p, _synthetic(p, dev), st.init_state(p, dev),
                    p.block_samples)
    if name == "local":
        p = exp_scan.production_params()
        (mag2, s, rng), = bin_ranges(p, _synthetic(p, dev), 4, ranks=[1])
        return Case(name, p, mag2, s, p.block_samples, n_bins=mag2.shape[1],
                    id_stride=4, rng=rng)
    if name == "small":
        p = DetectorConfig(sample_rate=1_000_000, history_size=16,
                           frames_per_block=64, gone_capacity=64,
                           max_bursts=4).derived()
        rng = np.random.default_rng(SEED)
        m = rng.exponential(size=(64, p.fft_size)).astype(np.float32)
        m[20:30, 300:303] += 400.0
        m[24:60, 600:602] += 400.0
        m[40:46, 100:900:40] += 900.0
        return Case(name, p, torch.from_numpy(m).to(dev),
                    st.init_state(p, dev), p.block_samples)
    raise ValueError(f"unknown shape {name!r}")


def squelch_rows(states: list, p) -> int:
    """Gone rows of bursts still active when they went, over the states: a
    squelch's (a natural deletion comes burst_post_len or more samples
    after the burst's last activity, a long burst's after max_burst_len)."""
    n = 0
    for s in states:
        k = int(s.g_count)
        gap = s.g_stop[:k] - s.g_last[:k]
        span = s.g_last[:k] - s.g_start[:k]
        n += int(((gap < p.burst_post_len) & (span <= p.max_burst_len))
                 .sum())
    return n


@dataclasses.dataclass
class SplitCase:
    """A split shape: binshard's ranges of one block, [(mag2, state,
    range)], over n_bins local bins each."""
    name: str
    p: object
    ranges: list
    n_valid: int
    n_bins: int
    id_stride: int

    @property
    def FL(self) -> int:
        return self.n_bins


def split_case(name: str, dev: torch.device) -> SplitCase:
    """The split shape's block, ranges and start states on `dev`."""
    if name in ("split1", "split_local"):
        p = exp_scan.production_params()
        n, ranks = (1, None) if name == "split1" else (4, [1])
        ranges = bin_ranges(p, _synthetic(p, dev), n, ranks)
    elif name in ("split1_1mhz", "lockstep4"):
        p = DetectorConfig(sample_rate=1_000_000).derived()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        n = 1 if name == "split1_1mhz" else 4
        ranges = bin_ranges(p, coupled_spectrogram(p, gen), n)
    else:
        raise ValueError(f"unknown split shape {name!r}")
    return SplitCase(name, p, ranges, p.block_samples,
                     ranges[0][0].shape[1], n)


def bound(c) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the active frames' rows read once,
    the state (history, the 8 per-bin planes, the gone table and the
    scalars) read and written once; a division and a compare a bin a
    frame. A split case's: every range's."""
    p, FL = c.p, c.FL
    k = len(c.ranges) if isinstance(c, SplitCase) else 1
    n_act = detect_fast.active_frames(p, c.n_valid)
    state = (4 * p.history_size * FL + 29 * FL + 28 * p.gone_capacity
             + 36)
    t_b = k * (4 * n_act * FL + 2 * state) / HBM_BYTES_PER_S * 1e3
    t_o = k * 2 * n_act * FL / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# The design before clusters (`git show
# 9568349:iridium_tpu_torch/csrc/detect_fast.cu`): one block or a
# cooperative grid, its C packing without a cluster size (`adapted` puts
# one with the package's argument list in front of it) and its own layout
# (`legacy_plan`).
def legacy(text: str) -> bool:
    """Whether a detect_fast source, as given or `adapted`, is the old
    design."""
    if "detect_fast_args_v1(" in text:
        return True
    head = text[text.index('extern "C" int detect_fast_args('):]
    return "int clusters" not in head[:head.index("{")]


def adapted(text: str) -> str:
    """An old-design source behind the package's C entry (`legacy`): its
    packing takes the cluster size and drops it."""
    if not legacy(text) or "detect_fast_args_v1(" in text:
        return text
    text = text.replace('extern "C" int detect_fast_args(',
                        'extern "C" int detect_fast_args_v1(', 1)
    return text + """
extern "C" int detect_fast_args(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf,
    unsigned* scratch, int F, int FL, int n_act, int H, int G, int half_bw,
    int k_create, int max_bursts, int max_burst_len, int post_len,
    int pre_len, int id_stride, int bin_lo, int own_lo, int own_hi,
    float threshold, float hist_f, float enbw, float f2, float bin_width,
    int blocks, int clusters, int block_bins, int threads,
    int bins_per_thread, int seg, long long scratch_words, int split,
    void* out, int out_bytes) {
  return detect_fast_args_v1(
      mag2, hist, bsum, a_valid, a_id, a_start, a_last, a_mag, a_noise,
      mask_count, g_id, g_start, g_stop, g_last, g_bin, g_mag, g_noise, sc,
      scf, scratch, F, FL, n_act, H, G, half_bw, k_create, max_bursts,
      max_burst_len, post_len, pre_len, id_stride, bin_lo, own_lo, own_hi,
      threshold, hist_f, enbw, f2, bin_width, blocks, block_bins, threads,
      bins_per_thread, seg, scratch_words, split, out, out_bytes);
}
"""


def legacy_plan(p, n_bins=None) -> detect_fast.Plan:
    """The old design's layout (its `plan`): one block up to 8,192
    bins, else a cooperative grid of up to 132 blocks of 1,024 threads,
    each thread with the fewest bins (a power of two) that covers the
    band; its scratch: a counter line, 20 words a block, a flag word a
    thread; the split's pair, two 9-word scalar slots and 23 words a
    block after it."""
    F = p.fft_size
    FL = n_bins if n_bins is not None else F
    SEG, NS = detect_fast._segments(p.burst_width_bins // 2, FL)
    bpt = 1
    if FL <= 8192:
        while bpt * 1024 < FL:
            bpt *= 2
        T, blocks = -(-FL // (32 * bpt)) * 32, 1
    else:
        while -(-FL // (1024 * bpt)) > 132:
            bpt *= 2
        T = 1024
        blocks = -(-FL // (T * bpt))
    words = 32 + 20 * blocks + blocks * T
    return detect_fast.Plan(blocks, T * bpt, T, bpt, 1, SEG, NS, words,
                            blocks > 1, words + 4 + 18 + 23 * blocks)


@contextlib.contextmanager
def design(name: str, k: _kernels.Kernel):
    """The package's wrappers on kernel `k` (a `--source` candidate), in
    the old design's layout where `k` is one (`legacy`)."""
    old = k is not _kernels.DETECT_FAST and legacy(k.text)
    saved = detect_fast.plan
    with variants.swapped("DETECT_FAST", k):
        if old:
            detect_fast.plan = legacy_plan
        try:
            yield old
        finally:
            detect_fast.plan = saved


INSTANCE = re.compile(r"(detect_fast_(?:kernel|a|b))I((?:L[ib]\d+E)+)E")


def ptxas_table(kernel: _kernels.Kernel) -> dict:
    """{instantiation: dict(registers, stack_frame, spill_stores,
    spill_loads)} from the `ptxas -v` report the kernel's build kept, the
    instantiation named as `detect_fast_kernel<8,1,0>` (bins a thread,
    cluster, grid) or, in the old design, `detect_fast_a<4>`."""
    out, cur = {}, None
    for ln in kernel.ptxas_path().read_text().splitlines():
        if m := exp_demod.PTXAS_FN.search(ln):
            i = INSTANCE.search(m.group(1))
            cur = None
            if i:
                args = ",".join(re.findall(r"L[ib](\d+)E", i.group(2)))
                cur = out.setdefault(f"{i.group(1)}<{args}>", {})
        elif cur is None:
            continue
        elif m := exp_demod.PTXAS_FRAME.search(ln):
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif m := exp_demod.PTXAS_REGS.search(ln):
            cur["registers"] = int(m.group(1))
    return out


def instance(lay: detect_fast.Plan, old: bool = False) -> str:
    """The `ptxas_table` key of the instantiation a layout runs."""
    if old:
        return f"detect_fast_kernel<{lay.bpt}>"
    return (f"detect_fast_kernel<{lay.bpt},{int(lay.clusters > 1)},"
            f"{int(lay.grid)}>")


def compare_bits(got: st.ScanState, want: st.ScanState) -> dict:
    """Raise unless every field but the dB ones is bit-equal to the
    twin's (floats compared as bits) and the dB ones are within rtol
    1e-5; `bit_equal` says whether every field is, `first_diff` the first
    field and flat index that part (None when none does)."""
    first, db_equal, err = None, True, 0.0
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        ai, bi = ((a.view(torch.int32), b.view(torch.int32))
                  if a.dtype == torch.float32 else (a, b))
        if torch.equal(ai, bi):
            continue
        at = int(torch.nonzero(ai.flatten() != bi.flatten())[0])
        if first is None:
            first = [f.name, at]
        if f.name not in DB_FIELDS:
            raise AssertionError(f"detect_fast kernel: {f.name} differs "
                                 f"from the twin's at {at}: "
                                 f"{ai.flatten()[at]} against "
                                 f"{bi.flatten()[at]}")
        db_equal = False
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        err = max(err, float((a - b).abs().max()))
    return dict(bit_equal=first is None, db_bit_equal=db_equal,
                first_diff=first, max_abs_err=err)


def scalar_division(dev: torch.device, n: int = 1 << 20) -> dict:
    """What the kernel's noise dB assumes of PyTorch on `dev`, on n random
    f32 values and the detector's divisors (hist_f, f2, enbw, bin_width of
    the production configuration): the share of `x / d` with a Python
    float d that equals x times d's f32 reciprocal, and the share that
    equals the IEEE quotient (x divided by d as a tensor)."""
    from ..dsp import detect_scan
    c = detect_scan._consts(exp_scan.production_params())
    x = torch.from_numpy(np.random.default_rng(SEED).exponential(
        size=n).astype(np.float32)).to(dev)
    recip = quot = 0.0
    names = ("hist_f", "f2", "enbw", "bin_width")
    for name in names:
        d = float(c[name])
        got = x / d
        inv = float(np.float32(1.0) / np.float32(d))
        recip += float((got == x * inv).float().mean()) / len(names)
        quot += float((got == x / torch.tensor(d, device=dev)).float()
                      .mean()) / len(names)
    return dict(reciprocal_share=recip, quotient_share=quot)


def _ms(fn, dev, reps: int) -> float:
    if dev.type == "cuda":
        return single_ms(fn, reps)
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def _chained_ms(fn, dev, reps: int) -> float:
    if dev.type != "cuda":
        return _ms(fn, dev, reps)
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def run_case(c: Case, dev: torch.device, reps: int = 3,
             cands=None) -> dict:
    """The case through the kernel and the twin on `dev`: equality and
    times (see the module's doc). `cands`: [(name, Kernel)] to run in the
    package kernel's place too (`variants.candidates`)."""
    p = c.p
    run = detect_fast.make_scan_fast(p, c.n_bins, id_stride=c.id_stride)

    def kernel():
        return run(c.mag2, c.state, c.n_valid, **c.rng)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    before = _kernels.DETECT_FAST.launches
    got = kernel()
    sync()
    launches = _kernels.DETECT_FAST.launches - before
    t = time.perf_counter()
    want = detect_fast.scan_fast_plain(c.mag2, c.state, c.n_valid, p,
                                       n_bins=c.n_bins,
                                       id_stride=c.id_stride, **c.rng)
    sync()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp = compare_bits(got, want)
    g = dict(zip(st.INT_FIELDS, got.ints.tolist()))
    del got
    lay = detect_fast.plan(p, c.n_bins)
    n_act = detect_fast.active_frames(p, c.n_valid)
    b_ms, b_by = bound(c)
    ms = _ms(kernel, dev, reps)
    res = dict(shape=[p.frames_per_block, c.FL], case=c.name,
               n_valid=int(c.n_valid), n_act=n_act,
               layout=dict(blocks=lay.blocks, clusters=lay.clusters,
                           threads=lay.threads, bins_per_thread=lay.bpt,
                           segment=c.FL // lay.ns),
               ms=ms, chained_ms=_chained_ms(kernel, dev, reps),
               us_per_frame=ms * 1e3 / max(n_act, 1), plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, kernel_launches=launches,
               gone=g["g_count"], tagged=g["n_tagged"],
               dropped=g["burst_dropped"], **cmp)
    if dev.type == "cuda":
        res["device_ops"] = device_ops(kernel)
    if dev.type == "cuda":
        res["ptxas"] = ptxas_table(_kernels.DETECT_FAST).get(instance(lay))
    for name, k in cands or []:
        if k is _kernels.DETECT_FAST:
            continue
        with design(name, k) as old:
            other = compare_bits(kernel(), want)
            o_ms = _ms(kernel, dev, reps)
            res.setdefault("sources", {})[name] = dict(
                ms=o_ms, chained_ms=_chained_ms(kernel, dev, reps),
                us_per_frame=o_ms * 1e3 / max(n_act, 1),
                ptxas=ptxas_table(k).get(instance(detect_fast.plan(
                    p, c.n_bins), old)), **other)
    return res


def identity(x):
    """The identity coupling (one bin range), one function for every
    call, so that a graph captured with it is found again."""
    return x


def run_split_case(c: SplitCase, dev: torch.device, reps: int = 3,
                   cands=None) -> dict:
    """The split case on the card: the graph-replayed split (one range:
    `scan_fast_split`, its graphs kept across the calls, so that a timed
    call is a replay; several: `lockstep` captured once), held bit for bit
    to the twins, to the eager steps (`lockstep`) and, with one range, to
    the one launch; each timed (see the module's doc). `cands` as
    `run_case`'s: each other source's graph replay and eager steps too,
    held to the twins."""
    p, FL, k = c.p, c.FL, len(c.ranges)
    args = (p, c.ranges, c.n_valid, FL, c.id_stride)

    def graph_of(graphs):
        def graph():
            if k == 1:
                (m, s, r), = c.ranges
                return [detect_fast.scan_fast_split(
                    m, s, c.n_valid, p, identity, FL, c.id_stride,
                    graphs=graphs, **r)]
            return lockstep(*args, graph=True)
        return graph

    def eager():
        return lockstep(*args)

    def one_launch():
        m, s, r = c.ranges[0]
        return detect_fast.scan_fast_kernel(m, s, c.n_valid, p, FL,
                                            c.id_stride, **r)

    graph = graph_of(detect_fast.SplitGraphs())
    before = _kernels.DETECT_FAST.launches
    got = graph()
    torch.cuda.synchronize()
    launches = _kernels.DETECT_FAST.launches - before
    t = time.perf_counter()
    want = barrier_twins(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmps = [compare_bits(g, w) for g, w in zip(got, want)]
    first = next((x["first_diff"] for x in cmps if x["first_diff"]), None)
    steps = [compare_bits(g, e)["bit_equal"] for g, e in zip(got, eager())]
    one = compare_bits(got[0], one_launch()) if k == 1 else None
    heads = [dict(zip(st.INT_FIELDS, g.ints.tolist())) for g in got]
    n_sq = squelch_rows(got, p)
    del got
    n_act = detect_fast.active_frames(p, c.n_valid)
    lay = detect_fast.plan(p, FL)
    b_ms, b_by = bound(c)
    ms = _ms(graph, dev, reps) if k == 1 else None
    eager_ms = _ms(eager, dev, reps)
    one_ms = _ms(one_launch, dev, reps)
    per = 1e3 / max(n_act, 1)
    res = dict(
        shape=[p.frames_per_block, FL], case=c.name, ranges=k,
        n_valid=int(c.n_valid), n_act=n_act,
        layout=dict(blocks=lay.blocks, clusters=lay.clusters,
                    threads=lay.threads, bins_per_thread=lay.bpt,
                    segment=FL // lay.ns),
        ms=ms, us_per_frame=None if ms is None else ms * per,
        eager_ms=eager_ms, eager_us_per_frame=eager_ms * per,
        one_launch_ms=one_ms, one_launch_us_per_frame=one_ms * per,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        kernel_launches=launches,
        launches_per_frame=launches / max(n_act, 1),
        device_ops=device_ops(eager),
        gone=sum(h["g_count"] for h in heads),
        tagged=sum(h["n_tagged"] for h in heads),
        dropped=sum(h["burst_dropped"] for h in heads),
        squelch_rows=n_sq,
        bit_equal=all(x["bit_equal"] for x in cmps), first_diff=first,
        eager_bit_equal=all(steps),
        max_abs_err=max(x["max_abs_err"] for x in cmps),
        one_launch_bit_equal=None if one is None else one["bit_equal"],
        ptxas=ptxas_table(_kernels.DETECT_FAST).get(instance(lay)))
    for name, kern in cands or []:
        if kern is _kernels.DETECT_FAST:
            continue
        with design(name, kern) as old:
            other = graph_of(detect_fast.SplitGraphs())
            o_cmp = [compare_bits(g, w) for g, w in zip(other(), want)]
            o_ms = _ms(other, dev, reps) if k == 1 else None
            o_eager = _ms(eager, dev, reps)
            res.setdefault("sources", {})[name] = dict(
                ms=o_ms, us_per_frame=None if o_ms is None else o_ms * per,
                eager_ms=o_eager, eager_us_per_frame=o_eager * per,
                bit_equal=all(x["bit_equal"] for x in o_cmp),
                ptxas=ptxas_table(kern).get(instance(detect_fast.plan(
                    p, FL), old)))
    return res


def phase_shares(c: Case, dev: torch.device, reps: int = 3) -> dict:
    """The one launch's µs a frame at the case, and its split between the
    kernel's phase markers as thread 0 of block 0 sees them (a probed
    copy of the package's source), with each phase's entries."""
    text = _kernels.DETECT_FAST.source.read_text()
    probed_text, names = exp_scan.probed_source(text, entry="detect_fast")
    probed = variants.Variant(_kernels.DETECT_FAST, probed_text)
    run = detect_fast.make_scan_fast(c.p, c.n_bins, id_stride=c.id_stride)

    def kernel():
        return run(c.mag2, c.state, c.n_valid, **c.rng)
    n_act = detect_fast.active_frames(c.p, c.n_valid)
    us = _ms(kernel, dev, reps) * 1e3 / max(n_act, 1)
    with variants.swapped("DETECT_FAST", probed):
        kernel()
        exp_scan.phases(probed)              # drop the first call
        kernel()
        cyc, cnt = exp_scan.phases(probed)
    total = max(sum(cyc[:len(names)]), 1)
    return dict(case=c.name, us_per_frame=us, phases={
        n: dict(us_per_frame=us * cyc[i] / total, entries=cnt[i])
        for i, n in enumerate(names)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_fast",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--shapes", default=",".join(SHAPES + SPLIT_SHAPES),
                    help="comma-separated shapes: "
                    + ", ".join(SHAPES + SPLIT_SHAPES))
    ap.add_argument("--source", action="append", default=[],
                    help="time another kernel source with the package's C "
                    "entry point beside it, repeatable (card only)")
    ap.add_argument("--reps", type=int, default=3,
                    help="calls a time is the median (or mean) of")
    ap.add_argument("--phases", action="store_true",
                    help="split each shape's one launch between the "
                    "kernel's phases (card only)")
    args = ap.parse_args(argv)
    names = ["small"] if args.small else args.shapes.split(",")
    for name in names:
        if name not in SHAPES + SPLIT_SHAPES + ("small",):
            ap.error(f"unknown shape {name!r}")
    if args.reps < 1:
        ap.error("--reps must be 1 or more")
    dev = device_mod.resolve(args.device)
    if (args.source or args.phases) and dev.type != "cuda":
        ap.error("--source and --phases need the card")
    if dev.type != "cuda" and set(names) & set(SPLIT_SHAPES):
        ap.error("the split's shapes need the card")
    print("device: " + (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"), flush=True)
    cands = None
    if dev.type == "cuda":
        cands = variants.candidates(_kernels.DETECT_FAST, args.source,
                                    adapted)
        for cname, k in cands:
            print(f"ptxas {cname} " + json.dumps(ptxas_table(k)),
                  flush=True)
    for name in names:
        if args.phases:
            if name in SPLIT_SHAPES:
                ap.error("--phases takes the one launch's shapes")
            print(json.dumps(phase_shares(case(name, dev), dev, args.reps)),
                  flush=True)
            continue
        if name in SPLIT_SHAPES:
            r = run_split_case(split_case(name, dev), dev, args.reps,
                               cands)
            print(f"{name} {r['ranges']} x {r['shape'][0]} x "
                  f"{r['shape'][1]}: graph {r['us_per_frame']} us a frame, "
                  f"eager {r['eager_us_per_frame']:.2f}, one launch "
                  f"{r['one_launch_us_per_frame']:.2f}, bit-equal "
                  f"{r['bit_equal']}, twins {r['plain_ms']:.2f} "
                  + json.dumps(r), flush=True)
        else:
            r = run_case(case(name, dev), dev, args.reps, cands)
            print(f"{name} {r['shape'][0]} x {r['shape'][1]}: "
                  f"{r['ms']:.4f} ms (chained {r['chained_ms']:.4f}), "
                  f"bit-equal {r['bit_equal']}, twin {r['plain_ms']:.2f}, "
                  f"bound {r['bound_ms']:.5f} " + json.dumps(r), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
