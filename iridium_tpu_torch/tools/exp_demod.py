"""The demodulator's symbol loop (dsp/demod.py `loop`) at the burst
classes' batches, and the class graphs with it and with its plain
version.

    python -m iridium_tpu_torch.tools.exp_demod [--rates 10,400,1600]
        [--source PATH ... [--probes]] [--classes]
    python -m iridium_tpu_torch.tools.exp_demod --device cpu --small

The shapes follow the code: the three classes of the production 10 MHz
group program, (batch, frame cap L, symbols S, samples per symbol) from
`Pipeline(det_cfg=DetectorConfig(sample_rate=10_000_000), device="cpu")
.classes`; with `--rates`, also those of the 400 MHz and 1.6 GHz (256
frames a block) decodes at WIDE_RUN. Each gets `inputs`: DQPSK bursts
from the unique word on, with a residual CFO, a phase, a timing offset,
8-30 dB of noise and random lengths (0, 3, 4 and L among them), zero
past each length as the downmix leaves them.

For each shape, in both modes (Gardner and `--no-gardner`), the kernel
(`loop` on the card) is held against `loop_plain` on the same inputs: the
valid flags equal, the output within 1e-4 of each burst's peak magnitude,
the summed corrections within rtol 1e-4, atol 1e-5; and `Demod.decide`
on both gives equal ok, direction, n_symbols, confidence and bits, and
level, total_phase and LLRs within rtol 1e-4, atol 1e-5. Each row says
whether output, flags and corrections are bit-equal (`bit_equal`) and
the first symbol where any burst's output parts (`first_diff`, -1 when
none does). Then the tool times the kernel (median single call, and a
call in a run of calls back to back), the plain loop run eagerly, and,
in Gardner mode, the plain loop captured as a CUDA graph (its nodes,
capture seconds and replay ms), and prints ns per symbol step (the
kernel's time over S: the bursts' chains of S steps run side by side)
beside the chain bound of a step (`chain_ns`: `tools/sass_chain.py`
from the build's SASS) and the build's `ptxas -v` registers, stack frame
and spills per kernel function. The bound counts the bytes this run's
data needs (the samples below each length read once, the outputs
written once) at 3.35 TB/s.

`--source PATH` (card only, repeatable) builds another source of the
kernel under the git-ignored build/ (`tools/variants.py`) and times it
beside the package's on the same inputs; a source whose entry takes no
plan (the one-thread design, a thread a burst: `git show
<commit>:iridium_tpu_torch/csrc/demod_loop.cu > build/one.cu`) gets an
adapter. `--probes` adds, for each such source, its probed copies
(PROBES: without the PLL; rows read from shared memory; the PLL alone
on a made-up symbol), which are compared but not held to the limits.

`--classes` (card only): the production 10 MHz pipeline decodes the
first group (4 blocks) of `tools/captures.py`'s dense capture twice, once
as the package runs it and once with `loop_plain` in the kernel's place
(this tool's swap; the package has no switch), and prints each class
graph's nodes, capture and instantiate seconds and replay ms, and each
decode's wall (its first, which captures the graphs, and a second on
them, with its group stages): the class graphs before and after the
kernel, in one process. Both ways it also lists the device operations
that take the small-normal replay's time (torch.profiler) and times that
batch's stages each as a graph of its own (`stage_graphs`).

On the CPU (`--small`: 9 bursts of 400 samples, 40 symbols) `loop` is
`loop_plain`, and times are the host clock's.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import _kernels, device as device_mod, iridium
from ..config import DetectorConfig
from ..dsp import demod
from ..io import synth
from . import variants
from .exp_block_gather import time_gather
from .exp_frontend import HBM_BYTES_PER_S
from .exp_window_gather import samples_ms

SEED = 1240
CLASS_NAMES = ("small_normal", "small_simplex", "large")
SMALL = (dict(shape="small", B=9, L=400, S=40, sps=10.0),)
# the wideband decodes' batches (chip_smoke.py's WIDE_400_RUN)
WIDE_RUN = dict(burst_batch=16, agg_blocks=1, group_jobs=1)
OUT_REL = 1e-4            # |out err| / the burst's peak |out|
RTOL, ATOL = 1e-4, 1e-5   # total, level, total_phase, llr
INT_FIELDS = ("ok", "direction", "n_symbols", "confidence", "bits")
FLOAT_FIELDS = ("level", "total_phase", "llr")
# FP32 operations a symbol step (counted from the source: two Catmull-Rom
# reads, the timing error and the PLL step; --no-gardner the PLL alone),
# with atan2f, cosf, sinf and hypotf at ~20 each
OPS_PER_STEP = {True: 150, False: 110}
FP32_FLOP_PER_S = 67e12


def class_shapes(rate_mhz: float = 10.0, frames_per_block: int | None = None,
                 **pipe_kw) -> list[dict]:
    """The three class batches of the group program at `rate_mhz` (the
    production 10 MHz one by default; `frames_per_block` where given, the
    Pipeline's arguments `pipe_kw`): the demodulator's (B, L, S, sps) and
    the downmix's decimated length `dec_cap`."""
    from ..runtime.pipeline import Pipeline
    det = dict(sample_rate=int(round(rate_mhz * 1e6)))
    if frames_per_block is not None:
        det["frames_per_block"] = frames_per_block
    pipe = Pipeline(det_cfg=DetectorConfig(**det), device="cpu", **pipe_kw)
    return [dict(rate_mhz=rate_mhz, shape=name, B=c.batch,
                 L=c.downmix.max_frame_cap, S=c.demod.S, sps=c.demod.sps,
                 dec_cap=c.dec_cap)
            for name, c in zip(CLASS_NAMES, pipe.classes)]


def decode_shapes(rate_mhz: float) -> list[dict]:
    """The class batches of the decode at `rate_mhz`: the production 10
    MHz group program, or the wideband decodes' (400 MHz, and 1.6 GHz at
    256 frames a block) at WIDE_RUN."""
    if rate_mhz == 10.0:
        return class_shapes()
    fpb = 256 if rate_mhz == 1600.0 else None
    return class_shapes(rate_mhz, fpb, **WIDE_RUN)


def inputs(B: int, L: int, sps: float, seed: int, cfo_hz: float = 300.0):
    """(x (B, L) c64, n_samples (B,) i64, direction (B,) i32) as numpy:
    DL bursts from the unique word on (16 payloads, reused), each with a
    residual CFO of up to `cfo_hz`, a phase, a timing offset of up to 4
    samples and noise at 8-30 dB; half of them end mid-row (noise after
    them). Lengths are uniform in [L/4, L], the first five 0, 3, 4, L and
    1; samples from each length on are zero."""
    rng = np.random.default_rng(seed)
    isps = int(round(sps))
    lead = iridium.PREAMBLE_LENGTH_SHORT * isps
    waves = []
    for _ in range(min(B, 16)):
        bits = rng.integers(0, 2, 2 * (L // isps + 8)).astype(np.uint8)
        waves.append(synth.modulate(synth.burst_symbols(bits), sps=isps))
    n = rng.integers(L // 4, L + 1, B)
    n[:5] = [0, 3, 4, L, 1][:B]
    x = np.zeros((B, L), np.complex64)
    t = np.arange(L)
    for b in range(B):
        w = waves[b % len(waves)]
        off = int(rng.integers(-4, 5))
        sig = w[lead + off:lead + off + L]
        cfo = rng.uniform(-cfo_hz, cfo_hz) / (isps
                                              * iridium.SYMBOLS_PER_SECOND)
        rot = np.exp(1j * (2 * np.pi * cfo * t[:len(sig)]
                           + rng.uniform(0, 2 * np.pi)))
        row = np.zeros(L, np.complex128)
        row[:len(sig)] = sig * rot
        if rng.random() < 0.5:
            row[int(rng.integers(L // 2, L + 1)):] = 0
        sigma = 10.0 ** (-rng.uniform(8.0, 30.0) / 20.0) / np.sqrt(2.0)
        row += sigma * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        row[n[b]:] = 0
        x[b] = row
    direction = rng.integers(0, 2, B).astype(np.int32)
    return x, n.astype(np.int64), direction


def compare_loop(got, want, check: bool = True) -> dict:
    """The kernel's loop output against the plain loop's: raises past the
    limits (unless `check` is false: a probe's); returns the errors, the
    bursts that part from it and the first symbol where any does
    (`first_diff`, -1 when `bit_equal`)."""
    (go, gv, gt), (wo, wv, wt) = got, want
    peak = wo.abs().amax(1)
    err = (go - wo).abs().amax(1)
    t_err = (gt - wt).abs()
    res = dict(valid_equal=bool(torch.equal(gv, wv)),
               out_max_abs_err=float(err.max()),
               out_max_rel_err=float((err / peak.clamp_min(1e-30)).max()),
               total_max_abs_err=float(t_err.max()),
               out_bit_equal=bool(torch.equal(go, wo)),
               total_bit_equal=bool(torch.equal(gt, wt)))
    differ = (go != wo).any(1)
    first = torch.where(differ, (go != wo).int().argmax(1), -1)
    res["parted"] = [[b, int(first[b])]
                     for b in torch.nonzero(differ).flatten().tolist()[:20]]
    res["n_parted"] = int(differ.sum())
    res["first_diff"] = (int(first[differ].min()) if res["n_parted"]
                         else -1)
    res["bit_equal"] = (res["valid_equal"] and res["out_bit_equal"]
                        and res["total_bit_equal"])
    if not check:
        return res
    bad = []
    if not res["valid_equal"]:
        bad.append("valid")
    if not bool((err <= OUT_REL * peak).all()):
        bad.append(f"out (max {res['out_max_rel_err']:.3g} of the peak)")
    if not bool((t_err <= ATOL + RTOL * wt.abs()).all()):
        bad.append(f"total (max |err| {res['total_max_abs_err']:.3g})")
    if bad:
        raise AssertionError("demod loop against loop_plain: "
                             + ", ".join(bad) + f"; parted {res['parted']}")
    return res


def compare_demod(got: demod.DemodOut, want: demod.DemodOut) -> dict:
    """Demod's fields with the kernel against those with the plain loop:
    raises past the limits; returns the float fields' max |err|."""
    for name in INT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            raise AssertionError(f"Demod {name}: {int((a != b).sum())} "
                                 "values differ with the kernel")
    res = {}
    for name in FLOAT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        res[f"{name}_max_abs_err"] = (float((a - b).abs().max())
                                      if a.numel() else 0.0)
    return res


def bound(n: torch.Tensor, B: int, L: int, S: int, use_gardner: bool
          ) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes): the samples this data needs read
    once (Gardner: each row below its length; --no-gardner: the S strided
    samples), the lengths, the outputs (c64 + u8 a symbol, f32 a burst)
    written once; against the FP32 operations of B x S steps."""
    read = (8 * int(n.clamp(0, L).sum()) if use_gardner else 8 * B * S)
    n_bytes = read + 8 * B + 9 * B * S + 4 * B
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = OPS_PER_STEP[use_gardner] * B * S / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes", n_bytes) if t_b >= t_o else (t_o, "operations",
                                                       n_bytes)


def plain_graph(fn) -> dict:
    """`fn` captured as a CUDA graph (pipeline.Captured): nodes, capture
    and instantiate seconds, replay ms (median of 3 after a warm-up)."""
    from ..runtime.pipeline import Captured
    c = Captured()
    c.replay(fn)
    torch.cuda.synchronize()
    replay = statistics.median(samples_ms(c.graph.replay,
                                          torch.device("cuda"), 3))
    res = dict(nodes=c.nodes, capture_s=c.capture_s,
               instantiate_s=c.instantiate_s, replay_ms=replay)
    del c
    return res


def run_shape(sh: dict, dev: torch.device, graphs: bool = True,
              reps: int = 7, cands=None, lat: dict | None = None
              ) -> list[dict]:
    """Both modes at one shape, one dict a mode and design: each of
    `cands` ((name, kernel, checked) from `candidates`; the package's
    kernel alone by default) held to `loop_plain` (a probe, `checked`
    false, only compared), then timed beside the plain loop and, on the
    card, the chain bound of a step (`sass_chain.chain_bound` with the
    latencies `lat`, measured here unless given)."""
    from . import sass_chain
    B, L, S, sps = sh["B"], sh["L"], sh["S"], sh["sps"]
    cands = cands or [("package", _kernels.DEMOD_LOOP, True)]
    if dev.type == "cuda" and lat is None:
        lat = sass_chain.latencies(dev)
    x, n, direction = inputs(B, L, sps, SEED + B + L)
    x = torch.from_numpy(x).to(dev)
    n = torch.from_numpy(n).to(dev)
    direction = torch.from_numpy(direction).to(dev)
    b_ms = {g: bound(n, B, L, S, g) for g in (True, False)}
    out = []
    for use_gardner in (True, False):
        dm = demod.Demod(S, sps, use_gardner, dev)
        args = (x, n, sps, S, use_gardner)
        want = demod.loop_plain(*args)
        plain = statistics.median(samples_ms(
            lambda: demod.loop_plain(*args), dev, 1 if dev.type == "cuda"
            else 2))
        mode = dict(rate_mhz=sh.get("rate_mhz"), shape=sh["shape"], B=B,
                    L=L, S=S, sps=sps,
                    mode="gardner" if use_gardner else "no_gardner")
        for name, kern, checked in cands:
            res = dict(mode, design=name)
            with variants.swapped("DEMOD_LOOP", kern):
                got = demod.loop(*args)
                res.update(compare_loop(got, want, checked))
                if checked:
                    res.update(compare_demod(dm.decide(*got, direction),
                                             dm.decide(*want, direction)))
                del got
                fn = lambda: demod.loop(*args)  # noqa: E731
                ms = statistics.median(samples_ms(fn, dev, reps))
                chained = time_gather(fn, dev, reps)
            t_b, b_by, n_bytes = b_ms[use_gardner]
            res.update(ms=ms, chained_ms=chained,
                       ns_per_step=chained * 1e6 / max(S, 1),
                       plain_ms=plain, bound_ms=t_b, bound_by=b_by,
                       bound_bytes=n_bytes, share_of_bound=t_b / ms,
                       library_ms=None)
            c_ns = (sass_chain.chain_bound(kern, use_gardner, lat)
                    if dev.type == "cuda" else None)
            if c_ns is not None:
                res.update(chain_ns=c_ns, chain_bound_ms=c_ns * S / 1e6,
                           chained_share_of_chain=c_ns * S / 1e6 / chained)
            out.append(res)
        if graphs and use_gardner and dev.type == "cuda":
            out[-len(cands)]["plain_graph"] = plain_graph(
                lambda: demod.loop_plain(*args))
            gc.collect()
            torch.cuda.empty_cache()
        del want
    return out


def _planned(text: str) -> bool:
    head = text[text.index('extern "C" int demod_loop('):]
    return "ring" in head[:head.index(")")]


def adapted(text: str) -> str:
    """A source whose `demod_loop` entry takes no plan (the one-thread
    design),
    behind an entry with the package's argument list."""
    if _planned(text) or not _planned(_kernels.DEMOD_LOOP.source.read_text()):
        return text
    text = text.replace('extern "C" int demod_loop(',
                        'extern "C" int demod_loop_unplanned(', 1)
    return text + """
extern "C" int demod_loop(const float2* x, long long L,
                          const long long* n_samp, int B, int S, float sps,
                          float half, int isps, int gardner, int bursts,
                          int ring, int chunk, int threads, float2* out,
                          unsigned char* valid, float* total,
                          cudaStream_t stream) {
  return demod_loop_unplanned(x, L, n_samp, B, S, sps, half, isps, gardner,
                              out, valid, total, stream);
}
"""


# Probes of the one-thread design (a thread a burst walks both chains,
# rows read through L1; the kernel's first design, in the git history):
# each edits that source's text, to split a step's time between its parts.
GARDNER_LOOP = ("  for (int t = 0; t < S; ++t) {\n"
                "    const bool active = !done && pos < lim;")
GARDNER_HEAD = ("  const int b = blockIdx.x * kThreads + threadIdx.x;\n"
                "  if (b >= B) return;\n"
                "  const float2* row = x + (long long)b * L;\n")


def _index(text: str, old: str, start: int = 0) -> int:
    if old not in text[start:]:
        raise ValueError(f"probe: {old.strip()[:60]!r} is not in the "
                         "source (the probes edit the one-thread "
                         "design)")
    return text.index(old, start)


def _edit(text: str, old: str, new: str) -> str:
    i = _index(text, old)
    return text[:i] + new + text[i + len(old):]


def probe_no_pll(text: str) -> str:
    """(b) the PLL step removed: the timing chain alone (--no-gardner:
    the strided loads and stores alone)."""
    text = _edit(text, "const cf y = pll.step(on, active);",
                 "const cf y = on;")
    return _edit(text, "const cf y = pll.step({s.x, s.y}, v);",
                 "const cf y = {s.x, s.y};")


def probe_pll_alone(text: str) -> str:
    """(d) the PLL alone, fed a precomputed `on` (a drifting phasor from
    the row's first sample; active while t * sps < n - 3)."""
    i = _index(text, GARDNER_LOOP)
    j = _index(text, "  total[b] = pll.total;", i)
    return text[:i] + """  const float2 s0 = __ldg(row);
  for (int t = 0; t < S; ++t) {
    const bool active = (float)t * sps < lim;
    const cf on = {s0.x + (float)t * 1e-3f, s0.y - (float)t * 1e-3f};
    const cf y = pll.step(on, active);
    o[t] = make_float2(y.re, y.im);
    vo[t] = active;
  }
""" + text[j:]


def probe_smem_rows(text: str) -> str:
    """(c) each burst's row read from shared memory: a block of as many
    bursts as rows fit in 227 KB (at most 32), its rows copied in by 256
    threads before the walk (one thread a burst walks, as before); the
    arithmetic unchanged."""
    text = re.sub(r"__ldg\(row \+ base( \+ \d)?\)", r"row[base\1]", text)
    text = _edit(text, "__global__ void __launch_bounds__(kThreads)\n"
                 "gardner_kernel(", "__global__ void __launch_bounds__(256)\n"
                 "gardner_kernel(")
    text = _edit(text, GARDNER_HEAD, """  extern __shared__ float2 srow[];
  const int P = (int)min(232448LL / (L * 8), (long long)kThreads);
  const int b = blockIdx.x * P + threadIdx.x;
  for (long long i = threadIdx.x; i < (long long)P * L; i += blockDim.x) {
    const long long g = (long long)blockIdx.x * P * L + i;
    if (g < (long long)B * L) srow[i] = x[g];
  }
  __syncthreads();
  if (threadIdx.x >= P || b >= B) return;
  const float2* row = srow + (long long)threadIdx.x * L;
""")
    return _edit(text, """  if (gardner)
    gardner_kernel<<<grid, kThreads, 0, stream>>>(""", """  const long long fit = 232448 / (L * 8);
  const int rows = fit < kThreads ? (int)fit : kThreads;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  if (gardner) {
    const cudaError_t e = cudaFuncSetAttribute(
        gardner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        rows * (int)L * 8);
    if (e != cudaSuccess) return (int)e;
  }
  if (gardner)
    gardner_kernel<<<(B + rows - 1) / rows, 256, (size_t)rows * L * 8,
                     stream>>>(""")


PROBES = {"no_pll": probe_no_pll, "smem_rows": probe_smem_rows,
          "pll_alone": probe_pll_alone}


def candidates(sources=(), probes: bool = False) -> list[tuple]:
    """[(name, kernel, checked)]: the package's kernel, a Variant per
    source (`adapted`) and, with `probes`, each source's PROBES copies
    (not checked), all built at once (one nvcc each)."""
    cands = [("package", _kernels.DEMOD_LOOP, True)]
    for src in sources:
        text = Path(src).read_text()
        cands.append((str(src), variants.Variant(_kernels.DEMOD_LOOP,
                                                 adapted(text)), True))
        if probes:
            cands += [(f"{src}:{name}", variants.Variant(
                _kernels.DEMOD_LOOP, adapted(edit(text))), False)
                for name, edit in PROBES.items()]
    with concurrent.futures.ThreadPoolExecutor(len(cands)) as pool:
        for fut in [pool.submit(k.build) for _, k, _ in cands]:
            fut.result()
    return cands


PTXAS_FN = re.compile(r"Function properties for (\S+)")
PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(kernel: _kernels.Kernel) -> dict:
    """{kernel function: dict(registers, stack_frame, spill_stores,
    spill_loads)} from the `ptxas -v` report its build kept."""
    from .sass_chain import short_name
    out, cur = {}, None
    for ln in kernel.ptxas_path().read_text().splitlines():
        if m := PTXAS_FN.search(ln):
            cur = (out.setdefault(short_name(m.group(1)), {})
                   if "kernel" in m.group(1) else None)
        elif cur is None:
            continue
        elif m := PTXAS_FRAME.search(ln):
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif m := PTXAS_REGS.search(ln):
            cur["registers"] = int(m.group(1))
    return out


def product_forms(dev: torch.device, n: int = 1 << 20) -> dict:
    """What the kernel's arithmetic assumes of PyTorch on the card, on n
    random complex pairs: the share of PyTorch's complex products whose
    real part is fma(a, c, -(b d)) and imaginary part fma(a, d, b c) (the
    kernel's `cmul`; b d and b c rounded), against a c - b d and a d + b c
    rounded at each step; and the share of complex magnitudes equal to
    torch.hypot (hypotf). The fused forms are computed in f64 and rounded
    once to f32 (exact but for a double rounding, rare)."""
    rng = np.random.default_rng(SEED)
    a, b = (rng.standard_normal((2, n)).astype(np.float32) for _ in "ab")
    x = torch.from_numpy(a).to(dev)
    y = torch.from_numpy(b).to(dev)
    xc, yc = torch.complex(x[0], x[1]), torch.complex(y[0], y[1])
    got = torch.view_as_real(xc * yc).cpu().numpy()
    mag = xc.abs()
    hyp = float((mag == torch.hypot(x[0], x[1])).float().mean())
    (ar, ai), (br, bi), d = a, b, np.float64

    def share(want, col):
        return float((want.astype(np.float32) == got[:, col]).mean())
    return dict(
        fused_re=share(ar.astype(d) * br - ai * bi, 0),
        fused_im=share(ar.astype(d) * bi + ai * br, 1),
        rounded_re=share(ar * br - ai * bi, 0),
        rounded_im=share(ar * bi + ai * br, 1),
        abs_is_hypot=hyp)


@contextlib.contextmanager
def plain_in_place():
    """`loop_plain` wherever the package calls `demod.loop`."""
    saved = demod.loop
    demod.loop = demod.loop_plain
    try:
        yield
    finally:
        demod.loop = saved


def replay_top(c, dev: torch.device, reps: int = 3, top: int = 8
               ) -> tuple[list, float]:
    """torch.profiler over `reps` replays of a captured graph: its device
    operations with the most device time, as (name, ms a replay, launches
    a replay), and the device ms of all its operations a replay."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            c.graph.replay()
        torch.cuda.synchronize(dev)
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return ([(e.key[:70], e.self_device_time_total / 1e3 / reps,
              e.count / reps) for e in ops[:top]],
            sum(e.self_device_time_total for e in ops) / 1e3 / reps)


def stage_graphs(pipe, g, dev: torch.device) -> dict:
    """Each stage of the small-normal class batch as a CUDA graph of its
    own, on the inputs it had in one eager run of the group program on the
    graph `g`'s buffers (the first call of each stage is that class's):
    the front-end, the downmix (with its FIR launches, `noise_box` and
    `frame_rrc`, also alone), the demod loop and its tail
    (`Demod.decide`), the packing; per stage its nodes and replay ms
    (median of 5)."""
    from ..dsp import downmix
    from ..ops import fused_frontend
    from ..runtime import pipeline
    targets = {"frontend": (fused_frontend, "fused"),
               "downmix": (downmix.Downmix, "forward"),
               "noise_box": (downmix, "noise_box"),
               "frame_rrc": (downmix, "frame_rrc"),
               "demod_loop": (demod, "loop"),
               "demod_tail": (demod.Demod, "decide"),
               "pack": (pipeline, "pack_outputs")}
    saved = {k: getattr(obj, name) for k, (obj, name) in targets.items()}
    first = {}

    def keep(k, fn):
        def wrapped(*args, **kw):
            first.setdefault(k, (args, kw))
            return fn(*args, **kw)
        return wrapped
    try:
        for k, (obj, name) in targets.items():
            setattr(obj, name, keep(k, saved[k]))
        pipe.group_program(g.planes, g.tables, g.scal, g.scal[1:].tolist())
        torch.cuda.synchronize(dev)
    finally:
        for k, (obj, name) in targets.items():
            setattr(obj, name, saved[k])
    out = {}
    for k, (args, kw) in first.items():
        c = pipeline.Captured()
        c.replay(lambda fn=saved[k], args=args, kw=kw: fn(*args, **kw))
        out[k] = dict(nodes=c.nodes, replay_ms=statistics.median(
            samples_ms(c.graph.replay, dev, 5)))
        del c
    return out


def class_graphs(dev: torch.device, swap=plain_in_place) -> dict:
    """The production 10 MHz pipeline's class graphs of a 4-block group
    (the dense capture's first), captured as the package runs them
    ("kernel") and under the context `swap` ("plain": `loop_plain` in the
    loop kernel's place by default; tools/exp_downmix.py passes its own):
    per class its nodes, capture and instantiate seconds, replay ms; each
    decode's wall, the first (captures included) and a second on the
    captured graphs, with the second's group stages; the device
    operations that take the small-normal replay's time; and the
    small-normal batch's stages as graphs of their own (`stage_graphs`)."""
    from ..runtime.pipeline import Pipeline
    from .captures import PROD, dense_capture
    cap, _ = dense_capture(SEED)
    group = cap[:4 * PROD["frames_per_block"] * 8192]
    del cap
    res = {}
    for name, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", swap)):
        pipe = Pipeline(det_cfg=DetectorConfig(**PROD), device=dev,
                        want_llr=False)
        with ctx():
            t = time.perf_counter()
            lines = sum(1 for _ in pipe.run_array(group))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            pipe.reset()
            t = time.perf_counter()
            again = sum(1 for _ in pipe.run_array(group))
            torch.cuda.synchronize()
            warm = time.perf_counter() - t
            g = pipe.graphs[4]
            g.scal[1:] = 0              # the first round: every class runs
            by_stage = stage_graphs(pipe, g, dev)
        if again != lines:
            raise AssertionError(f"{name}: {again} lines on the captured "
                                 f"graphs against {lines}")
        stages = {k: pipe.timing[k] for k in (
            "step_dispatch", "group_dispatch", "result_fetch_wait",
            "n_overflow_rounds")}
        parts = {}
        for cname, c in zip(("route",) + CLASS_NAMES, g.parts):
            if c.graph is None:
                continue
            parts[cname] = dict(
                nodes=c.nodes, capture_s=c.capture_s,
                instantiate_s=c.instantiate_s,
                replay_ms=statistics.median(samples_ms(c.graph.replay, dev,
                                                       5)))
        top, device_ms = replay_top(g.parts[1], dev)
        res[name] = dict(lines=lines, first_decode_s=wall,
                         warm_decode_s=warm, warm_stages=stages, parts=parts,
                         small_normal_top=top,
                         small_normal_device_ms=device_ms,
                         small_normal_stages=by_stage)
        del pipe, g, c
        gc.collect()
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_demod",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--rates", default="10",
                    help="comma-separated decodes whose class batches to "
                    "run, in MHz: 10, 400, 1600")
    ap.add_argument("--source", action="append", default=[],
                    help="time the package's kernel beside this kernel "
                    "source, repeatable (card only)")
    ap.add_argument("--probes", action="store_true",
                    help="also time each --source's probed copies (of "
                    "the one-thread design: no_pll, smem_rows, pll_alone)")
    ap.add_argument("--classes", action="store_true",
                    help="the pipeline's class graphs with the kernel and "
                    "with the plain loop (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if (args.classes or args.source) and dev.type != "cuda":
        ap.error("--classes and --source need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    cands = lat = None
    if dev.type == "cuda":
        from .sass_chain import latencies
        lat = latencies(dev)
        print("latencies " + json.dumps(lat), flush=True)
        cands = candidates(args.source, args.probes)
        for cname, k, _ in cands:
            print(f"ptxas {cname} " + json.dumps(ptxas_summary(k)),
                  flush=True)
        print("products " + json.dumps(product_forms(dev)), flush=True)
    shapes = (SMALL if args.small else
              [sh for r in args.rates.split(",")
               for sh in decode_shapes(float(r))])
    for sh in shapes:
        for r in run_shape(sh, dev, reps=3 if args.small else 7,
                           cands=cands, lat=lat):
            print(f"{r['shape']} {r['B']} x {r['L']} x {r['S']} {r['mode']}: "
                  f"{r['design']} {r['ms']:.4f} ms (chained "
                  f"{r['chained_ms']:.4f}, {r['ns_per_step']:.1f} ns a "
                  f"step), bit-equal {r['bit_equal']}, plain "
                  f"{r['plain_ms']:.2f}, bound {r['bound_ms']:.5f} "
                  + json.dumps(r), flush=True)
    if args.classes:
        print("class_graphs " + json.dumps(class_graphs(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
