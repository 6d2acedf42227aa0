"""Detector-scan timing inputs and per-phase breakdown on the card.

    python -m iridium_tpu_torch.tools.exp_scan [--fft F] [--source PATH ...]

Three |X|^2 blocks at the production shape (2,048 frames x 8,192 bins,
10 MHz; with `--fft 16384`, `32768`, `65536`, `131072` or `262144` the
derived 20, 25, 50, 100 or 200 MHz configuration, 1,024 frames, which the
kernel runs as a cluster of 2, 4, 8 or 16 blocks of 8,192 bins, and at
262,144 of 16 blocks of 16,384; with `--fft 524288` or `1048576` the 400
or 800 MHz one, a grid of 4 clusters of 16 blocks of 8,192 or 16,384
bins; with `--fft 2097152` or `4194304` the 1.6 or 3.2 GHz one at 512
or 256 frames, the tiled grid of 7 clusters of 16 blocks of 2 or 3 tiles:
`detect_scan.layout`, printed), each with the state it starts from:
  - `synthetic`: tone bursts (one longer than max_burst_len) and a comb
    blast that trips the squelch, from frame 600, from a fresh state (its
    first 512 frames prime the noise history; at 512 frames or fewer the
    block is noise that primes it);
  - `noise`: exponential noise only, after primed noise blocks;
  - `dense`: noise with ~0.21 burst creations per frame (~430 bursts of
    8-14 frames at random bins, as a 10 MHz band at ~260 detections/s
    gives), after the same primed block, so ~6 bursts are active at once.

The tool builds a copy of csrc/detect_scan.cu (or of `--source`) under
build/ in which every `// phase: NAME` comment of the kernel becomes a
clock64() probe on thread 0 (of the cluster's first block), runs it on
the three inputs and prints, per input, the kernel's uninstrumented
microseconds per frame and the share of thread 0's cycles spent in each
phase, with the build's `ptxas -v` register and spill report (`spills`,
per instantiation). The committed kernel carries no probe. A `--source`
must have the package's `detect_scan` entry point (the layout, the halo
and the grid scratch) and take the layout `detect_scan.layout` gives.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _kernels
from ..config import DetectorConfig
from ..dsp import detect_scan, state as st
from . import variants
from .exp_block_gather import single_ms

SEED = 1234
PROD = dict(sample_rate=10_000_000, frames_per_block=2048,
            gone_capacity=2048)
# the configuration timed at each FFT size: the production one at 8192,
# the derived configurations of the sample rates that give the others
CONFIGS = {8192: PROD, 16384: dict(sample_rate=20_000_000),
           32768: dict(sample_rate=25_000_000),
           65536: dict(sample_rate=50_000_000),
           131072: dict(sample_rate=100_000_000),
           262144: dict(sample_rate=200_000_000),
           524288: dict(sample_rate=400_000_000),
           1048576: dict(sample_rate=800_000_000),
           # tiled (2 and 3 tiles a block); fewer frames keep a block
           # under 2^31 samples
           2097152: dict(sample_rate=1_600_000_000, frames_per_block=512),
           4194304: dict(sample_rate=3_200_000_000, frames_per_block=256)}

PROBES = """
__device__ unsigned long long g_phase_cycles[16];
__device__ unsigned long long g_phase_count[16];
#define PHASE_PROBE(k)                                                  \\
  do {                                                                  \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {                          \\
      const long long t_ = clock64();                                   \\
      atomicAdd(&g_phase_cycles[pc_], (unsigned long long)(t_ - pt_));  \\
      atomicAdd(&g_phase_count[pc_], 1ull);                             \\
      pt_ = t_;                                                         \\
      pc_ = (k);                                                        \\
    }                                                                   \\
  } while (0)
"""

READER = """
extern "C" int {entry}_phases(unsigned long long* cycles,
                              unsigned long long* count) {{
  static const unsigned long long zero[16] = {{}};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(count, g_phase_count, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_phase_count, zero, sizeof zero);
  return (int)e;
}}
"""

MARK = re.compile(r"^(\s*)// phase: (\w+)\s*$", re.M)


def production_params(fft: int = 8192):
    return DetectorConfig(**CONFIGS[fft]).derived()


def synthetic_spectrogram(p, gen):
    """(frames, F) |X|^2 with exponential noise, tone bursts (one longer
    than max_burst_len), and a comb blast that trips the squelch with more
    than E_SQ emissions, then a mass deletion."""
    F, n = p.fft_size, p.frames_per_block
    dev = gen.device
    mag2 = torch.empty((n, F), device=dev).exponential_(generator=gen)
    long_frames = int(p.max_burst_len / F) + 20
    bursts = [(600, 40, 1000), (640, 30, 2500), (700, long_frames, 6000),
              (720, 10, 6050), (900, 25, 7000)]
    for f0, nf, b in bursts:
        mag2[f0:f0 + nf, b - 2:b + 3] += 2000.0
    # comb: one peak every 2*half_bw+2 bins, for long enough that more
    # than max_bursts bursts are active at once (4 creations per frame)
    step = p.burst_width_bins + 2
    n_blast = p.max_bursts // 4 + 20
    comb = torch.arange(p.burst_width_bins, F - p.burst_width_bins, step,
                        device=dev)
    comb = comb[(comb - F // 2).abs() > 8]
    mag2[1100:1100 + n_blast, comb] += 3000.0
    return mag2


def dense_spectrogram(p, gen, per_frame: float = 0.21):
    """Noise with ~per_frame burst starts per frame: 5-bin tones of 8-14
    frames at random eligible bins away from DC."""
    F, n = p.fft_size, p.frames_per_block
    dev = gen.device
    mag2 = torch.empty((n, F), device=dev).exponential_(generator=gen)
    k = int(round(per_frame * n))
    hb = p.burst_width_bins // 2
    f0 = torch.randint(0, n - 14, (k,), device=dev, generator=gen).tolist()
    nf = torch.randint(8, 15, (k,), device=dev, generator=gen).tolist()
    bins = torch.randint(hb + 2, F - hb - 2, (k,), device=dev,
                         generator=gen).tolist()
    for a, m, b in zip(f0, nf, bins):
        if abs(b - F // 2) <= 8:
            b += 16
        mag2[a:a + m, b - 2:b + 3] += 2000.0
    return mag2


def edge_spectrogram(p, seed: int, squelch: bool = True) -> np.ndarray:
    """(frames_per_block, F) f32 |X|^2 (numpy) for F = 8192 that works the
    places where bin ownership changes (multiples of 8 and of F / 8),
    starting 8 frames after the history is primed: a 3-bin burst across
    bin 1024; a 2-bin burst across 5120; a burst at 6143 that moves to
    6144 (kept alive by the +-1-bin dilation across the edge); two
    candidates of exactly equal magnitude at 3071 and 3072 on a flat
    noise floor (equal sums, so the lower bin must win); with `squelch`,
    a comb of peaks every 40 bins that trips the squelch."""
    F, n, t0 = p.fft_size, p.frames_per_block, p.history_size + 8
    rng = np.random.default_rng(seed)
    mag2 = rng.exponential(size=(n, F)).astype(np.float32)
    mag2[:, 3040:3104] = 1.0
    for f0, f1, bins in [(t0, t0 + 6, [3071, 3072]),
                         (t0 + 2, t0 + 14, [1023, 1024, 1025]),
                         (t0 + 4, t0 + 8, [6143]),
                         (t0 + 8, t0 + 24, [6144]),
                         (t0 + 10, t0 + 16, [5119, 5120])]:
        mag2[f0:f1, bins] += 300.0
    if squelch:
        comb = np.arange(40, F - 40, 40)
        comb = comb[np.abs(comb - F // 2) > 8]
        mag2[t0 + 30:t0 + 50, comb] += 800.0
    return mag2


def cluster_edge_spectrogram(p, seed: int, gen=None, t0: int | None = None):
    """(frames_per_block, F) f32 |X|^2 (numpy) for a shape the kernel runs
    as a cluster (`detect_scan.block_edges`: every FB bins: the block
    edges and, tiled, the tile edges) that works the edges between its
    blocks and tiles, from t0 (default: 8 frames after the history is
    primed). At the DC edge (F / 2, an edge whenever the cluster has 2
    blocks or F splits evenly): a burst just below the +-3-bin notch, and
    one just above it that the first one's mask holds back until its
    release (read from the other block's gone list). At every other edge
    e, on a flat noise floor: two candidates of exactly equal magnitude at
    e - 1 and e (the lower must win), then e alone, which keeps the burst
    at e - 1 alive through the +-1-bin dilation across the edge; later a
    3-bin burst across e. Then a comb of peaks every 40 bins that trips
    the squelch (with max_bursts 20, more than E_SQ emissions: drops).
    With `gen` (a torch.Generator) a tensor on its device, the noise drawn
    there (a block of a tiled shape is gigabytes)."""
    F, n = p.fft_size, p.frames_per_block
    t0 = p.history_size + 8 if t0 is None else t0
    edges = detect_scan.block_edges(F) if F % 128 == 0 else []
    if not edges or t0 + 80 > n:
        raise ValueError(f"F {F}, {n} frames: no cluster edges to work")
    if gen is None:
        rng = np.random.default_rng(seed)
        mag2 = rng.exponential(size=(n, F)).astype(np.float32)
    else:
        mag2 = torch.empty((n, F), device=gen.device).exponential_(
            generator=gen)
    dc = F // 2
    for e in edges:
        if e == dc:
            mag2[t0:t0 + 6, dc - 6:dc - 3] += 300.0
            mag2[t0 + 2:t0 + 34, dc + 4:dc + 7] += 300.0
            continue
        mag2[:, e - 32:e + 32] = 1.0
        mag2[t0:t0 + 6, e - 1:e + 1] += 300.0
        mag2[t0 + 6:t0 + 20, e] += 300.0
        mag2[t0 + 40:t0 + 52, e - 1:e + 2] += 300.0
    comb = np.arange(40, F - 40, 40)
    comb = comb[np.abs(comb - dc) > 8]
    if gen is not None:
        comb = torch.from_numpy(comb).to(gen.device)
    mag2[t0 + 60:t0 + 80, comb] += 800.0
    return mag2


def shape_edge_spectrogram(p, seed: int) -> np.ndarray:
    """(frames_per_block, F) f32 |X|^2 (numpy) for any F the kernel takes:
    `cluster_edge_spectrogram`'s rows where `layout` gives a cluster; in
    one block, from 8 frames after the history is primed, a burst just
    below the DC notch and one just above it that the first one's mask
    holds back until its release; on a flat floor an exact tie across the
    thread edge at 4 BPT (the lower bin wins), kept alive through the
    dilation across it; a 3-bin burst over the last eligible bins (beside
    the idle threads of a padded layout); then the squelch comb."""
    C, _, _, bpt, _, _ = detect_scan.layout(p.fft_size)
    if C > 1:
        return cluster_edge_spectrogram(p, seed)
    F, n, t0 = p.fft_size, p.frames_per_block, p.history_size + 8
    hb = p.burst_width_bins // 2
    if t0 + 80 > n:
        raise ValueError(f"{n} frames are too few for the rows")
    rng = np.random.default_rng(seed)
    mag2 = rng.exponential(size=(n, F)).astype(np.float32)
    dc, e = F // 2, max(4 * bpt, hb + 8)
    mag2[t0:t0 + 6, dc - 6:dc - 3] += 300.0
    mag2[t0 + 2:t0 + 34, dc + 4:dc + 7] += 300.0
    mag2[:, e - 4:e + 4] = 1.0
    mag2[t0:t0 + 6, e - 1:e + 1] += 300.0
    mag2[t0 + 6:t0 + 20, e] += 300.0
    mag2[t0 + 10:t0 + 24, F - hb - 3:F - hb] += 300.0
    comb = np.arange(40, F - 40, 40)
    comb = comb[np.abs(comb - dc) > 8]
    mag2[t0 + 60:t0 + 80, comb] += 800.0
    return mag2


def long_burst_spectrogram(p, seed: int) -> np.ndarray:
    """(frames_per_block, F) f32 |X|^2 (numpy): noise and one 3-bin burst
    across bin F // 4 (a thread edge at every F) from 8 frames after the
    history is primed until 8 frames past max_burst_len, and no other
    burst: the frame of its long-burst deletion has none left active, so
    it runs the forced noise update and then the final one."""
    F, n, t0 = p.fft_size, p.frames_per_block, p.history_size + 8
    t1 = t0 + p.max_burst_len // F + 8
    if t1 + 8 > n:
        raise ValueError(f"{n} frames are too few for the burst")
    rng = np.random.default_rng(seed)
    mag2 = rng.exponential(size=(n, F)).astype(np.float32)
    mag2[t0:t1, F // 4 - 1:F // 4 + 2] += 300.0
    return mag2


def inputs(p, dev) -> list[tuple[str, torch.Tensor, st.ScanState]]:
    """[(name, mag2, start state)] of the three inputs. The primed state
    is the plain scan's after noise blocks that fill the history (one, or
    two where a block has fewer frames than the history has rows),
    rebased for the next block, so that every comparison with the kernel
    starts from a state the kernel did not make."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    fresh = st.init_state(p, dev)
    synth = synthetic_spectrogram(p, gen)
    primed = fresh
    while int(primed.ints[1]) < p.history_size:
        prime = torch.empty_like(synth).exponential_(generator=gen)
        primed = detect_scan.scan_plain(prime, primed, p.block_samples, p)
        st.rebase_(primed, p.block_samples)
        del prime
    noise = torch.empty_like(synth).exponential_(generator=gen)
    dense = dense_spectrogram(p, gen)
    return [("synthetic", synth, fresh), ("noise", noise, primed),
            ("dense", dense, primed)]


INT_FIELDS = ("a_valid", "a_id", "a_start", "a_last", "mask_count", "g_id",
              "g_start", "g_stop", "g_last", "g_bin", "ints",
              "baseline_sum", "baseline_hist")
DB_FIELDS = ("g_mag", "g_noise", "a_mag", "a_noise", "floats")


def compare(got: st.ScanState, want: st.ScanState) -> float:
    """Raise unless `got` equals `want` (the plain scan's): bit-equal in
    every integer field and in baseline_sum and baseline_hist, dB fields
    within rtol 1e-5. Returns the largest dB difference."""
    for name in INT_FIELDS:
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"scan: {name} differs from the plain scan")
    err = 0.0
    for name in DB_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        err = max(err, float((a - b).abs().max()))
    return err


def probed_source(text: str, entry: str = "detect_scan"
                  ) -> tuple[str, list[str]]:
    """The kernel source with its phase markers turned into probes and a
    reader `<entry>_phases` appended, and the phase names in probe-index
    order (0 = before the first marker)."""
    names = ["setup"]

    def sub(m):
        indent, name = m.group(1), m.group(2)
        if name == "begin":
            return f"{indent}long long pt_ = clock64();\n{indent}int pc_ = 0;"
        if name not in names:
            names.append(name)
        return f"{indent}PHASE_PROBE({names.index(name)});"

    body = MARK.sub(sub, text)
    head = "#include <cuda_runtime.h>\n"
    if head not in body:
        raise ValueError("source does not include cuda_runtime.h")
    body = body.replace(head, head + PROBES, 1) + READER.format(entry=entry)
    return body, names


def phases(kernel: variants.Variant) -> tuple[list[int], list[int]]:
    """Read and clear a probed build's per-phase cycles and entries."""
    fn = getattr(ctypes.CDLL(str(kernel.build())), f"{kernel.name}_phases")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    cyc = (ctypes.c_ulonglong * 16)()
    cnt = (ctypes.c_ulonglong * 16)()
    code = fn(cyc, cnt)
    if code != 0:
        raise RuntimeError(f"{kernel.name}_phases: CUDA error {code}")
    return list(cyc), list(cnt)


def ptxas_report(kernel: _kernels.Kernel) -> list[str]:
    """The `ptxas -v` lines on registers, shared memory and spills that
    the kernel's build kept beside its library."""
    kernel.build()
    return [ln.strip() for ln in kernel.ptxas_path().read_text().splitlines()
            if "registers" in ln or "spill" in ln
            or "Function properties" in ln]


INSTANCE = re.compile(r"detect_scan_kernelILi(\d+)ELi(\d+)ELb([01])E")
TILED = re.compile(r"\d+detect_scan_tiledE")
SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGISTERS = re.compile(r"Used (\d+) registers")


def spill_table(lines: list[str]) -> dict:
    """`ptxas_report` lines -> {"BPT=b,C=c": dict(registers, spill_stores,
    spill_loads)} per instantiation of the scan kernel ("BPT=b,C=c,grid"
    for a grid of clusters, "BPT=16,C=16,tiled" for the tiled grid)."""
    out, cur = {}, None
    for ln in lines:
        m = INSTANCE.search(ln)
        if m:
            grid = ",grid" if m.group(3) == "1" else ""
            cur = out.setdefault(f"BPT={m.group(1)},C={m.group(2)}{grid}",
                                 {})
            continue
        if TILED.search(ln):
            cur = out.setdefault("BPT=16,C=16,tiled", {})
            continue
        if cur is None:
            continue
        if m := SPILLS.search(ln):
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        elif m := REGISTERS.search(ln):
            cur["registers"] = int(m.group(1))
    return out


def breakdown(source: Path, dev: torch.device, fft: int = 8192) -> dict:
    """Uninstrumented time and probed phase shares of the kernel built
    from `source`, on each of the three inputs at `fft` bins."""
    p = production_params(fft)
    text = source.read_text()
    plain = variants.Variant(_kernels.DETECT_SCAN, text)
    probed_text, names = probed_source(text)
    probed = variants.Variant(_kernels.DETECT_SCAN, probed_text)
    plain.build()
    probed.build()
    res = dict(source=str(source), fft=p.fft_size,
               layout=detect_scan.layout(p.fft_size),
               frames=p.frames_per_block,
               ptxas=ptxas_report(plain), inputs=[])
    res["spills"] = spill_table(res["ptxas"])
    print(json.dumps(res), flush=True)
    n_valid = p.block_samples
    for name, mag2, s0 in inputs(p, dev):
        with variants.swapped("DETECT_SCAN", plain):
            err = compare(detect_scan.scan(mag2, s0, n_valid, p),
                          detect_scan.scan_plain(mag2, s0, n_valid, p))
            ms = single_ms(lambda: detect_scan.scan(mag2, s0, n_valid, p))
        with variants.swapped("DETECT_SCAN", probed):
            detect_scan.scan(mag2, s0, n_valid, p)
            phases(probed)                       # drop the first call
            detect_scan.scan(mag2, s0, n_valid, p)
            cyc, cnt = phases(probed)
        total = sum(cyc[:len(names)])
        us = ms * 1e3 / p.frames_per_block
        res["inputs"].append(dict(
            input=name, ms=ms, us_per_frame=us, max_abs_err=err,
            cycles_per_frame=total / p.frames_per_block,
            phases={n: dict(share=cyc[i] / total,
                            us_per_frame=us * cyc[i] / total,
                            entries=cnt[i])
                    for i, n in enumerate(names)}))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_scan",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, action="append",
                    help="kernel source to probe, repeatable (default: the "
                    "package's)")
    ap.add_argument("--fft", type=int, default=8192, choices=sorted(CONFIGS),
                    help="FFT size of the blocks (default 8192, the 10 MHz "
                    "production shape)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_scan: needs a CUDA device", file=sys.stderr)
        return 1
    for src in args.source or [_kernels.DETECT_SCAN.source]:
        print(json.dumps(breakdown(src.resolve(), torch.device("cuda"),
                                   args.fft)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
