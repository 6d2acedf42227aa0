"""The downmix chain's FIR kernel (dsp/downmix.py `noise_box` and
`frame_rrc`, csrc/downmix_fir.cu) at the burst classes' batches, and the
class graphs with it and with its plain versions.

    python -m iridium_tpu_torch.tools.exp_downmix [--rates 10,400,1600]
        [--source PATH ...] [--probes] [--classes]
    python -m iridium_tpu_torch.tools.exp_downmix --device cpu --small

The shapes follow the code: the three class batches (batch, dec_cap) of
the production 10 MHz group program, and with `--rates` those of the 400
MHz and 1.6 GHz (256 frames a block) decodes at `exp_demod.WIDE_RUN`,
from `Pipeline(..., device="cpu").classes`. Each gets `inputs`: random
rows, dec_len, shift_dec and frame_len, with 0, 1, 19, 20, 24, 25, 26 and
L among the lengths (the LPF skipped below 25, no box output below 20),
and stage 1's start (past the row too), bin u (at +-cfo_total / 2 too)
and fraction corr (0 too).

For each shape the two launches (`noise_box`, then `frame_rrc`) are held
to their plain versions (`noise_box_plain`, `frame_rrc_plain`) on the
same inputs: `bit_equal` (torch.equal, which takes -0 for 0) and, where
they part, the first output, row and index (`first_diff`). Then the tool
times them (median single call of each and of both, both in a run of
calls back to back, and both captured as a CUDA graph, `graph_ms`: the
device's time without the host's enqueue, which the small batches' calls
are), the plain versions, and as the library's yardstick the three FIRs
as `torch.nn.functional.conv1d` over the same rows laid out as planes
outside the timing, with `torch.backends.cudnn.allow_tf32` False (no
masks, no gather or rotation; the port never calls it). The bound counts
what this run's data needs: bytes, each kept input sample read once
(stage 1's from start) and each output written once, at 3.35 TB/s;
operations, the FIRs' products and sums (none fused) at the outputs the
masks leave to compute, the squares of |xd|^2 (hypotf not counted) and
the fine rotation's 11 a kept frame sample, at one FP32 operation a lane
a cycle (128 lanes x 132 SMs at the card's top SM clock, `nvidia-smi`;
1.98 GHz, the H100 SXM's, on the CPU).

On the card the row's `designs` time the FIRs alone, without the frame
gather and the rotation (stage 1 from start 0, unturned, held to
`noise_box_plain` and `rrc_plain`), beside the bound of that work
(`fir_bound_ms`): `fir_alone`, the package's source with its rotation
taken out (`probe_fir_alone`), and each `--source PATH` (repeatable),
another source of the kernel built under the git-ignored build/
(`tools/variants.py`; a source whose C entry has no rotation arguments,
such as the design before the fold, `git show
8e9722b:iridium_tpu_torch/csrc/downmix_fir.cu`, gets an adapter,
`adapted`). `--probes` adds `no_taps`, the package's source with every
FIR cut to its first tap (`probe_no_taps`: the launches' loads, masks,
rotation and stores with one product an output; timed, not checked), and
the row's `fill_ms` is PyTorch's `fill_` of the outputs' bytes (xd, filt
and xr, 20 a sample) as a CUDA graph: the card's write rate for them.

`--classes` (card only): `exp_demod.class_graphs` with the plain versions
swapped in for the kernel (this tool's swap; the package has no switch):
each class graph's nodes, capture and instantiate seconds and replay ms,
each decode's wall, and the device operations that take the small-normal
replay's time, both ways, in one process.

On the CPU (`--small`: 9 rows of 301 samples) the wrappers are the plain
versions, and times are the host clock's.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _kernels, device as device_mod
from ..config import DetectorConfig, DownmixConfig
from ..dsp import downmix
from . import exp_demod, variants
from .exp_block_gather import time_gather
from .exp_frontend import HBM_BYTES_PER_S
from .exp_window_gather import samples_ms

SEED = 1616
SMALL = (dict(shape="small", B=9, L=301),)
EDGES = (0, 1, 19, 20, 24, 25, 26)      # lengths every shape gets, and L
SMS, LANES = 132, 128                   # the H100's SMs, FP32 lanes an SM
H100_SM_HZ = 1.98e9                     # the H100 SXM's top SM clock


def class_shapes(rate_mhz: float = 10.0) -> list[dict]:
    """The three class batches (batch, dec_cap) of the decode at
    `rate_mhz` (`exp_demod.decode_shapes`: the production 10 MHz group
    program, or the wideband decodes' at WIDE_RUN)."""
    return [dict(rate_mhz=sh["rate_mhz"], shape=sh["shape"], B=sh["B"],
                 L=sh["dec_cap"]) for sh in exp_demod.decode_shapes(rate_mhz)]


def _params():
    return DownmixConfig().derived(DetectorConfig().derived())


def taps(dev: torch.device) -> dict:
    """The noise, box and RRC taps of the downmix (the same at every input
    rate: they follow the fixed output rate), on `dev`."""
    c = downmix.make_consts(_params())
    return {name: torch.from_numpy(getattr(c, f"{name}_taps")).to(dev)
            for name in ("noise", "box", "rrc")}


def cfo_total() -> int:
    """The fine CFO FFT's padded size (the same at every input rate)."""
    return _params().cfo_fft_total


def inputs(B: int, L: int, seed: int, total: int | None = None):
    """(x (B, L) c64, xf (B, L) c64, dec_len, shift_dec, frame_len, start,
    u (B,) i64, corr (B,) f32) as numpy: standard normal rows; dec_len
    uniform in [L/4, L], shift_dec in [0, 200], frame_len in [0, dec_len];
    the first rows take each of EDGES and L as dec_len (shift 0) and as
    frame_len, then two rows with shift_dec > 0 and shift_dec past
    dec_len. Stage 1 reads xf from start, uniform in [0, L - frame_len]
    (the frame inside the row; 0 on the edge rows), turned by u uniform in
    [-total / 2, total / 2) (total: `cfo_total()` by default) and corr in
    [-0.5, 0.5); past those rows, where the batch has them, a start past
    the row, a frame past the row's end (by half of it), u at -total / 2
    and total / 2 and corr 0, one row each."""
    rng = np.random.default_rng(seed)
    x, xf = ((rng.standard_normal((B, L)) + 1j * rng.standard_normal(
        (B, L))).astype(np.complex64) for _ in "xf")
    dec_len = rng.integers(L // 4, L + 1, B)
    shift = rng.integers(0, 201, B)
    frame_len = (rng.random(B) * (dec_len + 1)).astype(np.int64)
    edges = [e for e in EDGES if e <= L] + [L]
    n = min(B, len(edges))
    dec_len[:n], shift[:n], frame_len[:n] = edges[:n], 0, edges[:n]
    for b, (d, s) in enumerate(((L, 30), (100, 150)), start=n):
        if b < B:
            dec_len[b], shift[b] = min(d, L), s
    start = (rng.random(B) * (L - frame_len + 1)).astype(np.int64)
    start[:n] = 0
    half = (total or cfo_total()) // 2
    u = rng.integers(-half, half, B)
    corr = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    b = n + 2
    if B >= b + 5:
        start[b] = L + 3
        frame_len[b + 1] = dec_len[b + 1]
        start[b + 1] = L - frame_len[b + 1] // 2
        u[b + 2], u[b + 3], corr[b + 4] = -half, half, 0.0
    return x, xf, dec_len, shift, frame_len, start, u, corr


ROTATE_OPS = 11     # the fine rotation's f32 operations a kept sample


def bound(dec_len, shift_dec, frame_len, L: int, nn: int, nb: int,
          nt: int, clock_hz: float, start=None, rotate: bool = False
          ) -> dict:
    """What this data needs (numpy lengths): bytes (the kept samples read,
    8 a sample; the lengths, 8 a row; the taps; xd, filt and xr written,
    8 + 4 + 8 a sample) and FP32 operations (the noise FIR, 4 nn - 2, at
    each kept sample of a row whose LPF runs, and the square of |xd|^2; the
    box FIR, 2 nb - 1, where the kept samples reach its window; the RRC,
    4 nt - 2, where the frame reaches its window); the bound in ms, by
    each and by the larger. Stage 1 reads the frame from `start` (None:
    0): its kept samples are those below frame_len that the row holds from
    start. With `rotate`, the fine rotation: ROTATE_OPS a kept frame sample
    (the angle's 5 products and sums, its cosine and sine one each, the
    complex product's 4) and start, u and corr read (8 + 8 + 4 bytes a
    row)."""
    B = len(dec_len)
    lo = np.maximum(shift_dec, 0)
    hi = np.minimum(dec_len, L)
    kept = np.maximum(hi - lo, 0)
    box_at = np.where(kept > 0, hi - np.maximum(lo - nb + 1, 0), 0)
    hf = np.clip(np.minimum(frame_len, L - (0 if start is None else start)),
                 0, L)
    rrc_at = np.where(hf > 0, np.minimum(hf + (nt - 1) // 2, L), 0)
    lpf = dec_len - nn + 1 > 0
    n_bytes = int(8 * kept.sum() + 8 * hf.sum() + 24 * B
                  + 4 * (nn + nb + nt) + 20 * B * L
                  + (20 * B if rotate else 0))
    ops = int(((4 * nn - 2) * kept * lpf + kept + (2 * nb - 1) * box_at
               + (4 * nt - 2) * rrc_at
               + (ROTATE_OPS * hf if rotate else 0)).sum())
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / (SMS * LANES * clock_hz) * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=n_bytes, bytes_ms=t_b, bound_ops=ops,
                ops_ms=t_o, clock_hz=clock_hz)


def sm_clock_hz(dev: torch.device) -> float:
    """The card's top SM clock (`nvidia-smi clocks.max.sm`); on the CPU
    the H100 SXM's."""
    if dev.type != "cuda":
        return H100_SM_HZ
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def compare(got: tuple, want: tuple) -> dict:
    """(xd, filt, xr) against the plain versions': `bit_equal`, the
    largest |err|, and the first output, row and index where they part
    (`first_diff`, None where none does)."""
    res = dict(bit_equal=True, max_abs_err=0.0, first_diff=None)
    for name, a, b in zip(("xd", "filt", "xr"), got, want):
        if torch.equal(a, b):
            continue
        res["bit_equal"] = False
        diff = a != b
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((a - b).abs().max()))
        if res["first_diff"] is None:
            row = int(diff.any(1).int().argmax())
            res["first_diff"] = [name, row, int(diff[row].int().argmax())]
    return res


def library(x, xd, xf, t: dict):
    """The three FIRs as conv1d over planar rows (laid out here, outside
    the timing), and the function that runs them."""
    import torch.nn.functional as F
    B, L = x.shape
    planes = [torch.view_as_real(v).permute(0, 2, 1).reshape(2 * B, 1, L)
              .contiguous() for v in (x, xf)]
    mag2 = F.pad((xd.abs() ** 2)[:, None], (0, t["box"].shape[0] - 1))
    w = {k: v.view(1, 1, -1) for k, v in t.items()}
    hn, hr = (t["noise"].shape[0] - 1) // 2, (t["rrc"].shape[0] - 1) // 2

    def fn():
        return (F.conv1d(planes[0], w["noise"], padding=hn),
                F.conv1d(mag2, w["box"]),
                F.conv1d(planes[1], w["rrc"], padding=hr))
    return fn


# The line of csrc/downmix_fir.cu that turns stage 1's staged samples
TURN = re.compile(r"^ *turn\(sre, sim,.*\);\n", re.M)


def probe_fir_alone(text: str) -> str:
    """The source with stage 1's rotation taken out: from start 0 its
    frame is the rows as given, and the launches compute `noise_box_plain`
    and `rrc_plain`, the FIRs alone."""
    text, n = TURN.subn("", text)
    if n != 1:
        raise ValueError(f"probe_fir_alone: {n} rotation calls in the "
                         "source, expected one")
    return text


def adapted(text: str) -> str:
    """A source whose `downmix_fir` entry takes no rotation arguments (the
    design before the fold: its stage 1 is the RRC of the rows as given),
    behind an entry with the package's argument list."""
    head = text[text.index('extern "C" int downmix_fir('):]
    if "two_total" in head[:head.index(")")]:
        return text
    text = text.replace('extern "C" int downmix_fir(',
                        'extern "C" int downmix_fir_unfolded(', 1)
    return text + """
extern "C" int downmix_fir(int stage, const float2* x, int B, long long L,
                           const long long* len_a, const long long* len_b,
                           const long long* u, const float* corr,
                           long long two_total, const float* taps_a,
                           int n_a, const float* taps_b, int n_b,
                           float2* out_c, float* out_f, cudaStream_t stream) {
  return downmix_fir_unfolded(stage, x, B, L, len_a, len_b, taps_a, n_a,
                              taps_b, n_b, out_c, out_f, stream);
}
"""


# The loop over the taps past the first in csrc/downmix_fir.cu's `fir_run`
TAPS_LOOP = "  for (int k0 = 1; k0 < n; k0 += kRun) {"


def probe_no_taps(text: str) -> str:
    """The source with every FIR cut to its first tap (each output c[0]
    x[0]): what the launches cost without their FIRs' sums."""
    if text.count(TAPS_LOOP) != 1:
        raise ValueError("probe_no_taps: the taps' loop is not in the "
                         "source once")
    return text.replace(TAPS_LOOP, "  for (int k0 = 1; k0 < 1; ++k0) {")


def candidates(sources=(), probes: bool = False) -> list[tuple]:
    """[(name, kernel, fold)]: the package's kernel (fold True); its
    source with the rotation taken out (`fir_alone`) and a Variant per
    source (`adapted`), fold False: the FIRs alone; with `probes`,
    `no_taps` (fold None: the package's inputs, timed, not checked). All
    built at once (one nvcc each)."""
    base = _kernels.DOWNMIX_FIR
    text = base.source.read_text()
    cands = [("package", base, True),
             ("fir_alone", variants.Variant(base, probe_fir_alone(text)),
              False)]
    cands += [(str(src), variants.Variant(
        base, adapted(Path(src).read_text())), False) for src in sources]
    if probes:
        cands.append(("no_taps", variants.Variant(base, probe_no_taps(text)),
                      None))
    with concurrent.futures.ThreadPoolExecutor(len(cands)) as pool:
        for fut in [pool.submit(k.build) for _, k, _ in cands]:
            fut.result()
    return cands


def run_shape(sh: dict, dev: torch.device, reps: int = 7,
              clock_hz: float | None = None, cands=None) -> dict:
    """One shape: each design of `cands` ((name, kernel, fold) from
    `candidates`; the package's kernel alone by default) held bit-equal
    to the plain versions (raises where one parts): with fold, `noise_box`
    and `frame_rrc` on the rows' starts, bins and fractions against
    `noise_box_plain` and `frame_rrc_plain`; without, stage 1 from start 0
    unturned against `rrc_plain`; a probe (fold None) on fold's inputs,
    compared and not held. Then timed: single call (each launch, and
    both), both chained, and on the card both captured as a CUDA graph
    (`graph_ms`: the device's time without the host's enqueue); beside
    the plain versions, conv1d, `fill_` of the outputs' bytes and the
    bound of each one's work. The row is the first design's; the others
    are in `designs`."""
    B, L = sh["B"], sh["L"]
    t, total = taps(dev), cfo_total()
    x, xf, dl, sd, fl, st, u, corr = inputs(B, L, SEED + B + L, total)
    tx, txf, tdl, tsd, tfl, tst, tu, tcorr = (
        torch.from_numpy(v).to(dev) for v in (x, xf, dl, sd, fl, st, u, corr))
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    nb_args = (tx, tdl, tsd, t["noise"], t["box"])
    fr_args = {True: (txf, tst, tfl, tu, tcorr, t["rrc"], total),
               False: (txf, zero, tfl, zero, torch.zeros_like(tcorr),
                       t["rrc"], total)}
    want_nb = downmix.noise_box_plain(*nb_args)
    want_xr = {True: downmix.frame_rrc_plain(*fr_args[True]),
               False: downmix.rrc_plain(txf, tfl, t["rrc"])}
    lib = library(tx, want_nb[0], txf, t)
    clock = clock_hz or sm_clock_hz(dev)
    lens = (dl, sd, fl, L, len(t["noise"]), len(t["box"]), len(t["rrc"]),
            clock)

    def plain():
        downmix.noise_box_plain(*nb_args)
        downmix.frame_rrc_plain(*fr_args[True])

    designs = []
    for name, kern, fold in cands or [("package", _kernels.DOWNMIX_FIR,
                                       True)]:
        fr = fr_args[fold is not False]

        def both():
            return downmix.noise_box(*nb_args) + (downmix.frame_rrc(*fr),)
        with variants.swapped("DOWNMIX_FIR", kern):
            before = kern.launches
            got = both()
            d = dict(design=name, launches=kern.launches - before,
                     **compare(got, want_nb + (want_xr[fold is not False],)))
            del got
            if not d["bit_equal"] and fold is not None:
                raise AssertionError(f"downmix FIRs ({name}) at {B} x {L} "
                                     f"against their plain versions: {d}")
            for key, fn in (("noise_box_ms",
                             lambda: downmix.noise_box(*nb_args)),
                            ("frame_rrc_ms", lambda: downmix.frame_rrc(*fr)),
                            ("ms", both)):
                d[key] = statistics.median(samples_ms(fn, dev, reps))
            d["chained_ms"] = time_gather(both, dev, reps)
            if dev.type == "cuda":
                d["graph_ms"] = exp_demod.plain_graph(both)["replay_ms"]
        if fold is False:
            d["fir_bound_ms"] = bound(*lens)["bound_ms"]
            d["share_of_bound"] = d["fir_bound_ms"] / d.get(
                "graph_ms", d["chained_ms"])
        designs.append(d)
    del want_nb, want_xr
    res = dict(rate_mhz=sh.get("rate_mhz"), shape=sh["shape"], B=B, L=L,
               **designs[0])
    res.update(plain_ms=statistics.median(samples_ms(
                   plain, dev, 1 if dev.type == "cuda" else 2)),
               library_ms=statistics.median(samples_ms(lib, dev, reps)),
               library="conv1d x 3, cudnn.allow_tf32 = "
                       f"{torch.backends.cudnn.allow_tf32}",
               designs=designs[1:])
    if dev.type == "cuda":
        outs = (torch.empty_like(tx), torch.empty((B, L), device=dev),
                torch.empty_like(tx))
        res["fill_ms"] = exp_demod.plain_graph(
            lambda: [o.fill_(0) for o in outs])["replay_ms"]
        del outs
    res.update(bound(*lens, start=st, rotate=True))
    res["share_of_bound"] = res["bound_ms"] / res.get("graph_ms",
                                                      res["chained_ms"])
    del lib
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def plain_in_place():
    """The plain versions wherever the package calls `downmix.noise_box`
    and `downmix.frame_rrc`."""
    saved = downmix.noise_box, downmix.frame_rrc
    downmix.noise_box, downmix.frame_rrc = (downmix.noise_box_plain,
                                            downmix.frame_rrc_plain)
    try:
        yield
    finally:
        downmix.noise_box, downmix.frame_rrc = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_downmix",
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
                    help="also time the package's source cut to one tap "
                    "a FIR (card only)")
    ap.add_argument("--classes", action="store_true",
                    help="the pipeline's class graphs with the kernel and "
                    "with the plain versions (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if (args.classes or args.source or args.probes) and dev.type != "cuda":
        ap.error("--classes, --source and --probes need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    clock = sm_clock_hz(dev)
    cands = None
    if dev.type == "cuda":
        cands = candidates(args.source, args.probes)
        for cname, k, _ in cands:
            print(f"ptxas {cname} " + json.dumps(exp_demod.ptxas_summary(k)),
                  flush=True)
    shapes = (SMALL if args.small else
              [sh for r in args.rates.split(",")
               for sh in class_shapes(float(r))])
    for sh in shapes:
        r = run_shape(sh, dev, reps=3 if args.small else 7, clock_hz=clock,
                      cands=cands)
        print(f"{r['shape']} {r['B']} x {r['L']}: {r['ms']:.4f} ms "
              f"(chained {r['chained_ms']:.4f}, graph "
              f"{r.get('graph_ms', float('nan')):.4f}), bit-equal "
              f"{r['bit_equal']}, plain {r['plain_ms']:.2f}, conv1d "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}"
              + "".join(f"; {d['design']} graph {d['graph_ms']:.4f}"
                        + (f", bound {d['fir_bound_ms']:.5f}"
                           if "fir_bound_ms" in d else "")
                        for d in r["designs"]) + " "
              + json.dumps(r), flush=True)
    if args.classes:
        print("class_graphs " + json.dumps(exp_demod.class_graphs(
            dev, plain_in_place)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
