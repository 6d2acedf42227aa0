"""The downmix chain's small FIRs (dsp/downmix.py `noise_box` and `rrc`,
csrc/downmix_fir.cu) at the burst classes' batches, and the class graphs
with them and with their plain versions.

    python -m iridium_tpu_torch.tools.exp_downmix [--rates 10,400,1600]
        [--source PATH ...] [--classes]
    python -m iridium_tpu_torch.tools.exp_downmix --device cpu --small

The shapes follow the code: the three class batches (batch, dec_cap) of
the production 10 MHz group program, and with `--rates` those of the 400
MHz and 1.6 GHz (256 frames a block) decodes at `exp_demod.WIDE_RUN`,
from `Pipeline(..., device="cpu").classes`. Each gets `inputs`: random
rows, dec_len, shift_dec and frame_len, with 0, 1, 19, 20, 24, 25, 26 and
L among the lengths (the LPF skipped below 25, no box output below 20).

For each shape the two launches (`noise_box`, then `rrc`) are held to
their plain versions (`noise_box_plain`, `rrc_plain`) on the same inputs:
`bit_equal` (torch.equal, which takes -0 for 0) and, where they part, the
first output, row and index (`first_diff`). Then the tool times them
(median single call of each and of both, both in a run of calls back to
back, and both captured as a CUDA graph, `graph_ms`: the device's time
without the host's enqueue, which the small batches' calls are), the
plain versions, and as the library's yardstick the three
FIRs as `torch.nn.functional.conv1d` over the same rows laid out as
planes outside the timing, with `torch.backends.cudnn.allow_tf32` False
(no masks; the port never calls it). The bound counts what this run's
data needs: bytes, each kept input sample read once and each output
written once, at 3.35 TB/s; operations, the FIRs' products and sums
(none fused) at the outputs the masks leave to compute and the squares of
|xd|^2 (hypotf not counted), at one FP32 operation a lane a cycle (128
lanes x 132 SMs at the card's top SM clock, `nvidia-smi`; 1.98 GHz, the
H100 SXM's, on the CPU).

`--source PATH` (card only, repeatable) builds another source of the
kernel with the same C entry under the git-ignored build/
(`tools/variants.py`), holds it to the plain versions and times it beside
the package's (the row's `designs`).

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
import contextlib
import gc
import json
import statistics
import subprocess
import sys

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


def taps(dev: torch.device) -> dict:
    """The noise, box and RRC taps of the downmix (the same at every input
    rate: they follow the fixed output rate), on `dev`."""
    c = downmix.make_consts(DownmixConfig().derived(
        DetectorConfig().derived()))
    return {name: torch.from_numpy(getattr(c, f"{name}_taps")).to(dev)
            for name in ("noise", "box", "rrc")}


def inputs(B: int, L: int, seed: int):
    """(x (B, L) c64, xf (B, L) c64, dec_len, shift_dec, frame_len (B,)
    i64) as numpy: standard normal rows; dec_len uniform in [L/4, L],
    shift_dec in [0, 200], frame_len in [0, dec_len]; the first rows take
    each of EDGES and L as dec_len (shift 0) and as frame_len, then two
    rows with shift_dec > 0 and shift_dec past dec_len."""
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
    return x, xf, dec_len, shift, frame_len


def bound(dec_len, shift_dec, frame_len, L: int, nn: int, nb: int,
          nt: int, clock_hz: float) -> dict:
    """What this data needs (numpy lengths): bytes (the kept samples read,
    8 a sample; the lengths, 8 a row; the taps; xd, filt and xr written,
    8 + 4 + 8 a sample) and FP32 operations (the noise FIR, 4 nn - 2, at
    each kept sample of a row whose LPF runs, and the square of |xd|^2; the
    box FIR, 2 nb - 1, where the kept samples reach its window; the RRC,
    4 nt - 2, where the frame reaches its window); the bound in ms, by
    each and by the larger."""
    B = len(dec_len)
    lo = np.maximum(shift_dec, 0)
    hi = np.minimum(dec_len, L)
    kept = np.maximum(hi - lo, 0)
    box_at = np.where(kept > 0, hi - np.maximum(lo - nb + 1, 0), 0)
    hf = np.clip(frame_len, 0, L)
    rrc_at = np.where(hf > 0, np.minimum(hf + (nt - 1) // 2, L), 0)
    lpf = dec_len - nn + 1 > 0
    n_bytes = int(8 * kept.sum() + 8 * hf.sum() + 24 * B
                  + 4 * (nn + nb + nt) + 20 * B * L)
    ops = int(((4 * nn - 2) * kept * lpf + kept + (2 * nb - 1) * box_at
               + (4 * nt - 2) * rrc_at).sum())
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


def run_shape(sh: dict, dev: torch.device, reps: int = 7,
              clock_hz: float | None = None, cands=None) -> dict:
    """One shape: each design of `cands` ((name, kernel) from
    `variants.candidates`; the package's kernel alone by default) held
    bit-equal to the plain versions (raises where one parts), then timed:
    single call (each launch, and both), both chained, and on the card
    both captured as a CUDA graph (`graph_ms`: the device's time without
    the host's enqueue); beside the plain versions, conv1d and the bound.
    The row is the first design's; the others are in `designs`."""
    B, L = sh["B"], sh["L"]
    t = taps(dev)
    x, xf, dl, sd, fl = inputs(B, L, SEED + B + L)
    tx, txf, tdl, tsd, tfl = (torch.from_numpy(v).to(dev)
                              for v in (x, xf, dl, sd, fl))
    nb_args = (tx, tdl, tsd, t["noise"], t["box"])
    rrc_args = (txf, tfl, t["rrc"])
    want = downmix.noise_box_plain(*nb_args) + (downmix.rrc_plain(
        *rrc_args),)
    lib = library(tx, want[0], txf, t)

    def both():
        return downmix.noise_box(*nb_args) + (downmix.rrc(*rrc_args),)

    def plain():
        downmix.noise_box_plain(*nb_args)
        downmix.rrc_plain(*rrc_args)

    designs = []
    for name, kern in cands or [("package", _kernels.DOWNMIX_FIR)]:
        with variants.swapped("DOWNMIX_FIR", kern):
            before = kern.launches
            got = both()
            d = dict(design=name, launches=kern.launches - before,
                     **compare(got, want))
            del got
            if not d["bit_equal"]:
                raise AssertionError(f"downmix FIRs ({name}) at {B} x {L} "
                                     f"against their plain versions: {d}")
            for key, fn in (("noise_box_ms",
                             lambda: downmix.noise_box(*nb_args)),
                            ("rrc_ms", lambda: downmix.rrc(*rrc_args)),
                            ("ms", both)):
                d[key] = statistics.median(samples_ms(fn, dev, reps))
            d["chained_ms"] = time_gather(both, dev, reps)
            if dev.type == "cuda":
                d["graph_ms"] = exp_demod.plain_graph(both)["replay_ms"]
        designs.append(d)
    del want
    res = dict(rate_mhz=sh.get("rate_mhz"), shape=sh["shape"], B=B, L=L,
               **designs[0])
    res.update(plain_ms=statistics.median(samples_ms(
                   plain, dev, 1 if dev.type == "cuda" else 2)),
               library_ms=statistics.median(samples_ms(lib, dev, reps)),
               library="conv1d x 3, cudnn.allow_tf32 = "
                       f"{torch.backends.cudnn.allow_tf32}",
               designs=designs[1:])
    res.update(bound(dl, sd, fl, L, len(t["noise"]), len(t["box"]),
                     len(t["rrc"]), clock_hz or sm_clock_hz(dev)))
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
    and `downmix.rrc`."""
    saved = downmix.noise_box, downmix.rrc
    downmix.noise_box, downmix.rrc = downmix.noise_box_plain, downmix.rrc_plain
    try:
        yield
    finally:
        downmix.noise_box, downmix.rrc = saved


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
    ap.add_argument("--classes", action="store_true",
                    help="the pipeline's class graphs with the kernel and "
                    "with the plain versions (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if (args.classes or args.source) and dev.type != "cuda":
        ap.error("--classes and --source need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    clock = sm_clock_hz(dev)
    cands = None
    if dev.type == "cuda":
        cands = variants.candidates(_kernels.DOWNMIX_FIR, args.source)
        for cname, k in cands:
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
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} "
              + json.dumps(r), flush=True)
    if args.classes:
        print("class_graphs " + json.dumps(exp_demod.class_graphs(
            dev, plain_in_place)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
