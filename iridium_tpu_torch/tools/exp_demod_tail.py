"""The demodulator's tail and the packing of the output rows (dsp/demod.py
`Demod.decide`, runtime/pipeline.py `pack_outputs`: csrc/demod_tail.cu's
two launches, `decide` and `pack`) at the burst classes' batches.

    python -m iridium_tpu_torch.tools.exp_demod_tail [--rates 10,400,1600]
    python -m iridium_tpu_torch.tools.exp_demod_tail --device cpu --small

The shapes follow the code: the three class batches (B, L, S, sps) of the
production 10 MHz group program and, with `--rates`, those of the 400 MHz
and 1.6 GHz (256 frames a block) decodes at `exp_demod.WIDE_RUN`
(`exp_demod.decode_shapes`), each in both modes (Gardner and
`--no-gardner`). `inputs` takes `exp_demod.inputs`' bursts and puts
`edge_rows` from row 5 on, where the batch has them: a magnitude drop of
20x mid-burst (the end-of-frame trim), 8 symbols (under the unique word),
noise alone, a clean UL burst, a clean DL burst, a zero-length row, and
tiny symbols with +-0 components. The loop (`demod.loop`: its kernel on
the card) turns them into `decide`'s inputs; `pack`'s downmix fields are
random from the seed.

Each launch is held to its twin on the same inputs (`decide_plain`;
`pack_plain` with and without LLRs): `bit_equal` (torch.equal of every
field, and of the rows' words) and, where they part, the first field, row
and index (`first_diff`); the tool raises where one parts. Then it times
each launch (median single call) and, on the card, each as a CUDA graph of
its own, both as one graph (`graph_ms`, the row's `ms`; on the CPU the
chained host time), and the twins eagerly and as one graph (`plain_ms`,
`plain_graph_ms`, with the graph's nodes). `bound` counts what this data
needs: bytes, each input read once where the trim reads it and each output
written once, at 3.35 TB/s; FP32 operations (OPS_PER_SYMBOL, OPS_PER_LLR)
at 67 TFLOP/s. No PyTorch call computes these steps (`library_ms` None).

On the CPU (`--small`: 12 bursts of 400 samples, 40 symbols) the wrappers
are the twins, and times are the host clock's.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys

import numpy as np
import torch

from .. import _kernels, device as device_mod, iridium
from ..dsp import demod, downmix
from ..io import synth
from ..runtime import pipeline
from . import exp_demod
from .exp_block_gather import time_gather
from .exp_downmix_chain import compare
from .exp_frontend import HBM_BYTES_PER_S
from .exp_window_gather import samples_ms

SEED = 2222
SMALL = dict(rate_mhz=10.0, shape="small", B=12, L=400, S=40, sps=10.0)
EDGES = ("drop", "short", "noise", "ul", "dl", "zero", "signed_zero")
EDGE_AT = 5              # exp_demod.inputs' edges take rows 0-4
# FP32 operations a symbol of `decide` (two hypotf, atan2f and fmodf at ~20
# each, the scan, sums and products ~10) and an LLR of `pack` (a product,
# rint, two clamps)
OPS_PER_SYMBOL = 90
OPS_PER_LLR = 4
FP32_FLOP_PER_S = exp_demod.FP32_FLOP_PER_S


def _clean(direction: str, L: int, isps: int, rng) -> np.ndarray:
    """A clean burst from its unique word on, L samples."""
    bits = rng.integers(0, 2, 2 * (L // isps + 8)).astype(np.uint8)
    w = synth.modulate(synth.burst_symbols(bits, direction), sps=isps)
    lead = iridium.PREAMBLE_LENGTH_SHORT * isps
    row = np.zeros(L, np.complex64)
    sig = w[lead:lead + L]
    row[:len(sig)] = sig
    return row


def edge_rows(L: int, sps: float, seed: int):
    """The rows that reach every branch of the tail, in EDGES' order:
    (x (7, L) c64, n (7,) i64, direction (7,) i32) as numpy. `drop`: a
    clean DL burst whose samples from L / 2 on are 20 times weaker (a
    triple of symbols under the running max / 8); `short`: 8 symbols of
    one (actual under UW_LENGTH: both errors 999); `noise`: unit noise
    (both checks fail); `ul`: a clean UL burst; `dl`: a clean DL burst
    (with UW tables within UW_MAX_ERRORS of each other, both hard checks
    pass and the direction given is kept); `zero`: length 0; `signed_zero`:
    symbols of magnitude ~1e-11 with +-0 components every sps samples
    (under the PLL's 1e-10 they leave its phase alone, so --no-gardner
    hands them to the tail as they are), zero between."""
    rng = np.random.default_rng(seed)
    isps = int(round(sps))
    x = np.zeros((len(EDGES), L), np.complex64)
    n = np.full(len(EDGES), L, np.int64)
    x[0] = _clean("DL", L, isps, rng)
    x[0, L // 2:] /= 20
    x[1] = _clean("DL", L, isps, rng)
    n[1] = 8 * isps
    x[1, n[1]:] = 0
    x[2] = ((rng.standard_normal(L) + 1j * rng.standard_normal(L))
            / np.sqrt(2)).astype(np.complex64)
    x[3] = _clean("UL", L, isps, rng)
    x[4] = _clean("DL", L, isps, rng)
    n[5] = 0
    tiny = np.float32(1e-11)
    parts = np.array([(-0.0, tiny), (tiny, -0.0), (-0.0, -0.0), (0.0, -tiny),
                      (-tiny, 0.0), (0.0, 0.0), (-0.0, tiny), (tiny, tiny)],
                     np.float32)
    k = np.arange(0, L, isps)
    sym = parts[np.arange(len(k)) % len(parts)]
    z = np.zeros((L, 2), np.float32)
    z[k] = sym
    x[6] = z.view(np.complex64)[:, 0]
    direction = rng.integers(0, 2, len(EDGES)).astype(np.int32)
    return x, n, direction


def inputs(B: int, L: int, sps: float, seed: int, at: int = EDGE_AT):
    """`exp_demod.inputs`' bursts (lengths 0, 3, 4, L and 1 first) with
    `edge_rows` from row `at` on, as many as B holds: (x, n, direction)
    as numpy."""
    x, n, direction = exp_demod.inputs(B, L, sps, seed)
    ex, en, ed = edge_rows(L, sps, seed + 1)
    k = max(0, min(len(EDGES), B - at))
    x[at:at + k], n[at:at + k], direction[at:at + k] = ex[:k], en[:k], ed[:k]
    return x, n, direction


def pack_fields(B: int, dev: torch.device, seed: int) -> dict:
    """The downmix fields `pack` reads, random from the seed:
    fine_offset, uw_corr (f32), ok (bool), start_dec, n_samples (i32)."""
    rng = np.random.default_rng(seed)
    t = dict(fine_offset=rng.normal(0, 0.01, B).astype(np.float32),
             uw_corr=rng.uniform(0, 1, B).astype(np.float32),
             ok=rng.integers(0, 2, B).astype(bool),
             start_dec=rng.integers(0, 5000, B).astype(np.int32),
             n_samples=rng.integers(0, 5000, B).astype(np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in t.items()}


def case(sh: dict, use_gardner: bool, dev: torch.device, seed: int) -> dict:
    """One batch's arguments: the Demod (`dm`), `decide`'s (`args`: the
    loop's outputs on `inputs` and the directions) and `pack`'s downmix
    output (`dmo`, its samples the loop's input)."""
    B, L, S, sps = sh["B"], sh["L"], sh["S"], sh["sps"]
    x, n, direction = (torch.from_numpy(v).to(dev)
                       for v in inputs(B, L, sps, seed))
    dm = demod.Demod(S, sps, use_gardner, dev)
    loop_out = demod.loop(x, n, sps, S, use_gardner)
    f = pack_fields(B, dev, seed + 2)
    dmo = downmix.DownmixOut(samples=x, n_samples=f["n_samples"],
                             ok=f["ok"], direction=direction,
                             start_dec=f["start_dec"],
                             fine_offset=f["fine_offset"],
                             uw_corr=f["uw_corr"])
    return dict(dm=dm, args=(*loop_out, direction), dmo=dmo)


def bound(args: tuple, want: demod.DemodOut, s2_pad: int,
          want_llr: bool) -> dict:
    """What this data needs, per launch and in all: bytes (each input read
    once where the trim reads it, each output written once) and FP32
    operations; the bound in ms by each and by the larger of the totals.
    `decide` reads the valid flags up to the trim's triple (the whole row
    where there is none), the symbols up to the larger of that and the
    unique word, the directions and the tables; writes five (B,) fields
    and the bits and LLRs. `pack` reads the bits, the LLRs (with
    want_llr) and eleven (B,) fields; writes the rows."""
    pll_out, valid, _, _ = args
    B, S = pll_out.shape
    n_sym = valid.sum(1)
    actual = want.n_symbols.long()
    trimmed = actual < n_sym
    scan = torch.where(trimmed, actual + 3, torch.full_like(actual, S))
    symbols = torch.clamp(torch.maximum(
        torch.where(trimmed, actual + 3, n_sym),
        torch.full_like(actual, iridium.UW_LENGTH)), max=S)
    U = iridium.UW_LENGTH
    d_bytes = (int(scan.sum()) + 8 * int(symbols.sum()) + 4 * B
               + 16 * U + 32 + 17 * B + 16 * B * S)
    d_ops = OPS_PER_SYMBOL * B * S
    W = pipeline.row_words(s2_pad, want_llr)
    p_bytes = (4 * B * 2 * S * (2 if want_llr else 1) + 38 * B
               + 4 * B * W)
    p_ops = OPS_PER_LLR * B * 2 * S if want_llr else 0
    res = {}
    for name, nb, ops in (("decide", d_bytes, d_ops),
                          ("pack", p_bytes, p_ops)):
        res[name] = dict(bytes=nb, ops=ops, bound_ms=max(
            nb / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3)
    nb, ops = d_bytes + p_bytes, d_ops + p_ops
    t_b, t_o = nb / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=nb, bytes_ms=t_b, bound_ops=ops, ops_ms=t_o,
                launches=res)


@contextlib.contextmanager
def plain_in_place():
    """The twins wherever the package calls `Demod.decide` and
    `pack_outputs`."""
    saved = demod.Demod.decide, pipeline.pack_outputs
    demod.Demod.decide = demod.Demod.decide_plain
    pipeline.pack_outputs = pipeline.pack_plain
    try:
        yield
    finally:
        demod.Demod.decide, pipeline.pack_outputs = saved


def check(c: dict) -> tuple[dict, demod.DemodOut]:
    """Both launches against their twins on one case's inputs, `pack` on
    the twin's `decide` output with LLRs and without (`pack_raw`):
    ({launch: compare's result}, the twin's DemodOut)."""
    dm, args, dmo = c["dm"], c["args"], c["dmo"]
    s2 = 2 * dm.S
    want = dm.decide_plain(*args)
    res = dict(decide=compare(dm.decide(*args), want))
    for name, want_llr in (("pack", True), ("pack_raw", False)):
        res[name] = compare(pipeline.pack_outputs(dmo, want, s2, want_llr),
                            pipeline.pack_plain(dmo, want, s2, want_llr),
                            ["rows"])
    return res, want


def run_shape(sh: dict, dev: torch.device, reps: int = 7) -> list[dict]:
    """Both modes at one shape, a dict each: both launches held to their
    twins (with and without LLRs; raises where one parts), then the
    times and the bound (with LLRs, as the parsed decode packs them)."""
    B, L, S = sh["B"], sh["L"], sh["S"]
    out = []
    for use_gardner in (True, False):
        c = case(sh, use_gardner, dev, SEED + B + L + use_gardner)
        dm, args, dmo = c["dm"], c["args"], c["dmo"]
        s2 = 2 * S
        res = dict(rate_mhz=sh["rate_mhz"], shape=sh["shape"], B=B, L=L,
                   S=S, sps=sh["sps"],
                   mode="gardner" if use_gardner else "no_gardner")
        before = _kernels.DEMOD_TAIL.launches
        res["per_launch"], want = check(c)
        res["launches"] = _kernels.DEMOD_TAIL.launches - before
        res["bit_equal"] = all(v["bit_equal"]
                               for v in res["per_launch"].values())
        res["max_abs_err"] = max(v["max_abs_err"]
                                 for v in res["per_launch"].values())
        res["first_diff"] = next(([k] + v["first_diff"] for k, v in
                                  res["per_launch"].items()
                                  if v["first_diff"]), None)
        if not res["bit_equal"]:
            raise AssertionError(f"demod tail at {B} x {S} "
                                 f"({res['mode']}) against its twins: "
                                 f"{res['per_launch']}")
        res["rows"] = dict(ok=int(want.ok.sum()),
                           ul=int((want.direction == 1).sum()),
                           trimmed=int((want.n_symbols.long()
                                        < args[1].sum(1)).sum()))

        def decide():
            return dm.decide(*args)

        def pack():
            return pipeline.pack_outputs(dmo, want, s2, True)

        def both():
            return pipeline.pack_outputs(dmo, dm.decide(*args), s2, True)

        def plain():
            return pipeline.pack_plain(dmo, dm.decide_plain(*args), s2,
                                       True)
        pl = res["per_launch"]
        pl["decide"]["ms"] = statistics.median(samples_ms(decide, dev, reps))
        pl["pack"]["ms"] = statistics.median(samples_ms(pack, dev, reps))
        res["chained_ms"] = time_gather(both, dev, reps)
        res["plain_ms"] = statistics.median(samples_ms(
            plain, dev, 3 if dev.type == "cuda" else 2))
        if dev.type == "cuda":
            g = exp_demod.plain_graph(both)
            res["graph_ms"], res["graph_nodes"] = g["replay_ms"], g["nodes"]
            res["plain_graph"] = exp_demod.plain_graph(plain)
            res["plain_graph_ms"] = res["plain_graph"]["replay_ms"]
            for name, fn in (("decide", decide), ("pack", pack)):
                pl[name]["graph_ms"] = exp_demod.plain_graph(fn)["replay_ms"]
        res["ms"] = res.get("graph_ms", res["chained_ms"])
        b = bound(args, want, s2, True)
        for name in ("decide", "pack"):
            pl[name]["bound_ms"] = b["launches"][name]["bound_ms"]
        del b["launches"]
        res.update(b, library_ms=None,
                   share_of_bound=b["bound_ms"] / res["ms"])
        out.append(res)
        del c, args, dmo, want
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_demod_tail",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--rates", default="10",
                    help="comma-separated decodes whose class batches to "
                    "run, in MHz: 10, 400, 1600")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    if dev.type == "cuda":
        _kernels.DEMOD_TAIL.build()
        print("ptxas " + json.dumps(exp_demod.ptxas_summary(
            _kernels.DEMOD_TAIL)), flush=True)
    shapes = ([SMALL] if args.small else
              [sh for r in args.rates.split(",")
               for sh in exp_demod.decode_shapes(float(r))])
    for sh in shapes:
        for r in run_shape(sh, dev, reps=3 if args.small else 7):
            print(f"{r['shape']} {r['B']} x {r['S']} {r['mode']}: "
                  f"{r['ms']:.4f} ms, bit-equal {r['bit_equal']}, plain "
                  f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.5f} "
                  + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
