"""The demodulator's tail and the packing of the output rows
(runtime/pipeline.py `decide_pack`: csrc/demod_tail.cu's one launch) at
the burst classes' batches.

    python -m iridium_tpu_torch.tools.exp_demod_tail [--rates 10,400,1600]
        [--layouts] [--source PATH ...]
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
the card) turns them into the tail's inputs; the downmix fields are
random from the seed.

The launch is held to its twin, `decide_pack_plain` (`Demod.decide_plain`
and `pack_plain` composed), on the same inputs, with and without LLRs:
`bit_equal` (torch.equal of the rows' words) and, where they part, the
first row and word (`first_diff`); the tool raises where they part. Then
it times the launch (median single call) and, on the card, as a CUDA
graph of one node with LLRs (`graph_ms`, the row's `ms`; on the CPU its
host time) and without (`raw_graph_ms`), and ten calls captured as one
graph, its replay over ten (`in_graph_ms`: the device's time a call
inside a class graph, without the replay's own launch), beside the twins
eagerly and as one graph (`plain_ms`, `plain_graph_ms`, with the graph's
nodes); the row gives the layout (`runtime/pipeline.py` `tail_plan`).
`--layouts` (card only) gives `in_graph_ms` at every layout the kernel
takes at the batch's S (1, 2, 4, 8 and 16 warps a burst; each held
bit-equal first), `by_layout`. `--source PATH` (card only, repeatable)
builds another source of the kernel under the git-ignored build/
(`tools/variants.py`) and times it beside the package's on the same
inputs, in `designs`: a source with the package's entry as that launch; a
source whose entry takes a stage first (the design of two launches,
`decide` then `pack`: `git show
f8c2903:iridium_tpu_torch/csrc/demod_tail.cu > build/old_tail.cu`)
through `two_launches`, each launch held bit-equal to its twin. `bound`
counts what the two launches' data needs, `fused_bound` what
`decide_pack`'s does (the row's bound): bytes, each input read once where
the trim reads it and each output written once, at 3.35 TB/s; FP32
operations (OPS_PER_SYMBOL, OPS_PER_LLR) at 67 TFLOP/s. No PyTorch call
computes these steps (`library_ms` None).

On the CPU (`--small`: 12 bursts of 400 samples, 40 symbols) the wrappers
are the twins, and times are the host clock's.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from . import exp_demod, variants
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


def fused_bound(args: tuple, want: demod.DemodOut, s2_pad: int,
                want_llr: bool) -> dict:
    """What `decide_pack`'s data needs: `decide`'s reads (`bound`), the
    six downmix and loop fields `pack` reads besides the decisions
    (total_phase, fine_offset, uw_corr, dm.ok, start_dec, n_samples: 21
    bytes a burst), the rows written; `decide`'s and `pack`'s operations.
    The bits and LLRs are neither read nor written."""
    pll_out = args[0]
    B, S = pll_out.shape
    two = bound(args, want, s2_pad, want_llr)["launches"]
    W = pipeline.row_words(s2_pad, want_llr)
    nb = (two["decide"]["bytes"] - 17 * B - 16 * B * S + 21 * B
          + 4 * B * W)
    ops = two["decide"]["ops"] + two["pack"]["ops"]
    t_b, t_o = nb / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=nb, bytes_ms=t_b, bound_ops=ops, ops_ms=t_o)


@contextlib.contextmanager
def plain_in_place():
    """The twins wherever the package calls `decide_pack`."""
    saved = pipeline.decide_pack
    pipeline.decide_pack = pipeline.decide_pack_plain
    try:
        yield
    finally:
        pipeline.decide_pack = saved


def check(c: dict) -> dict:
    """`decide_pack` against the twins composed on one case's inputs, with
    LLRs and without (`decide_pack_raw`): {launch: compare's result}."""
    dm, args, dmo = c["dm"], c["args"], c["dmo"]
    s2 = 2 * dm.S
    return {name: compare(
        pipeline.decide_pack(dm, *args[:3], dmo, s2, want_llr),
        pipeline.decide_pack_plain(dm, *args[:3], dmo, s2, want_llr),
        ["rows"]) for name, want_llr in (("decide_pack", True),
                                         ("decide_pack_raw", False))}


# The C entry of the design of two launches (`decide`, then `pack`): the
# package's with a stage first
STAGED = 'extern "C" int demod_tail(int stage,'


def staged(kernel: _kernels.Kernel) -> bool:
    """Whether a source of the kernel is the design of two launches."""
    text = (kernel.text if isinstance(kernel, variants.Variant)
            else kernel.source.read_text())
    return STAGED in text


def _staged_launch(kernel, stage: int, dev, B: int, n: int, ptrs: list,
                   ints=(), floats=()) -> None:
    kernel.launch(
        dev, stage, B, n, (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
        (ctypes.c_longlong * len(ints))(*ints), len(ints),
        (ctypes.c_float * len(floats))(*floats), len(floats))


def old_decide(kernel, dm: demod.Demod, pll_out, valid, total_phase,
               direction) -> demod.DemodOut:
    """`Demod.decide_plain`'s function as the design of two launches
    computes it: its stage 0 (`decide`, a warp a burst), the (B, 2S) bits
    and LLRs written to device memory."""
    dev = pll_out.device
    B, S = pll_out.shape
    i32 = torch.int32
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    direction_out = torch.empty(B, dtype=i32, device=dev)
    n_symbols = torch.empty_like(direction_out)
    confidence = torch.empty_like(direction_out)
    level = torch.empty(B, dtype=torch.float32, device=dev)
    bits = torch.empty((B, 2 * S), dtype=i32, device=dev)
    llr = torch.empty((B, 2 * S), dtype=torch.float32, device=dev)
    p = _kernels.ptr
    _staged_launch(kernel, 0, dev, B, S,
                   [p(pll_out), p(valid), p(direction), p(dm.uw_dl),
                    p(dm.uw_ul), p(dm.dqpsk_map), p(ok), p(direction_out),
                    p(n_symbols), p(confidence), p(level), p(bits), p(llr)],
                   [demod.UW_MAX_ERRORS],
                   [demod.MAGNITUDE_DROP, demod.CONFIDENCE_ANGLE,
                    demod.UW_SOFT_THRESHOLD])
    return demod.DemodOut(ok=ok, direction=direction_out,
                          n_symbols=n_symbols, confidence=confidence,
                          level=level, total_phase=total_phase, bits=bits,
                          llr=llr)


def old_pack(kernel, dmo: downmix.DownmixOut, dd: demod.DemodOut,
             s2_pad: int, want_llr: bool) -> torch.Tensor:
    """`pack_plain`'s function as the design of two launches computes it:
    its stage 1 (`pack`, a warp a row)."""
    dev = dd.bits.device
    B, S2 = dd.bits.shape
    W = pipeline.row_words(s2_pad, want_llr)
    rows = torch.empty((B, W), dtype=torch.int32, device=dev)
    p = _kernels.ptr
    _staged_launch(kernel, 1, dev, B, S2,
                   [p(dd.bits), p(dd.llr), p(dmo.fine_offset),
                    p(dmo.uw_corr), p(dmo.ok), p(dmo.start_dec),
                    p(dmo.n_samples), p(dd.level), p(dd.total_phase),
                    p(dd.ok), p(dd.n_symbols), p(dd.confidence),
                    p(dd.direction), p(rows)],
                   [s2_pad, int(want_llr), W])
    return rows


def two_launches(kernel, dm, pll_out, valid, total_phase, dmo, s2_pad,
                 want_llr) -> torch.Tensor:
    """`decide_pack`'s function as the design of two launches computes
    it: `old_decide`, then `old_pack`."""
    return old_pack(kernel, dmo, old_decide(kernel, dm, pll_out, valid,
                                            total_phase, dmo.direction),
                    s2_pad, want_llr)


def check_two(kernel, c: dict, want: demod.DemodOut) -> dict:
    """The design of two launches against the twins on one case's inputs:
    `decide` against `Demod.decide_plain`, `pack` against `pack_plain`
    on the twin's output, with and without LLRs (`pack_raw`)."""
    dm, args, dmo = c["dm"], c["args"], c["dmo"]
    s2 = 2 * dm.S
    res = dict(decide=compare(old_decide(kernel, dm, *args), want))
    for name, want_llr in (("pack", True), ("pack_raw", False)):
        res[name] = compare(old_pack(kernel, dmo, want, s2, want_llr),
                            pipeline.pack_plain(dmo, want, s2, want_llr),
                            ["rows"])
    return res


def candidates(sources=()) -> list[tuple]:
    """[(name, kernel)]: the package's kernel and a Variant of it per
    source, built at once; a source of the design of two launches binds
    its entry with the stage first."""
    cands = variants.candidates(_kernels.DEMOD_TAIL, sources)
    for _, k in cands[1:]:
        if staged(k):
            k.argtypes = [ctypes.c_int] + list(k.argtypes)
    return cands


def layouts(B: int, S: int) -> list[int]:
    """The warps a burst of `tail_plan`'s layouts the kernel takes at S."""
    ok = []
    for w in (1, 2, 4, 8, 16):
        try:
            pipeline.tail_plan(B, S, w)
        except ValueError:
            continue
        ok.append(w)
    return ok


@contextlib.contextmanager
def forced_layout(warps: int):
    """`decide_pack` at `warps` warps a burst, whatever `tail_plan`
    picks."""
    saved = pipeline.tail_plan
    pipeline.tail_plan = lambda B, S: saved(B, S, warps)
    try:
        yield
    finally:
        pipeline.tail_plan = saved


def run_shape(sh: dict, dev: torch.device, reps: int = 7,
              by_layout: bool = False, cands=None) -> list[dict]:
    """Both modes at one shape, a dict each: the launch held to the twins
    (with and without LLRs; raises where they part), then the times and
    the bound (with LLRs, as the parsed decode packs them); with
    `by_layout`, the launch at each of `layouts`; each of `cands` ((name,
    kernel) from `candidates` but the package's) held and timed in
    `designs`."""
    B, L, S = sh["B"], sh["L"], sh["S"]
    out = []
    for use_gardner in (True, False):
        c = case(sh, use_gardner, dev, SEED + B + L + use_gardner)
        dm, args, dmo = c["dm"], c["args"], c["dmo"]
        s2 = 2 * S
        res = dict(rate_mhz=sh["rate_mhz"], shape=sh["shape"], B=B, L=L,
                   S=S, sps=sh["sps"],
                   mode="gardner" if use_gardner else "no_gardner",
                   layout=pipeline.tail_plan(B, S)._asdict())
        before = _kernels.DEMOD_TAIL.launches
        res["per_launch"] = check(c)
        res["launches"] = _kernels.DEMOD_TAIL.launches - before
        _verdict(res, f"demod tail at {B} x {S} ({res['mode']})")
        want = dm.decide_plain(*args)
        res["rows"] = dict(ok=int(want.ok.sum()),
                           ul=int((want.direction == 1).sum()),
                           trimmed=int((want.n_symbols.long()
                                        < args[1].sum(1)).sum()))
        fns = _fns(dm, args, dmo, s2)
        res["single_ms"] = statistics.median(samples_ms(
            fns["decide_pack"], dev, reps))
        res["chained_ms"] = time_gather(fns["decide_pack"], dev, reps)
        res["plain_ms"] = statistics.median(samples_ms(
            fns["plain"], dev, 3 if dev.type == "cuda" else 2))
        if dev.type == "cuda":
            g = exp_demod.plain_graph(fns["decide_pack"])
            res["graph_ms"], res["graph_nodes"] = g["replay_ms"], g["nodes"]
            res["in_graph_ms"] = exp_demod.in_graph_ms(fns["decide_pack"])
            res["raw_graph_ms"] = exp_demod.plain_graph(
                fns["decide_pack_raw"])["replay_ms"]
            res["plain_graph"] = exp_demod.plain_graph(fns["plain"])
            res["plain_graph_ms"] = res["plain_graph"]["replay_ms"]
            if by_layout:
                res["by_layout"] = {}
                for w in layouts(B, S):
                    with forced_layout(w):
                        got = fns["decide_pack"]()
                        if not torch.equal(got, fns["plain"]()):
                            raise AssertionError(
                                f"decide_pack at {w} warps a burst, {B} x "
                                f"{S}: not bit-equal to the twins")
                        res["by_layout"][w] = exp_demod.in_graph_ms(
                            fns["decide_pack"])
            res["designs"] = [_design(name, kern, c, want)
                              for name, kern in cands or ()]
        res["ms"] = res.get("graph_ms", res["chained_ms"])
        res["two_launch_bound_ms"] = bound(args, want, s2, True)["bound_ms"]
        fb = fused_bound(args, want, s2, True)
        res.update(fb, library_ms=None,
                   share_of_bound=fb["bound_ms"] / res["ms"])
        out.append(res)
        del c, args, dmo, want, fns
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _verdict(res: dict, where: str) -> None:
    """`bit_equal`, `max_abs_err` and `first_diff` over `per_launch`;
    raises where a launch parts from its twin."""
    per = res["per_launch"]
    res["bit_equal"] = all(v["bit_equal"] for v in per.values())
    res["max_abs_err"] = max(v["max_abs_err"] for v in per.values())
    res["first_diff"] = next(([k] + v["first_diff"] for k, v in per.items()
                              if v["first_diff"]), None)
    if not res["bit_equal"]:
        raise AssertionError(f"{where} against its twins: {per}")


def _fns(dm, args, dmo, s2: int) -> dict:
    """The calls the tool times, by name."""
    return dict(
        decide_pack=lambda: pipeline.decide_pack(dm, *args[:3], dmo, s2,
                                                 True),
        decide_pack_raw=lambda: pipeline.decide_pack(dm, *args[:3], dmo, s2,
                                                     False),
        plain=lambda: pipeline.decide_pack_plain(dm, *args[:3], dmo, s2,
                                                 True))


def _design(name: str, kern: _kernels.Kernel, c: dict, want) -> dict:
    """Another source of the kernel on the case `c`: held bit-equal to the
    twins, then its tail timed as a CUDA graph and in one (the package's
    launch, or `two_launches` where the source is that design)."""
    two = staged(kern)
    dm, args, dmo = c["dm"], c["args"], c["dmo"]
    s2 = 2 * dm.S
    with variants.swapped("DEMOD_TAIL", kern):
        per = check_two(kern, c, want) if two else check(c)
        d = dict(design=name, launches=2 if two else 1, per_launch=per)
        _verdict(d, f"demod tail ({name})")
        fn = ((lambda: two_launches(kern, dm, *args[:3], dmo, s2, True))
              if two else _fns(dm, args, dmo, s2)["decide_pack"])
        g = exp_demod.plain_graph(fn)
        d.update(graph_ms=g["replay_ms"], graph_nodes=g["nodes"],
                 in_graph_ms=exp_demod.in_graph_ms(fn),
                 ptxas=exp_demod.ptxas_summary(kern))
    return d


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
    ap.add_argument("--layouts", action="store_true",
                    help="time decide_pack at every layout the kernel "
                    "takes (card only)")
    ap.add_argument("--source", action="append", default=[],
                    help="time the package's kernel beside this kernel "
                    "source, repeatable (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if (args.layouts or args.source) and dev.type != "cuda":
        ap.error("--layouts and --source need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    cands = []
    if dev.type == "cuda":
        cands = candidates(args.source)
        for cname, k in cands:
            print(f"ptxas {cname} " + json.dumps(exp_demod.ptxas_summary(k)),
                  flush=True)
    shapes = ([SMALL] if args.small else
              [sh for r in args.rates.split(",")
               for sh in exp_demod.decode_shapes(float(r))])
    for sh in shapes:
        for r in run_shape(sh, dev, reps=3 if args.small else 7,
                           by_layout=args.layouts, cands=cands[1:]):
            print(f"{r['shape']} {r['B']} x {r['S']} {r['mode']}: "
                  f"{r['ms']:.4f} ms, bit-equal {r['bit_equal']}, plain "
                  f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.5f}"
                  + "".join(f"; {d['design']} {d['graph_ms']:.4f}"
                            for d in r.get("designs", ())) + " "
                  + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
