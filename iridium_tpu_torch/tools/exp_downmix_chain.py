"""The downmix chain's steps around its FIRs (dsp/downmix.py `burst_start`,
`cfo_peak`, `sync_products`, `sync_extract`: csrc/downmix_chain.cu) and
the sync search's input that the FIR kernel's stage 1 writes
(`frame_rrc_sync`) at the burst classes' batches.

    python -m iridium_tpu_torch.tools.exp_downmix_chain [--rates 10,400,1600]
        [--clusters] [--source PATH ...]
    python -m iridium_tpu_torch.tools.exp_downmix_chain --device cpu --small

The shapes follow the code: the three class batches (batch, dec_cap) of
the production 10 MHz group program, and with `--rates` those of the 400
MHz and 1.6 GHz (256 frames a block) decodes at `exp_demod.WIDE_RUN`,
each with its class's `Downmix` constants (`Downmix.chain`, the window and
the templates). `inputs` makes the decimated rows: noise with a stronger
stretch from a random start in most rows, lengths, leads and bins, and
in the first rows the edges (dec_len 0, 1, 19, 20, 21 and L; a lead past
dec_len and one past the row; a window too short for ok; a row of zeros).

The chain runs once through the twins on the card's inputs (`chain`: each
stage's input is the previous twin's output, the FFTs between them), and
each launch is held to its twin on the same inputs: `bit_equal`
(torch.equal, which takes -0 for 0) and, where they part, the first field,
row and index (`first_diff`). Then the tool times each launch (median
single call), the four as one CUDA graph (`graph_ms`, the row's `ms`; on
the CPU the chained host time), each launch as a graph of its own, the
twins' tensor code eagerly and as one graph (`plain_ms`, `plain_graph_ms`),
and `frame_rrc_sync` beside `frame_rrc` (what writing the sync search's
input adds to the FIR kernel's stage 1). `bound` counts what this data
needs: bytes, each input read once where the masks keep it and each output
written once, at 3.35 TB/s; FP32 operations (|x|^2 three, a complex
product six) at 128 lanes x 132 SMs at the card's top SM clock. No
PyTorch call computes these steps (`library_ms` None). `ffts` says
whether cuFFT gives the zero-padded FFTs the same values as torch.fft's
n= padding, and the one inverse FFT of both templates the same values as
one of each. `layout` is the batch's `downmix.plan` (the cluster of
stages 0 and 3, stage 0's staged part and shared memory, and stage 1's
cluster).

`--clusters` (card only) runs the four launches at every cluster size of
`downmix.CLUSTERS` (each launch held bit-equal first) and times them as a
graph (`by_cluster`). `--source PATH` (card only, repeatable) builds
another source of the kernel under the git-ignored build/
(`tools/variants.py`) and times its four launches beside the package's on
the same inputs, each held bit-equal to its twin (`designs`); a source
whose entry takes no layout (the design of a block a row: `git show
f8c2903:iridium_tpu_torch/csrc/downmix_chain.cu > build/old_chain.cu`)
gets an adapter (`adapted`). On the card each time as a graph also has
`in_graph_ms`: ten calls captured as one graph, its replay over ten, the
device's time a call inside a class graph without the replay's own
launch; `by_cluster` is that time.

On the CPU (`--small`: 12 rows of 1,024 samples at 10 MHz) the wrappers
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

from .. import _kernels, device as device_mod
from ..config import DetectorConfig
from ..dsp import downmix
from . import exp_demod, variants
from .exp_block_gather import time_gather
from .exp_downmix import LANES, SMS, sm_clock_hz
from .exp_frontend import HBM_BYTES_PER_S
from .exp_window_gather import samples_ms

SEED = 2121
STAGES = ("burst_start", "cfo_peak", "sync_products", "sync_extract")
ABS2_OPS, CMUL_OPS = 3, 6       # FP32 operations of |x|^2, x y (complex)


def class_shapes(rate_mhz: float = 10.0) -> list[dict]:
    """The three class batches (batch, dec_cap) of the decode at
    `rate_mhz` (`exp_demod.decode_shapes`'s decodes), each with its
    class's CPU `Downmix` (`dm`, not printed)."""
    from ..runtime.pipeline import Pipeline
    det = dict(sample_rate=int(round(rate_mhz * 1e6)))
    kw = {}
    if rate_mhz != 10.0:
        kw = dict(exp_demod.WIDE_RUN)
        if rate_mhz == 1600.0:
            det["frames_per_block"] = 256
    pipe = Pipeline(det_cfg=DetectorConfig(**det), device="cpu", **kw)
    return [dict(rate_mhz=rate_mhz, shape=name, B=c.batch, L=c.dec_cap,
                 dm=c.downmix)
            for name, c in zip(exp_demod.CLASS_NAMES, pipe.classes)]


def small_shape() -> dict:
    """12 rows of 1,024 samples with the 10 MHz downmix's constants (the
    frames extracted up to the simplex length)."""
    from ..config import DownmixConfig
    p = DetectorConfig().derived()
    dmp = DownmixConfig().derived(p)
    dm = downmix.Downmix(p, dmp, 1024, dmp.max_frame_samples,
                         torch.device("cpu"))
    return dict(rate_mhz=10.0, shape="small", B=12, L=1024, dm=dm)


def inputs(B: int, L: int, k: downmix.ChainConsts, in_ntaps: int,
           seed: int) -> dict:
    """Numpy inputs of `Downmix.forward` for B rows of L: x (B, L) c64,
    unit noise plus, in most rows, a stretch 8 times stronger from a
    random start in [0, L / 3); dec_len uniform in [L / 4, L] as ext_len
    (dec_len decim + in_ntaps - 1 plus a remainder below decim);
    shift_dec 0 in most rows, in [1, 200] in a quarter; center_bin
    uniform over the detector's bins. The first rows, where B has them:
    dec_len 0, 1, 19, 20, 21 and L; a lead past dec_len; a lead past the
    row; a window too short behind its lead (ok false at once); a row of
    zeros."""
    rng = np.random.default_rng(seed)
    x = ((rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L)))
         / np.sqrt(2)).astype(np.complex64)
    for b in range(B):
        if rng.random() < 0.8:
            s0 = int(rng.integers(0, max(L // 3, 1)))
            x[b, s0:] *= 8
    dec_len = rng.integers(L // 4, L + 1, B)
    shift = np.where(rng.random(B) < 0.25, rng.integers(1, 201, B), 0)
    bins = rng.integers(0, k.fft_size, B)
    edges = [(d, 0) for d in (0, 1, 19, 20, 21, L)]
    edges += [(L // 2, L // 2 + 10), (L, L + 5), (120, 30), (L, 0)]
    for b, (d, s) in enumerate(edges[:B]):
        dec_len[b], shift[b] = d, s
    ext = dec_len * k.decim + in_ntaps - 1 + rng.integers(0, k.decim, B)
    if B > 8:
        ext[8] = shift[8] * k.decim + 99
    if B > 9:
        x[9] = 0
    return dict(x=x, ext_len=ext.astype(np.int64),
                shift_dec=shift.astype(np.int64),
                center_bin=bins.astype(np.int64))


def chain(t: dict, dm: downmix.Downmix) -> dict:
    """The chain through the twins on inputs `t` (tensors of `inputs` on
    the device): each stage's arguments (`args`, by stage, with
    `frame_rrc_sync`'s) and its twin's output (`want`), the FFTs between
    them as `Downmix.forward` runs them."""
    k = dm.chain
    ext_len, shift_dec = t["ext_len"], t["shift_dec"]
    dec_len = torch.clamp((ext_len - dm.in_ntaps + 1) // dm.decim, 0,
                          dm.dec_cap)
    xd, filt = downmix.noise_box(t["x"], dec_len, shift_dec, dm.noise_taps,
                                 dm.box_taps)
    args, want = {}, {}
    args["burst_start"] = (xd, filt, ext_len, dec_len, shift_dec,
                           dm.cfo_win, k)
    want["burst_start"] = downmix.burst_start_plain(*args["burst_start"])
    start, frame_len, ok, z = want["burst_start"]
    args["cfo_peak"] = (torch.fft.fft(z),)
    want["cfo_peak"] = downmix.cfo_peak_plain(*args["cfo_peak"])
    u, corr, fine_offset = want["cfo_peak"]
    args["frame_rrc_sync"] = (xd, start, frame_len, u, corr, dm.rrc_taps,
                              k.cfo_total, k.search_cap, k.corr_n)
    want["frame_rrc_sync"] = downmix.frame_rrc_sync_plain(
        *args["frame_rrc_sync"])
    xr, fwd_in = want["frame_rrc_sync"]
    args["sync_products"] = (torch.fft.fft(fwd_in), dm.dl_fft, dm.ul_fft)
    want["sync_products"] = downmix.sync_products_plain(
        *args["sync_products"])
    cc = torch.fft.ifft(want["sync_products"])
    args["sync_extract"] = (cc, xr, start, frame_len, ok, t["center_bin"],
                            fine_offset, k)
    want["sync_extract"] = downmix.sync_extract_plain(*args["sync_extract"])
    return dict(args=args, want=want, dec_len=dec_len)


def compare(got, want, names=None) -> dict:
    """Outputs (tensors, a tuple or a DownmixOut) against the twin's:
    `bit_equal`, the largest |err|, and the first field, row and index
    where they part (`first_diff`, None where none does)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    names = names or getattr(got, "_fields", None) or [
        str(i) for i in range(len(got))]
    res = dict(bit_equal=True, max_abs_err=0.0, first_diff=None)
    for name, a, b in zip(names, got, want):
        if torch.equal(a, b):
            continue
        res["bit_equal"] = False
        if a.shape != b.shape or a.dtype != b.dtype:
            res["first_diff"] = res["first_diff"] or [name, None, None]
            continue
        if a.dtype != torch.bool:
            err = (a.to(torch.complex128) - b.to(torch.complex128)).abs()
            res["max_abs_err"] = max(res["max_abs_err"],
                                     float(err.nan_to_num(np.inf).max()))
        if res["first_diff"] is None:
            # by row of the last dimension ((2, B, n): template b, then b)
            d = (a != b).reshape(-1, a.shape[-1] if a.dim() > 1 else 1)
            row = int(d.any(1).int().argmax())
            res["first_diff"] = [name, row, int(d[row].int().argmax())]
    return res


def ffts(z: torch.Tensor, cfo_n: int, prod: torch.Tensor) -> dict:
    """Whether torch.fft on the zero-padded rows z (B, cfo_total) equals
    torch.fft.fft(z[:, :cfo_n], n=cfo_total), and one inverse FFT of the
    (2, B, corr_n) products equals one of each half."""
    n = z.shape[1]
    both = torch.fft.ifft(prod)
    return dict(padded_fft_equal=torch.equal(
                    torch.fft.fft(z), torch.fft.fft(z[:, :cfo_n], n=n)),
                batched_ifft_equal=torch.equal(both[0], torch.fft.ifft(
                    prod[0])) and torch.equal(both[1],
                                              torch.fft.ifft(prod[1])))


def bound(run: dict, clock_hz: float) -> dict:
    """What this data needs, per stage and in all (`chain`'s run): bytes
    (each input read once where the masks keep it, each output written
    once) and FP32 operations; the bound in ms by each and by the larger
    of the totals."""
    a, w = run["args"], run["want"]
    xd, filt, ext_len, dec_len, shift_dec, win, k = a["burst_start"]
    B, L = filt.shape
    start, frame_len, _, z = w["burst_start"]
    flen = torch.clamp(dec_len - k.box_ntaps + 1, 0, L)
    ncfo = torch.clamp(torch.minimum(frame_len, torch.full_like(
        frame_len, win.shape[0])), min=0)
    cfo_read = torch.clamp(torch.minimum(ncfo, L - start), min=0)
    n_cfo = z.shape[1]
    corr_n = a["sync_products"][0].shape[1]
    search = torch.clamp(torch.minimum(
        frame_len, torch.full_like(frame_len, k.search_cap)), 0, corr_n)
    # the samples the extraction reads: those it leaves non-zero
    extracted = int(torch.count_nonzero(w["sync_extract"].samples))
    stages = {
        "burst_start": (4 * int(flen.sum()) + 8 * int(cfo_read.sum())
                        + 4 * win.shape[0] + 24 * B
                        + 8 * B * n_cfo + 17 * B,
                        2 * CMUL_OPS * int(ncfo.sum())),
        "cfo_peak": (8 * B * n_cfo + 16 * B, ABS2_OPS * B * n_cfo),
        "sync_products": (8 * B * corr_n + 16 * corr_n + 16 * B * corr_n,
                          2 * CMUL_OPS * B * corr_n),
        "sync_extract": (16 * int(search.sum()) + 8 * extracted + 29 * B
                         + 8 * B * k.max_frame_cap + 17 * B,
                         2 * ABS2_OPS * int(search.sum())
                         + CMUL_OPS * extracted),
    }
    rate = SMS * LANES * clock_hz
    res = {name: dict(bytes=nb, ops=ops,
                      bound_ms=max(nb / HBM_BYTES_PER_S, ops / rate) * 1e3)
           for name, (nb, ops) in stages.items()}
    nb = sum(v[0] for v in stages.values())
    ops = sum(v[1] for v in stages.values())
    t_b, t_o = nb / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=nb, bytes_ms=t_b, bound_ops=ops, ops_ms=t_o,
                clock_hz=clock_hz, stages=res)


PLAIN_FNS = {name: getattr(downmix, name + "_plain") for name in STAGES}
# the layout's ints each stage's C entry takes last (`downmix.plan`)
LAYOUT_INTS = (2, 1, 0, 1)


def adapted(text: str) -> str:
    """A source whose `downmix_chain` entry takes no layout (its stage 0
    takes five ints) behind an entry that drops the layout's ints
    (LAYOUT_INTS) before it; a source that takes one as it is."""
    if "{{10, 5, 1}" not in text:
        return text
    text = text.replace('extern "C" int downmix_chain(',
                        'static int downmix_chain_inner(', 1)
    return text + """
// the package's entry: the layout's ints, which this design takes none of,
// dropped
extern "C" int downmix_chain(int stage, int B, long long L,
                             void* const* ptrs, int n_ptrs,
                             const long long* ints, int n_ints,
                             const float* floats, int n_floats,
                             cudaStream_t stream) {
  static const int kLayout[4] = {""" + ", ".join(map(str, LAYOUT_INTS)) + \
        """};
  const int drop = stage >= 0 && stage < 4 ? kLayout[stage] : 0;
  return downmix_chain_inner(stage, B, L, ptrs, n_ptrs, ints, n_ints - drop,
                             floats, n_floats, stream);
}
"""


def candidates(sources=()) -> list[tuple]:
    """[(name, kernel)]: the package's kernel and a Variant of it per
    source (`adapted`), built at once."""
    return variants.candidates(_kernels.DOWNMIX_CHAIN, sources, adapted)


@contextlib.contextmanager
def forced_cluster(cluster: int):
    """Stages 0, 1 and 3 at clusters of `cluster` blocks, whatever
    `downmix.plan` picks."""
    saved = downmix.plan
    downmix.plan = lambda B, L: saved(B, L, cluster=cluster)
    try:
        yield
    finally:
        downmix.plan = saved


def held(a: dict, w: dict, where: str) -> dict:
    """The four launches on the chain's arguments `a`, each held to its
    twin's outputs `w` (raises where one parts): {launch: compare's}."""
    res = {}
    for name in STAGES:
        got = getattr(downmix, name)(*a[name])
        res[name] = compare(got, w[name])
        del got
    bad = {n: r for n, r in res.items() if not r["bit_equal"]}
    if bad:
        raise AssertionError(f"downmix chain ({where}) against its twins: "
                             f"{bad}")
    return res


def run_shape(sh: dict, dev: torch.device, reps: int = 7,
              clock_hz: float | None = None, clusters: bool = False,
              cands=None) -> dict:
    """One shape: each launch held to its twin on the chain's inputs
    (raises where one parts, with its `first_diff`), `frame_rrc_sync` to
    its twin too, the FFTs' equalities, then the times and the bound; with
    `clusters`, the four at every cluster size (`by_cluster`); each of
    `cands` ((name, kernel) from `candidates` but the package's) held and
    timed in `designs`."""
    B, L = sh["B"], sh["L"]
    dm = sh["dm"].to(dev)
    k = dm.chain
    t = {name: torch.from_numpy(v).to(dev) for name, v in inputs(
        B, L, k, dm.in_ntaps, SEED + B + L).items()}
    run = chain(t, dm)
    a, w = run["args"], run["want"]
    lay = downmix.plan(B, L)
    res = dict(rate_mhz=sh["rate_mhz"], shape=sh["shape"], B=B, L=L,
               layout=dict(lay._asdict(),
                           cfo_peak_cluster=downmix.plan(
                               B, k.cfo_total).cluster))
    before = _kernels.DOWNMIX_CHAIN.launches
    res["per_launch"] = held(a, w, f"{B} x {L}")
    got = downmix.frame_rrc_sync(*a["frame_rrc_sync"])
    res["frame_rrc_sync"] = compare(got, w["frame_rrc_sync"],
                                    ("xr", "fwd_in"))
    del got
    res["launches"] = _kernels.DOWNMIX_CHAIN.launches - before
    res["bit_equal"] = all(r["bit_equal"] for r in res["per_launch"].values())
    res["max_abs_err"] = max(r["max_abs_err"]
                             for r in res["per_launch"].values())
    res["first_diff"] = next(([n] + r["first_diff"] for n, r in
                              res["per_launch"].items() if r["first_diff"]),
                             None)
    if not res["frame_rrc_sync"]["bit_equal"]:
        raise AssertionError(f"frame_rrc_sync at {B} x {L} against its "
                             f"twin: {res['frame_rrc_sync']}")
    res["ffts"] = ffts(w["burst_start"][3], dm.cfo_win.shape[0],
                       w["sync_products"])
    res["rows"] = dict(ok=int(w["sync_extract"].ok.sum()),
                       dl=int((w["sync_extract"].direction == 0).sum()),
                       no_hit=int((run["dec_len"] - k.box_ntaps + 1 <= 0)
                                  .sum()))

    def launches(fns=None):
        # the wrappers by their module globals, so that a swap takes them
        def fn():
            for name in STAGES:
                (fns or vars(downmix))[name](*a[name])
        return fn
    both, plain = launches(), launches(PLAIN_FNS)
    for name in STAGES:
        res["per_launch"][name]["ms"] = statistics.median(samples_ms(
            lambda name=name: getattr(downmix, name)(*a[name]), dev, reps))
    res["chained_ms"] = time_gather(both, dev, reps)
    res["plain_ms"] = statistics.median(samples_ms(
        plain, dev, 1 if dev.type == "cuda" else 2))
    if dev.type == "cuda":
        res["graph_ms"] = exp_demod.plain_graph(both)["replay_ms"]
        res["in_graph_ms"] = exp_demod.in_graph_ms(both)
        res["plain_graph"] = exp_demod.plain_graph(plain)
        res["plain_graph_ms"] = res["plain_graph"]["replay_ms"]
        for name in STAGES:
            fn = (lambda name=name: getattr(downmix, name)(*a[name]))
            res["per_launch"][name]["graph_ms"] = exp_demod.plain_graph(
                fn)["replay_ms"]
            res["per_launch"][name]["in_graph_ms"] = exp_demod.in_graph_ms(fn)
        if clusters:
            res["by_cluster"] = {}
            for c in downmix.CLUSTERS:
                with forced_cluster(c):
                    held(a, w, f"{B} x {L}, clusters of {c}")
                    res["by_cluster"][c] = exp_demod.in_graph_ms(both)
        res["designs"] = []
        for name, kern in cands or ():
            with variants.swapped("DOWNMIX_CHAIN", kern):
                d = dict(design=name,
                         per_launch=held(a, w, f"{name}, {B} x {L}"))
                d["graph_ms"] = exp_demod.plain_graph(both)["replay_ms"]
                d["in_graph_ms"] = exp_demod.in_graph_ms(both)
                for n in STAGES:
                    fn = (lambda n=n: getattr(downmix, n)(*a[n]))
                    d["per_launch"][n]["graph_ms"] = exp_demod.plain_graph(
                        fn)["replay_ms"]
                    d["per_launch"][n]["in_graph_ms"] = (
                        exp_demod.in_graph_ms(fn))
                d["ptxas"] = exp_demod.ptxas_summary(kern)
            res["designs"].append(d)
        fr = a["frame_rrc_sync"]
        res["frame_rrc_sync_graph_ms"] = exp_demod.plain_graph(
            lambda: downmix.frame_rrc_sync(*fr))["replay_ms"]
        res["frame_rrc_graph_ms"] = exp_demod.plain_graph(
            lambda: downmix.frame_rrc(*fr[:7]))["replay_ms"]
    res["ms"] = res.get("graph_ms", res["chained_ms"])
    clock = clock_hz or sm_clock_hz(dev)
    b = bound(run, clock)
    for name in STAGES:
        res["per_launch"][name]["bound_ms"] = b["stages"][name]["bound_ms"]
    del b["stages"]
    res.update(b, library_ms=None,
               share_of_bound=b["bound_ms"] / res["ms"])
    del run, a, w, t
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="exp_downmix_chain",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="a small shape for the CPU")
    ap.add_argument("--rates", default="10",
                    help="comma-separated decodes whose class batches to "
                    "run, in MHz: 10, 400, 1600")
    ap.add_argument("--clusters", action="store_true",
                    help="time the launches at every cluster size (card "
                    "only)")
    ap.add_argument("--source", action="append", default=[],
                    help="time the package's kernel beside this kernel "
                    "source, repeatable (card only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if (args.clusters or args.source) and dev.type != "cuda":
        ap.error("--clusters and --source need the card")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    cands = []
    if dev.type == "cuda":
        cands = candidates(args.source)
        for cname, k in cands:
            print(f"ptxas {cname} " + json.dumps(exp_demod.ptxas_summary(k)),
                  flush=True)
    shapes = ([small_shape()] if args.small else
              [sh for r in args.rates.split(",")
               for sh in class_shapes(float(r))])
    clock = sm_clock_hz(dev)
    for sh in shapes:
        r = run_shape(sh, dev, reps=3 if args.small else 7, clock_hz=clock,
                      clusters=args.clusters, cands=cands[1:])
        print(f"{r['shape']} {r['B']} x {r['L']}: {r['ms']:.4f} ms, "
              f"bit-equal {r['bit_equal']}, plain {r['plain_ms']:.3f}, "
              f"bound {r['bound_ms']:.5f}"
              + "".join(f"; {d['design']} {d['graph_ms']:.4f}"
                        for d in r.get("designs", ())) + " "
              + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
