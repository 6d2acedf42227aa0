"""The sharded pipeline over N cards against one card.

    python -m iridium_tpu_torch.tools.exp_mesh [--ranks N]
        [--jobs raw_10mhz,binshard_1mhz,...] [--no-grouping]

Captures (`tools/captures.py`) decode through `ShardedPipeline` in N
spawned ranks, one card each over NCCL (`distributed.spawn`; N is every
card by default), as four jobs (`--jobs` picks some): the RAW and dense
10 MHz captures in replicated mode (`raw_10mhz`, `dense_10mhz`), the 1
MHz capture and the RAW 10 MHz one in binshard mode (`binshard_1mhz`,
`binshard_10mhz`: detect_fast's kernel split around the all_reduce of
each frame's pair). Each also decodes on card 0
through the single card's `Pipeline` (detect_fast for the binshard
capture, whose ids differ by design) at its default grouping of 4 blocks
and at one block a group. Every decode runs twice and the second run is
timed, on the ranks from a barrier.

For each capture the tool prints the ranks' lines against each single
card run and the single card's two groupings against each other: the
lines that are equal, and per RAW field the lines where it differs with
the largest difference of the numeric ones (ids masked in binshard
mode). It fails if the line counts differ or a field other than the
frequency and the level differs. Then every rank's wall, the realtime
factor of the slowest, the collectives' device ms and the kernel
launches summed over the ranks.

`grouping` (left out with `--no-grouping`) asks why one card's lines
move with the grouping: the dense
capture decodes on card 0 through the host-routed flow (eager class
batches) at 4 blocks and at 1 block a group, once with the fused
front-end kernel and once with its plain version (`fused_plain`) in the
kernel's place; the lines of each pair are compared as above, and the
kernel's against the plain version's at each grouping. Every number
names the card (`nvidia-smi`).
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import re
import subprocess
import tempfile
import time

import torch

from ..output.raw import RawPrinter
from . import captures

T0 = 1_700_000_000_000_000_000
SEED = 1234
# RAW line fields (output/raw.py), by position after split()
FIELDS = ("tag", "file", "time_ms", "frequency", "magnitude_noise", "id",
          "confidence", "level", "payload_symbols", "bits")
# a burst's window starts at another offset of the front-end's tiles with
# the grouping (and the rank's slice): these may round otherwise
LOOSE = ("frequency", "level")


def strip_id(line: str) -> str:
    return re.sub(r"I:\d{11}", "I:-----------", line)


def raw_lines(frames) -> list:
    """RAW lines of a decode's frames in time order (then frequency): a
    printer takes its time base and file name from the first frame it
    prints, and binshard yields a block's frames in the order of its ids,
    which are strided by rank, so each decode is printed from its
    earliest frame."""
    printer = RawPrinter()
    return [printer.format(f) for f in sorted(
        frames, key=lambda f: (f["timestamp_ns"], f["frequency"]))]


def compare_lines(got: list, want: list, masked: bool) -> dict:
    """RAW lines of one decode against another's, line for line (both
    sorted, ids masked, when `masked`): the number of lines, those equal,
    and per differing field the lines and the largest difference where
    the field is a number. Raises if the counts differ or a field other
    than LOOSE differs."""
    if masked:
        got, want = sorted(map(strip_id, got)), sorted(map(strip_id, want))
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} lines against {len(want)}")
    fields: dict = {}
    for g, w in zip(got, want):
        for name, a, b in zip(FIELDS, g.split(), w.split()):
            if a == b:
                continue
            f = fields.setdefault(name, dict(lines=0, max_diff=None))
            f["lines"] += 1
            try:
                d = abs(float(a) - float(b))
            except ValueError:
                continue
            f["max_diff"] = max(f["max_diff"] or 0.0, d)
    strict = sorted(set(fields) - set(LOOSE))
    if strict:
        raise AssertionError(f"fields {strict} differ: {fields}")
    return dict(lines=len(got), equal=sum(g == w for g, w in zip(got, want)),
                fields=fields)


def mesh_rank(jobs: list) -> dict:
    """In each rank: each job (name, capture file, detector keywords,
    detect mode) through a ShardedPipeline twice, the second run timed
    from a barrier; its lines (rank 0's only), wall, collectives and
    launches."""
    import torch.distributed as dist
    from .. import _kernels
    from ..config import DetectorConfig
    from ..parallel import distributed
    from ..parallel.stream import ShardedPipeline

    mesh = distributed.make_mesh()
    out = {}
    for name, path, det_kw, mode in jobs:
        sp = ShardedPipeline(DetectorConfig(**det_kw), mesh=mesh,
                             start_time_ns=T0, want_llr=False,
                             burst_batch=128, detect_mode=mode)
        list(sp.run_file(path))
        sp.reset(T0)
        torch.cuda.synchronize()
        dist.barrier()
        _kernels.reset_counts()
        t = time.perf_counter()
        frames = list(sp.run_file(path))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out[name] = dict(lines=raw_lines(frames), wall_s=wall,
                         k_hops=sp.k_hops,
                         collectives_ms=1e3 * sp.timing["collectives"],
                         n_collectives=sp.timing["n_collectives"],
                         stages=dict(sp.timing),
                         launches={k.name: k.launches
                                   for k in _kernels.KERNELS})
        del sp
        torch.cuda.empty_cache()
    return out


def single_card(path: str, det_kw: dict, mode: str, agg: int,
                host_routed: bool = False, warm: bool = True) -> tuple:
    """(lines, wall) of the single-card decode on card 0, timed after a
    warm-up decode when `warm`."""
    from ..config import DetectorConfig
    from ..runtime.pipeline import Pipeline

    pipe = Pipeline(det_cfg=DetectorConfig(**det_kw), start_time_ns=T0,
                    want_llr=False, agg_blocks=agg,
                    detect_impl="fast" if mode == "binshard" else "auto")
    pipe.host_routed = host_routed
    if warm:
        list(pipe.run_file(path))
        pipe.reset(T0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = list(pipe.run_file(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lines = raw_lines(frames)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return lines, wall


def grouping(path: str) -> dict:
    """The dense capture on one card, host-routed, at 4 and at 1 block a
    group, with the front-end kernel and with `fused_plain` in its place:
    each front-end's two groupings compared, and the two front-ends at
    each grouping."""
    from ..ops import fused_frontend as ff

    kernel, lines = ff.fused, {}
    try:
        for name, fn in (("kernel", kernel), ("plain", ff.fused_plain)):
            ff.fused = fn
            for agg in (4, 1):
                lines[name, agg] = single_card(
                    path, captures.PROD, "replicated", agg,
                    host_routed=True, warm=False)[0]
    finally:
        ff.fused = kernel
    pairs = {f"{name}_agg1_vs_agg4": (lines[name, 1], lines[name, 4])
             for name in ("kernel", "plain")}
    pairs |= {f"kernel_vs_plain_agg{agg}": (lines["kernel", agg],
                                             lines["plain", agg])
              for agg in (4, 1)}
    return {k: witness(a, b) for k, (a, b) in pairs.items()}


def witness(a: list, b: list) -> dict:
    """Two decodes' lines: their counts, the lines of each that the other
    lacks, and `compare_lines`' fields, or why it refused them."""
    ca, cb = collections.Counter(a), collections.Counter(b)
    out = dict(lines=[len(a), len(b)], only_first=sum((ca - cb).values()),
               only_second=sum((cb - ca).values()))
    try:
        out["fields"] = compare_lines(a, b, False)["fields"]
    except AssertionError as e:
        out["fields"] = str(e)[:2000]
    return out


# name -> (capture, detector keywords, detect mode)
JOBS = {
    "raw_10mhz": (lambda: captures.production_capture(SEED)[0],
                  captures.PROD, "replicated"),
    "dense_10mhz": (lambda: captures.dense_capture(SEED + 8)[0],
                    captures.PROD, "replicated"),
    "binshard_1mhz": (lambda: captures.capture_1mhz(SEED + 3),
                      dict(sample_rate=1_000_000), "binshard"),
    "binshard_10mhz": (lambda: captures.production_capture(SEED)[0],
                       captures.PROD, "binshard"),
}


def run(n: int, tmp: str, names=tuple(JOBS), with_grouping=True) -> dict:
    from .. import _kernels
    from ..parallel import distributed

    # every kernel built once here, which the ranks then load, rather than
    # by each rank at its first launch
    _kernels.build_all()
    jobs, seconds = [], {}
    for name in names:
        make, det_kw, mode = JOBS[name]
        cap = make()
        path = os.path.join(tmp, name + ".cf32")
        captures.write_cf32(path, cap)
        jobs.append((name, path, det_kw, mode))
        seconds[name] = len(cap) / det_kw["sample_rate"]
        del cap
    single = {(name, agg): single_card(path, det_kw, mode, agg)
              for name, path, det_kw, mode in jobs for agg in (4, 1)}
    res = dict(ranks=n)
    if with_grouping:
        path = os.path.join(tmp, "dense_10mhz.cf32")
        if "dense_10mhz" not in names:
            captures.write_cf32(path, JOBS["dense_10mhz"][0]())
        res["grouping"] = grouping(path)
    ranks = distributed.spawn(mesh_rank, n, None, jobs, timeout=1000)
    for name, path, det_kw, mode in jobs:
        (want, wall1), (want1, _) = single[name, 4], single[name, 1]
        got = ranks[0][name]["lines"]
        if not want:
            raise AssertionError(f"{name}: no line on one card")
        if any(r[name]["lines"] for r in ranks[1:]):
            raise AssertionError(f"{name}: a rank other than 0 yielded "
                                 "lines")
        masked = mode == "binshard"
        try:
            vs = dict(single_agg4=compare_lines(got, want, masked),
                      single_agg1=compare_lines(got, want1, masked),
                      single_agg1_vs_agg4=compare_lines(want1, want, False))
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        walls = [r[name]["wall_s"] for r in ranks]
        res[name] = dict(
            mode=mode, ids_masked=masked, compare=vs,
            capture_s=seconds[name], k_hops=ranks[0][name]["k_hops"],
            wall_s=walls, realtime_x=seconds[name] / max(walls),
            single_wall_s=wall1, single_realtime_x=seconds[name] / wall1,
            collectives_ms=[r[name]["collectives_ms"] for r in ranks],
            n_collectives=ranks[0][name]["n_collectives"],
            stages_rank0=ranks[0][name]["stages"],
            launches={k: sum(r[name]["launches"][k] for r in ranks)
                      for k in ranks[0][name]["launches"]})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, metavar="N",
                    help="ranks, one card each (default: every card)")
    ap.add_argument("--jobs", default=",".join(JOBS),
                    help="comma-separated jobs: " + ", ".join(JOBS))
    ap.add_argument("--no-grouping", action="store_true",
                    help="leave out the single card's grouping study")
    args = ap.parse_args(argv)
    names = args.jobs.split(",")
    for name in names:
        if name not in JOBS:
            ap.error(f"unknown job {name!r}")
    if not torch.cuda.is_available():
        raise SystemExit("exp_mesh runs on the card: no CUDA device")
    n = args.ranks or torch.cuda.device_count()
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--ranks {n} on {torch.cuda.device_count()} "
                         "cards")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run(n, tmp, names, not args.no_grouping)
    print(json.dumps(dict(res, card=card, seconds=time.perf_counter() - t)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
