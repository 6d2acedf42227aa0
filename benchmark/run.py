"""The benchmark of the port (`iridium_tpu_torch`): one run of one cell.

    python3 benchmark/run.py --workload raw10_mix --seed 7 --seconds 10 \\
        --trace 0

runs from the root of a checkout, on the machine that holds the card.
The cell's configuration, traffic mix and per-layer metrics are found by
their names in `BENCHMARK.json` (`benchmark/configs/<config>.json`,
`benchmark/traffic/<traffic>.json`, `benchmark/metrics/<metric>.py`), its
limits in `benchmark/limits/<workload>.json`. With `--trace 0` the last
line of standard output is the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics from a traced window; both end with the
numbers the check compared, each beside its limit. `--control 1` also
decodes the checked groups with the reference's front-end in TF32, the
precision below the configuration's (for setting the limits; the
benchmark's own runs never do).

Exits non-zero and prints no result without a CUDA device, when the
program is absent, and when JAX or the JAX package is loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_cell(workload: str):
    """The cell named `workload` in BENCHMARK.json, with its files."""
    import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    per_layer = [m["name"] for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    import compare
    import traffic
    return harness.Cell(workload, config, traffic.load(wl["traffic"]),
                        per_layer, compare.load_limits(workload)), wl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    os.environ.setdefault("USE_FLAX", "0")
    # PyTorch's runtime-compiled kernels (the complex |X|) cached at a fixed
    # path inside the checkout (the port's own CUDA builds go to
    # build/kernels); the host's work on one thread of each pool
    cache = os.path.join(ROOT, "build", "torch_kernels")
    os.makedirs(cache, exist_ok=True)
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", cache)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch
    cell, wl = load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(wl["chips"])):
        log(f"run.py: the cell needs {wl['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " present")
        return 2
    import harness
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_PROCESS, control=bool(args.control),
                           log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"run.py: loaded modules of {bad}: the benchmark must not load "
            "JAX or the JAX package")
        return 3
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
