"""What the port's sharded-pipeline tests run in each rank of
`iridium_tpu_torch.parallel.distributed.spawn`. The ranks import this
module by name, so it imports no JAX (the test files import both)."""

import dataclasses

import numpy as np
import torch
from scipy.signal import resample_poly

from iridium_tpu_torch.config import DetectorConfig
from iridium_tpu_torch.io import synth
from iridium_tpu_torch.output.raw import RawPrinter
from iridium_tpu_torch.parallel import distributed
from iridium_tpu_torch.parallel.stream import ShardedPipeline

T0 = 1_700_000_000_000_000_000
FILE_INFO = "t1"
# test_parallel.py's tiny_cfg: 2 MHz, blocks of 64 frames of 512 bins
TINY = dict(sample_rate=2_000_000, fft_size=512, history_size=8,
            frames_per_block=64, burst_capacity=64, gone_capacity=64,
            max_new_per_frame=32, max_burst_len=18_000,
            burst_post_len=4_000)


def straddle_capture(block_samples: int, n_blocks: int) -> np.ndarray:
    """test_parallel.py's multi-block capture: 0.01 noise and 35 dB DL
    bursts inside blocks and across block boundaries (those that fit in
    n_blocks blocks)."""
    bs = block_samples
    rng = np.random.default_rng(7)
    total = n_blocks * bs
    cap = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
           ).astype(np.complex64) * np.float32(0.01 / np.sqrt(2))
    placements = [(12_000, 120_000.0, 1), (bs - 6_000, -350_000.0, 2),
                  (bs + 40_000, 480_000.0, 3),
                  (2 * bs + 5_000, -120_000.0, 4),
                  (3 * bs + 10_000, 240_000.0, 5)]
    rate = 2_000_000
    m = max(4 * rate // 25_000, 8)
    ramp = (0.5 - 0.5 * np.cos(np.pi * np.arange(m) / m)).astype(np.float32)
    for start, freq, seed in placements:
        bits = np.random.default_rng(seed).integers(0, 2, 160).astype(
            np.uint8)
        bb = synth.modulate(synth.burst_symbols(bits, "DL"))
        x = resample_poly(bb, up=rate // 250_000, down=1).astype(np.complex64)
        if start + len(x) > total:
            continue
        x[:m] *= ramp
        x[-m:] *= ramp[::-1]
        t = np.arange(len(x), dtype=np.float64)
        x = (x * np.exp(2j * np.pi * freq / rate * t)).astype(np.complex64)
        cap[start:start + len(x)] += np.float32(0.01 * 10 ** (35 / 20)) * x
    return cap


def decode_runs(cfg_kw: dict, cap: np.ndarray, runs: list,
                tables_mode: str | None = None) -> dict:
    """In a rank: each run's ShardedPipeline (burst_batch 4, the run's
    keywords) over `cap` on the CPU -> its RAW lines (rank 0's only),
    stats, timing and k_hops; with `tables_mode`, also the gone tables the
    detect step of that mode gathers, block by block, from a fresh
    pipeline."""
    torch.set_num_threads(1)
    mesh = distributed.make_mesh()
    cfg = DetectorConfig(**cfg_kw)
    out = dict(rank=mesh.rank, runs=[])
    for kw in runs:
        sp = ShardedPipeline(cfg, mesh=mesh, burst_batch=4, start_time_ns=T0,
                             device="cpu", **kw)
        printer = RawPrinter(FILE_INFO)
        lines = [printer.format(f) for f in sp.run_array(cap)]
        out["runs"].append(dict(lines=lines,
                                stats=dataclasses.asdict(sp.stats),
                                timing=dict(sp.timing), k_hops=sp.k_hops))
    if tables_mode:
        sp = ShardedPipeline(cfg, mesh=mesh, burst_batch=4, start_time_ns=T0,
                             device="cpu", detect_mode=tables_mode)
        bs = sp.p.block_samples
        out["tables"] = [sp._dispatch_step(cap[i:i + bs], bs).tables.numpy()
                         for i in range(0, len(cap), bs)]
    return out


def fail_on_rank(bad: int) -> int:
    """Raise in rank `bad`; the other ranks return their rank."""
    rank = distributed.make_mesh().rank
    if rank == bad:
        raise ValueError(f"rank {rank} was asked to fail")
    return rank
