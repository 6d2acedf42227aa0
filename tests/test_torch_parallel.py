"""The port's sharded pipeline (iridium_tpu_torch/parallel/) on the CPU, in
gloo ranks started by `distributed.spawn` (one spawn per world size, every
mode inside it; tests/torch_mesh_worker.py is what the ranks run).

Configurations: test_parallel.py's tiny config and its 4-block capture
(bursts inside blocks and across block boundaries) at 4 ranks, where
l_ext (61,440) spans 8 slices of 8,192 samples, so each rank's left part
comes from the gathered block; and the same with 256-frame blocks (2
blocks of 131,072 samples) at 2 ranks, where one ring shift brings it.

Held against the port's single-card Pipeline(device="cpu") on the same
capture: replicated mode, RAW lines with the burst ids (the same scan over
the same rows); binshard mode, lines with the `I:` field masked (the ranks'
ids are offset by the rank and strided by n), as test_parallel.py does.
Held against the JAX package: the binshard detect step's per-rank gone
tables at 4 ranks against JAX's ShardedPipeline on 4 virtual devices
(ids, starts, stops and bins exact, dB fields rtol 1e-5 as in
test_torch_detect_fast.py), and the replicated lines, ids included, against
the JAX single-chip Pipeline, with the port at detect_impl="fast" (the JAX
Pipeline's scan on the CPU; frequency within 1 Hz, as
test_torch_pipeline.py holds the two packages).
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu.parallel.stream import ShardedPipeline as JaxSharded  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.parallel import distributed  # noqa: E402
from iridium_tpu_torch.parallel.stream import ShardedPipeline  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402

# world size -> (config, blocks, [(run, ShardedPipeline keywords, the
# single card's detect_impl)])
WORLDS = {
    2: (dict(worker.TINY, frames_per_block=256), 2, [
        ("replicated", dict(detect_mode="replicated"), "auto"),
        ("replicated_agg1", dict(detect_mode="replicated", agg_blocks=1),
         "auto"),
        ("binshard", dict(detect_mode="binshard"), "fast"),
        ("binshard_agg1", dict(detect_mode="binshard", agg_blocks=1),
         "fast"),
        ("binshard_exact", dict(detect_mode="binshard",
                                detect_impl="exact"), "exact")]),
    4: (worker.TINY, 4, [
        ("replicated", dict(detect_mode="replicated", detect_impl="fast"),
         "fast"),
        ("replicated_agg1", dict(detect_mode="replicated",
                                 detect_impl="fast", agg_blocks=1), "fast"),
        ("binshard", dict(detect_mode="binshard"), "fast"),
        ("binshard_agg1", dict(detect_mode="binshard", agg_blocks=1),
         "fast")]),
}
SPAWN_TIMEOUT_S = 300
_SPAWNED = {}


def strip_id(line: str) -> str:
    return re.sub(r"I:\d{11}", "I:-----------", line)


@functools.lru_cache(maxsize=None)
def capture(n):
    cfg, n_blocks, _ = WORLDS[n]
    return worker.straddle_capture(DetectorConfig(**cfg).derived()
                                   .block_samples, n_blocks)


def spawned(n):
    """Every rank's results of the world's runs, and (rank 0) the binshard
    detect step's gathered tables block by block. One spawn per world
    size: a failed one fails every test that reads it, at once."""
    if n not in _SPAWNED:
        cfg, _, runs = WORLDS[n]
        try:
            _SPAWNED[n] = distributed.spawn(
                worker.decode_runs, n, "cpu", cfg, capture(n),
                [kw for _, kw, _ in runs], "binshard",
                timeout=SPAWN_TIMEOUT_S)
        except RuntimeError as e:
            _SPAWNED[n] = e
    res = _SPAWNED[n]
    if isinstance(res, RuntimeError):
        raise res
    assert [r["rank"] for r in res] == list(range(n))
    return res


def run_of(n, name):
    names = [r for r, _, _ in WORLDS[n][2]]
    return spawned(n)[0]["runs"][names.index(name)]


@functools.lru_cache(maxsize=None)
def single(n, impl):
    """The single card's (lines, stats) on the world's capture."""
    cfg = WORLDS[n][0]
    pipe = Pipeline(det_cfg=DetectorConfig(**cfg), burst_batch=4,
                    start_time_ns=worker.T0, device="cpu", detect_impl=impl)
    printer = RawPrinter(worker.FILE_INFO)
    lines = [printer.format(f) for f in pipe.run_array(capture(n))]
    assert len(lines) >= 3, "the single card missed the synthetic bursts"
    return lines, pipe.stats


def impl_of(n, name):
    return {r: impl for r, _, impl in WORLDS[n][2]}[name]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["replicated", "replicated_agg1"])
def test_replicated_lines_equal_single_card_with_ids(n, name):
    want, _ = single(n, impl_of(n, name))
    assert sorted(run_of(n, name)["lines"]) == sorted(want)


@pytest.mark.parametrize("n,name", [(2, "binshard"), (2, "binshard_agg1"),
                                    (2, "binshard_exact"), (4, "binshard"),
                                    (4, "binshard_agg1")])
def test_binshard_lines_equal_single_card_ids_masked(n, name):
    want, _ = single(n, impl_of(n, name))
    got = run_of(n, name)["lines"]
    assert sorted(map(strip_id, got)) == sorted(map(strip_id, want))
    ids = [line.split("I:")[1][:11] for line in got]
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("n", [2, 4])
def test_stats_equal_single_card(n):
    for name, _, impl in WORLDS[n][2]:
        _, want = single(n, impl)
        st = run_of(n, name)["stats"]
        assert (st["n_detected"], st["n_ok"], st["n_handled"],
                st["n_samples"]) == (want.n_detected, want.n_ok,
                                     want.n_handled, want.n_samples), name


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["replicated", "binshard"])
def test_group_per_agg_blocks(n, mode):
    """One group (one result gather and copy) for the whole capture at
    agg_blocks=4, one a block at agg_blocks=1, with the same lines."""
    n_blocks = WORLDS[n][1]
    grouped, per_block = run_of(n, mode), run_of(n, mode + "_agg1")
    assert grouped["timing"]["n_blocks"] == n_blocks
    assert grouped["timing"]["n_groups"] == 1
    assert per_block["timing"]["n_groups"] == n_blocks
    assert sorted(grouped["lines"]) == sorted(per_block["lines"])


@pytest.mark.parametrize("n", [2, 4])
def test_only_rank_0_emits(n):
    res = spawned(n)
    assert all(r["lines"] for r in res[0]["runs"])
    for other in res[1:]:
        assert all(r["lines"] == [] for r in other["runs"])
        # every rank counted the same gathered heads
        assert [r["stats"] for r in other["runs"]] == \
            [r["stats"] for r in res[0]["runs"]]


@pytest.mark.parametrize("n,k_hops,branch", [(2, 1, "left_ring"),
                                             (4, 8, "left_gather")])
def test_left_part_branch(n, k_hops, branch):
    """Every block's left part came by the branch its k_hops selects: one
    ring shift at 2 ranks, the gathered block at 4."""
    other = {"left_ring": "left_gather", "left_gather": "left_ring"}[branch]
    for run in spawned(n)[0]["runs"]:
        assert run["k_hops"] == k_hops
        assert run["timing"][branch] == WORLDS[n][1]
        assert other not in run["timing"]


def test_binshard_tables_match_jax_sharded_detect():
    """Per block, every rank's gone table against the JAX package's
    binshard detect step on 4 virtual devices (`_dispatch_step` then
    `_fetch_gone`): counts, tagged, ids (rank offset, stride 4), starts,
    stops and bins exact; dB fields rtol 1e-5."""
    n = 4
    cap = capture(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("shards",))
    jsp = JaxSharded(JaxDetConfig(**worker.TINY), mesh=mesh, burst_batch=4,
                     start_time_ns=0, detect_mode="binshard")
    bs = jsp.p.block_samples
    port = spawned(n)[0]["tables"]
    assert len(port) == len(cap) // bs
    n_rows = 0
    for b, got in enumerate(port):
        ctx = jsp._dispatch_step(cap[b * bs:(b + 1) * bs], bs)
        want = jsp._fetch_gone(ctx[2])
        assert got.shape == want.shape
        for r in range(n):
            k = int(want[r, 0, 0])
            assert got[r, 0, :2].tolist() == want[r, 0, :2].tolist(), (b, r)
            g, w = got[r, 1:1 + k], want[r, 1:1 + k]
            assert g[:, :4].tolist() == w[:, :4].tolist(), (b, r)
            assert all(i % 10 == 0 and (i // 10) % n == r for i in g[:, 0])
            np.testing.assert_allclose(
                np.ascontiguousarray(g[:, 4:]).view(np.float32),
                np.ascontiguousarray(w[:, 4:]).view(np.float32), rtol=1e-5)
            n_rows += k
    assert n_rows >= 5


def test_replicated_lines_match_jax_pipeline():
    """The 4-rank replicated lines (port at detect_impl="fast") against the
    JAX single-chip Pipeline's on the same capture, ids included."""
    n = 4
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**worker.TINY), burst_batch=4,
                        start_time_ns=worker.T0)
    printer = JaxRawPrinter(worker.FILE_INFO)
    want = sorted(printer.format(f) for f in jpipe.run_array(capture(n)))
    got = sorted(run_of(n, "replicated")["lines"])
    assert len(got) == len(want) >= 5
    for g, w in zip(got, want):
        gf, wf = g.split(" "), w.split(" ")
        assert abs(int(gf[3]) - int(wf[3])) <= 1, (g, w)
        assert gf[:3] + gf[4:] == wf[:3] + wf[4:], (g, w)


def test_initialize_alone_is_a_group_of_one(monkeypatch):
    """With no launcher environment, initialize() makes a world-size-1
    gloo group for device="cpu"; a second call does nothing."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not distributed.in_group()
    try:
        assert distributed.initialize(device="cpu") is True
        assert distributed.initialize(device="cpu") is False
        mesh = distributed.make_mesh()
        assert (mesh.n, mesh.rank, mesh.device.type) == (1, 0, "cpu")
        assert distributed.is_host0()
        sp = ShardedPipeline(DetectorConfig(**worker.TINY), mesh=mesh,
                             device="cpu")
        assert (sp.n, sp.slice_len) == (1, sp.p.block_samples)
    finally:
        distributed.shutdown()
    assert not distributed.in_group()


def test_sharded_pipeline_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedPipeline(DetectorConfig(**worker.TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize()
    assert not distributed.in_group()


def test_binshard_refuses_the_scan_kernel():
    with pytest.raises(ValueError, match="bin range"):
        ShardedPipeline(DetectorConfig(**worker.TINY), device="cpu",
                        mesh=distributed.Mesh(1, 0, torch.device("cpu"),
                                              None),
                        detect_mode="binshard", detect_impl="scan")


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        distributed.spawn(worker.fail_on_rank, 2, "cpu", 1, timeout=120)


def test_sharded_geometry_is_the_single_cards():
    """At the production 10 MHz configuration the sharded pipeline sizes
    its windows as one card does and runs the JAX package's sharded
    capacities (iridium_tpu/parallel/stream.py:445-460): 256, 48 and 48
    bursts at burst_batch 128 and group_jobs 2."""
    det = DetectorConfig(sample_rate=10_000_000, frames_per_block=2048,
                         gone_capacity=2048)
    one = Pipeline(det_cfg=det, device="cpu")
    sp = ShardedPipeline(det, device="cpu", burst_batch=128,
                         mesh=distributed.Mesh(4, 1, torch.device("cpu"),
                                               None))
    for k in ("l_ext", "l_small", "dec_small", "dec_large",
              "simplex_bin_min", "in_ntaps"):
        assert getattr(sp, k) == getattr(one, k), k
    assert (sp.l_small, sp.l_ext) == (327_680, 1_126_400)
    assert [(c.batch, c.l_win, c.dec_cap, c.max_symbols, c.fused)
            for c in sp.classes] == [
        (b, c.l_win, c.dec_cap, c.max_symbols, c.fused)
        for b, c in zip((256, 48, 48), one.classes)]
    assert [c.batch for c in one.classes] == [1024, 96, 48]
    assert sp.stream_len == det.derived().block_samples // 4 + 2 * sp.l_ext
    assert sp.k_hops == 1
