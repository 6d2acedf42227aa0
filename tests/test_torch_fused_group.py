"""The port's group flow (iridium_tpu_torch/runtime/pipeline.py: the group
program with routing on the device) against its host-routed flow, the
oracle, and against the JAX package's Pipeline, at tests/test_fused_group.py's
tiny configuration (2 MHz, F = 512, 64 frames a block, 4 blocks, six
placed bursts), on the CPU.

The two flows of the port must give the same RAW lines exactly; against
the JAX package the lines agree field for field with the frequency within
1 Hz (it is rebuilt from float fields whose last bits differ between the
two packages' FFTs) and the bits exactly. The routing function is held
to the JAX package's `_route_group` on random gone tables: equal params,
meta and table rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

from test_fused_group import multi_burst_capture  # noqa: E402
from test_torch_pipeline import check_lines  # noqa: E402

T0 = 1_700_000_000_000_000_000
TINY = dict(sample_rate=2_000_000, fft_size=512, history_size=8,
            frames_per_block=64, burst_capacity=64, gone_capacity=64,
            max_new_per_frame=32, max_burst_len=18_000, burst_post_len=4_000)


@pytest.fixture(scope="module")
def capture():
    return multi_burst_capture()


def decode(cap, host_routed=False, **kw):
    pipe = Pipeline(det_cfg=DetectorConfig(**TINY), start_time_ns=T0,
                    device="cpu", **kw)
    pipe.host_routed = host_routed
    return pipe, list(pipe.run_array(cap))


def lines(frames):
    pr = RawPrinter("t")
    return [pr.format(f) for f in frames]


@pytest.mark.parametrize("agg", [1, 4])
def test_device_routing_matches_host_routing(capture, agg):
    kw = dict(burst_batch=4, agg_blocks=agg, group_jobs=2)
    pipe, dev = decode(capture, **kw)
    host_pipe, host = decode(capture, host_routed=True, **kw)
    assert len(dev) >= 5
    assert lines(dev) == lines(host)
    assert pipe.timing["n_groups"] == host_pipe.timing["n_groups"] \
        == 4 // agg
    assert pipe.stats == host_pipe.stats


def test_overflow_rounds_match_host_routing(capture):
    """Class batches far below the group's bursts: the group program takes
    skip rounds, counts each burst once, and matches the oracle."""
    kw = dict(burst_batch=2, agg_blocks=4, group_jobs=1)
    pipe, dev = decode(capture, **kw)
    assert pipe.timing["n_overflow_rounds"] >= 1
    host_pipe, host = decode(capture, host_routed=True, **kw)
    assert len(dev) >= 5
    assert lines(dev) == lines(host)
    for k in ("n_detected", "n_ok", "n_handled"):
        assert getattr(pipe.stats, k) == getattr(host_pipe.stats, k), k


def test_both_flows_match_jax_pipeline(capture):
    """One creation a frame: on the CPU the JAX Pipeline runs detect_fast,
    which places same-frame secondary creations otherwise than the greedy
    scan the port follows (ROADMAP.md, "Faults in the port against the
    reference"), and so gives other burst ids."""
    cfg = dict(TINY, max_new_per_frame=1)
    kw = dict(burst_batch=4, agg_blocks=4, group_jobs=2)
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**cfg), start_time_ns=T0,
                        **kw)
    jframes = list(jpipe.run_array(capture))
    want = [JaxRawPrinter("t").format(f) for f in jframes]
    assert len(want) >= 5
    for host_routed in (False, True):
        pipe = Pipeline(det_cfg=DetectorConfig(**cfg), start_time_ns=T0,
                        device="cpu", **kw)
        pipe.host_routed = host_routed
        frames = list(pipe.run_array(capture))
        check_lines(lines(frames), want)
        for f, jf in zip(frames, jframes):
            np.testing.assert_array_equal(f["bits"], jf["bits"])
        assert pipe.stats.n_detected == jpipe.stats.n_detected
        assert pipe.stats.n_ok == jpipe.stats.n_ok


# 10 MHz with small blocks: the small window is shorter than the full
# one, so all three classes are reachable
ROUTE = dict(sample_rate=10_000_000, frames_per_block=64, gone_capacity=64,
             burst_capacity=64, max_new_per_frame=8)


def random_tables(p, nb, seed):
    """Gone tables (nb, G + 1, 6): starts near 0 (some before the block)
    and near the block's end, lengths past l_ext - ALIGN, bins across the
    whole band (simplex_bin_min included)."""
    rng = np.random.default_rng(seed)
    G, bs, F = p.gone_capacity, p.block_samples, p.fft_size
    tabs = np.zeros((nb, G + 1, 6), np.int32)
    for bi in range(nb):
        n = int(rng.integers(G // 2, G + 1))
        start = np.where(rng.random(n) < 0.5,
                         rng.integers(-p.burst_pre_len, 40_000, n),
                         rng.integers(bs - 60_000, bs, n))
        length = np.where(rng.random(n) < 0.2,
                          rng.integers(1_000_000, 1_300_000, n),
                          rng.integers(20_000, 300_000, n))
        tabs[bi, 0, :4] = [n, n + 3, 0, 0]
        rows = tabs[bi, 1:1 + n]
        rows[:, 0] = 10 * (np.arange(n) + 100 * bi)
        rows[:, 1] = start
        rows[:, 2] = start + length
        rows[:, 3] = rng.integers(0, F, n)
        rows[:, 4] = rng.standard_normal(n).astype(np.float32).view(np.int32)
        rows[:, 5] = rng.standard_normal(n).astype(np.float32).view(np.int32)
    return tabs


@pytest.mark.parametrize("base0,skips", [(0, (0, 0, 0)),
                                         (2 * 64 * 8192, (3, 5, 1))])
def test_route_matches_jax_route_group(base0, skips):
    kw = dict(burst_batch=4, group_jobs=2)
    pipe = Pipeline(det_cfg=DetectorConfig(**ROUTE), device="cpu", **kw)
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**ROUTE), **kw)
    p, nb = pipe.p, 3
    assert pipe.l_small < pipe.l_ext
    tabs = random_tables(p, nb, seed=base0 + sum(skips))
    bases = [base0 + bi * p.block_samples for bi in range(nb)]
    ncs, routed = pipe.route(torch.from_numpy(tabs),
                             torch.tensor(-base0),
                             torch.tensor(skips, dtype=torch.int64))

    blocks_g = []
    for bi in range(nb):
        rows = tabs[bi, 1:1 + tabs[bi, 0, 0]]
        blocks_g.append((bi, dict(start=rows[:, 1], stop=rows[:, 2],
                                  bin=rows[:, 3]), bases[bi]))
    g = JaxPipeline._route_group(jpipe, blocks_g)
    small = g["small"]
    sim = g["bin"][small] >= jpipe.simplex_bin_min
    assert pipe.simplex_bin_min == jpipe.simplex_bin_min
    members = (small[~sim], small[sim], g["large"])
    assert all(len(m) > 0 for m in members)
    flat = g["blk"] * p.gone_capacity + g["gi"]
    assert ncs.tolist() == [len(m) for m in members]
    for cls, idx, skip, (meta, tw, params) in zip(pipe.classes, members,
                                                   skips, routed):
        win = idx[skip:skip + cls.batch]
        n = len(win)
        assert meta[:n].tolist() == flat[win].tolist()
        assert (meta[n:] == -1).all()
        want = np.stack([g[k][win] for k in ("tile", "r", "ext_len", "bin",
                                              "shift_dec")])
        np.testing.assert_array_equal(params[:, :n].numpy(), want)
        assert not params[:, n:].any()
        np.testing.assert_array_equal(
            tw[:, :n].numpy(), tabs[g["blk"][win], 1 + g["gi"][win]].T)
        assert not tw[:, n:].any()


def test_run_blocks_depth_and_q_peak(capture):
    p = DetectorConfig(**TINY).derived()
    bs = p.block_samples
    blocks = [(capture[i:i + bs], bs) for i in range(0, len(capture), bs)]
    got = {}
    for depth in (1, 3):
        pipe = Pipeline(det_cfg=DetectorConfig(**TINY), start_time_ns=T0,
                        device="cpu", burst_batch=4, agg_blocks=1,
                        group_jobs=2)
        got[depth] = [lines(f) for f in pipe.run_blocks(blocks, depth)]
        assert pipe.take_q_peak() == depth + 1
        assert pipe.take_q_peak() == 0
    assert len(got[1]) == len(blocks)
    assert sum(map(len, got[1])) >= 5
    assert got[1] == got[3]
