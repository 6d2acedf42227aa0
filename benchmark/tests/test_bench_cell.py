"""One cell end to end at a tiny size on the CPU (the program's plain
versions, so no device metric), the check's control, and the check
refusing a run whose timed path is broken underneath."""

import time

import numpy as np
import pytest
import torch

import compare
import harness
import traffic

CONFIG = dict(sample_rate=1_000_000, frames_per_block=1024,
              gone_capacity=1024, burst_batch=16, agg_blocks=2, group_jobs=1,
              want_llr=False, use_gardner=True, detect_impl="auto")
DEVICE_METRICS = {"upload_gbps", "detect_ms_per_block", "scan_roofline",
                  "class_ms_per_kburst", "frontend_roofline", "idle_pct"}
SEED = 2**31 + 5


def tiny_cell(limits=None):
    mix = dict(traffic.load("mix_live"), burst_rate=20.0, pool_blocks=4,
               offset_hz=400_000.0)
    names = sorted(DEVICE_METRICS | {"host_ms_per_block",
                                     "result_wait_ms_per_group",
                                     "line_latency_p50_ms"})
    return harness.Cell("tiny", CONFIG, mix, names,
                        limits or compare.load_limits("raw10_mix"))


def run(traced=False, control=False, seconds=1.0):
    return harness.run_cell(tiny_cell(), SEED, seconds, traced, "cpu",
                            time.perf_counter(), control=control,
                            log=lambda *a: None)


def test_cell_end_to_end_on_the_cpu():
    res = run(traced=True, control=True)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"]
    assert not DEVICE_METRICS & set(res["metrics"])
    assert {"host_ms_per_block", "line_latency_p50_ms"} <= set(
        res["metrics"])
    assert list(res)[-1] == "checks"
    assert res["checks"]["detect_diff"]["value"] == 0
    # each control (the reference's FIR in TF32, its detector on bfloat16
    # rows) fails the cell's limits
    lim = compare.load_limits("raw10_mix")
    for ctl in res["control"].values():
        assert any(ctl[k] > lim[k] for k in compare.NUMBERS)
    res0 = run()
    assert set(res0["metrics"]) == {"realtime_x", "line_latency_p95_ms",
                                    "setup_s"}


def test_stalled_detect_step_is_refused(monkeypatch):
    from iridium_tpu_torch.dsp import detect_scan
    monkeypatch.setattr(detect_scan, "detect_block",
                        lambda x, st, n, p, w: st)
    res = run()
    assert res["correct"] is False


def test_half_of_each_batch_left_out_is_refused(monkeypatch):
    from iridium_tpu_torch.runtime import pipeline
    inner = pipeline.BurstClass.run

    def half(self, planes, params):
        rows = inner(self, planes, params)
        rows[1::2] = 0          # every other burst of the batch left out
        return rows
    monkeypatch.setattr(pipeline.BurstClass, "run", half)
    assert run()["correct"] is False


def test_altered_answers_are_refused(monkeypatch):
    from iridium_tpu_torch.runtime import pipeline
    inner = pipeline.build_frames_np

    def flipped(*a, **kw):
        frames = inner(*a, **kw)
        for f in frames:
            f["bits"] = np.array(f["bits"]).copy()
            f["bits"][-1] ^= 1
        return frames
    monkeypatch.setattr(pipeline, "build_frames_np", flipped)
    assert run()["correct"] is False


def test_round_tf32():
    from reference import frontend
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.5e-3],
                     dtype=torch.float32)
    r = frontend.round_tf32(x)
    assert r[0] == 1.0
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2**-11)
