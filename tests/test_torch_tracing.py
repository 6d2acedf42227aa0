"""The port's tracer (iridium_tpu_torch/runtime/tracing.py) inside
`Pipeline.run_blocks`, on the CPU over a small synthetic capture (2 MHz,
F = 512, 64 frames a block, eight blocks of bursts in groups of two whose
class batches overflow): the keys the JAX package's profile reads keep
their counts with tracing off, the spans appear nested in a
`torch.profiler` trace while it records, and the counters count what the
pipeline did."""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402
from iridium_tpu_torch.runtime import tracing  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

RATE = 2_000_000
TINY = dict(sample_rate=RATE, fft_size=512, history_size=8,
            frames_per_block=64, burst_capacity=64, gone_capacity=64,
            max_new_per_frame=32, max_burst_len=18_000, burst_post_len=4_000)
BLOCKS = 8
T0 = 1_700_000_000_000_000_000
# batches of 4 small-normal bursts against ~6 a group: overflow rounds
OVERFLOW = dict(burst_batch=2, agg_blocks=2, group_jobs=1)
# the counts of the same decode before the tracer (n_detected: 43)
COUNTS = dict(n_blocks=8, n_groups=4, n_overflow_rounds=8)


@pytest.fixture(scope="module")
def capture():
    bs = DetectorConfig(**TINY).derived().block_samples
    cap = synth.noise(BLOCKS * bs, seed=11)
    rng = np.random.default_rng(5)
    for i in range(3, 3 * BLOCKS):
        bits = rng.integers(0, 2, 160).astype(np.uint8)
        x = synth.burst_waveform(bits, RATE,
                                 float(rng.uniform(-700e3, 700e3)))
        start = i * bs // 3 + int(rng.integers(0, 3000))
        if start + len(x) < len(cap):
            synth.add_burst(cap, x, start, snr_db=30.0)
    return cap


def pipeline(**kw):
    return Pipeline(det_cfg=DetectorConfig(**TINY), start_time_ns=T0,
                    device="cpu", **{**OVERFLOW, **kw})


def run(pipe, cap, depth=3, consume=None):
    out = []
    for frames in pipe.run_blocks(pipe._array_blocks(cap), depth=depth):
        if consume is not None:
            consume(frames)
        out.append(frames)
    return out


@pytest.fixture(scope="module")
def untraced(capture):
    pipe = pipeline()
    names = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)
    torch.profiler.record_function = spy
    try:
        run(pipe, capture)
    finally:
        torch.profiler.record_function = real
    return pipe, names


def test_tracing_off_makes_no_annotation_and_keeps_the_counts(untraced):
    pipe, names = untraced
    assert pipe.tracer.on is False
    assert not [n for n in names if n.startswith(tracing.PREFIX)]
    t = pipe.timing
    assert {k: t[k] for k in COUNTS} == COUNTS
    assert pipe.stats.n_detected == 43
    assert not [k for k, kind in pipe.tracer.kinds.items()
                if kind == tracing.DEVICE]
    assert not [k for k in t if k.endswith("_dev")]
    # a child span's time is inside its parent's key
    assert 0 < t["counts_wait"] <= t["group_dispatch"]
    assert 0 < t["host_format"] <= t["host_parse"]
    assert t["result_fetch_wait"] + t["host_parse"] <= t["finish"]


def test_upload_bytes_counts_every_block(untraced):
    pipe, _ = untraced
    assert pipe.timing["upload_bytes"] == 8 * pipe.p.block_samples * BLOCKS


def test_rows_live_are_the_detected_bursts(untraced):
    pipe, _ = untraced
    t = pipe.timing
    assert t["rows_live"] == pipe.stats.n_detected
    assert t["rows_run"] >= t["rows_live"] > 0


def test_profiler_trace_holds_the_nested_spans(capture, tmp_path):
    pipe = pipeline()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run(pipe, capture)
    assert pipe.tracer.on is True
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("iridium."):
            spans.setdefault(e["name"][len("iridium."):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    t = pipe.timing
    rounds = t["n_groups"] + t["n_overflow_rounds"]
    assert {k: t[k] for k in COUNTS} == COUNTS
    assert len(spans["step_dispatch"]) == t["n_blocks"]
    assert len(spans["group_dispatch"]) == rounds
    assert len(spans["counts_wait"]) == rounds
    assert len(spans["finish"]) == t["n_groups"]
    assert len(spans["consumer"]) == t["n_blocks"]
    for a, b in spans["counts_wait"]:
        assert any(a0 <= a and b <= b0 for a0, b0 in spans["group_dispatch"])
    # the overflow rounds' dispatch inside the finish
    inside = [s for s in spans["group_dispatch"]
              if any(a0 <= s[0] and s[1] <= b0 for a0, b0 in spans["finish"])]
    assert len(inside) == t["n_overflow_rounds"]


def test_sleeping_consumer_and_the_queue(capture):
    pipe = pipeline()
    run(pipe, capture, depth=1, consume=lambda frames: time.sleep(0.005))
    t = pipe.timing
    assert t["consumer"] >= 0.005 * BLOCKS
    assert t["queue_wait"] > 0


def test_top_level_spans_cover_the_loop(capture):
    # batches large enough for every group: each group_dispatch is a first
    # round, outside the finish
    pipe = pipeline(burst_batch=64, group_jobs=4)
    t0 = time.perf_counter()
    run(pipe, capture)
    wall = time.perf_counter() - t0
    t = pipe.timing
    assert t["n_overflow_rounds"] == 0
    covered = sum(t[k] for k in ("read", "step_dispatch", "group_dispatch",
                                 "finish", "consumer"))
    assert covered >= 0.95 * wall, (covered, wall)
