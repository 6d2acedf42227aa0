"""The trace's reduction (interval union, attribution, idle gaps), the
latency percentile and the roofline arithmetic, on synthetic input."""

import types

import numpy as np
import pytest

import roofline
import devtrace
from metrics import (class_ms_per_kburst, detect_ms_per_block, idle_pct,
                     line_latency_p50_ms, scan_roofline, upload_gbps)


def ev(cat, name, ts, dur, corr=None, **args):
    a = dict(args)
    if corr is not None:
        a["correlation"] = corr
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=a)


def synthetic():
    return devtrace.parse([
        ev("user_annotation", "bench.window", 0, 1000),
        ev("user_annotation", "bench.step", 10, 20),
        ev("cuda_runtime", "cudaMemcpyAsync", 11, 1, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 2),
        ev("user_annotation", "bench.finish", 100, 300),
        ev("user_annotation", "bench.group", 110, 20),
        ev("cuda_runtime", "cudaGraphLaunch", 115, 1, 3),
        ev("cuda_runtime", "cudaMemcpyAsync", 125, 1, 4),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 12, 40, 1,
           bytes=4_000_000),
        ev("kernel", "void detect_scan_kernel<1, 1>(State, Params)", 52, 100,
           2),
        ev("kernel", "fused_frontend_kernel", 150, 50, 3),
        ev("kernel", "other", 190, 30, 3),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 400, 10, 4),
        ev("kernel", "outside", 2000, 10, None),
    ])


def test_union_busy_idle_and_gaps():
    t = synthetic()
    assert t.busy_intervals() == [(12.0, 220.0), (400.0, 410.0)]
    assert t.busy_s() == pytest.approx(218e-6)
    assert t.window_s() == pytest.approx(1e-3)
    gaps = t.idle_gaps()
    assert gaps[0] == ["run_blocks", pytest.approx(590e-6)]
    assert gaps[1] == ["bench.finish", pytest.approx(180e-6)]
    spans = {o.name: o.span for o in t.ops}
    assert spans["fused_frontend_kernel"] == "bench.group"
    assert spans["Memcpy DtoH (Device -> Pinned)"] == "bench.group"
    assert spans["Memcpy HtoD (Pinned -> Device)"] == "bench.step"
    assert "outside" not in spans


def ctx(**kw):
    base = dict(trace=synthetic(), timing={}, blocks=2, detected=500,
                groups=1, lat_ms=np.array([1.0, 2.0, 3.0, 10.0]),
                block_bytes=2_000_000, frontend=[],
                p=types.SimpleNamespace(fft_size=8192, history_size=512,
                                        frames_per_block=2048))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_layer_metrics():
    c = ctx()
    assert upload_gbps.read(c) == pytest.approx(4e6 / 40e-6 / 1e9)
    assert detect_ms_per_block.read(c) == pytest.approx(0.1 / 2)
    # the group program without its result copy, per 1,000 detections
    assert class_ms_per_kburst.read(c) == pytest.approx(0.08 / 0.5)
    assert idle_pct.read(c) == pytest.approx(100 * (1 - 0.218))
    assert line_latency_p50_ms.read(c) == pytest.approx(2.5)
    b = roofline.scan_bound_s(8192, 512, 2048)
    assert scan_roofline.read(c) == pytest.approx(100 * b / 100e-6)
    none = ctx(trace=None)
    assert upload_gbps.read(none) is None
    assert idle_pct.read(none) is None


def test_roofline_counts():
    # the scan: rows once, history and nine planes read and written once
    n = roofline.scan_bytes(8192, 512, 2048)
    assert n == 4 * 8192 * 2048 + 2 * 4 * (512 * 8192 + 9 * 8192)
    assert roofline.scan_bound_s(8192, 512, 2048) == pytest.approx(
        n / 3.35e12)
    # overlapping windows count their samples once, clipped to the stream
    assert roofline.covered_samples([0, 5, 100], 10, 105) == 20
    t, by = roofline.frontend_bound_s([0, 5], 2, 400, 40, 41, 1000)
    n_out, span = 10, 9 * 40 + 41
    want_b = (8 * (span + 5) + 8 * 2 * n_out + 4 * 41) / 3.35e12
    want_o = 3 * 2 * 2.0 * 41 * 2 * n_out / 495e12
    assert t == pytest.approx(max(want_b, want_o))
    assert by == ("bytes" if want_b >= want_o else "operations")


def test_latency_percentile_weights_lines():
    # a block's latency counts once for each of its lines
    lat = np.repeat(np.array([10.0, 20.0, 30.0]), [1, 1, 98])
    assert float(np.percentile(lat, 95)) == 30.0
