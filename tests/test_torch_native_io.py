"""The port's native host ingest (iridium_tpu_torch/io/native.py and
csrc/hostio.cpp, built with g++ at first use) against the Python readers:
the blocks of test_native_io.py's files bit for bit, and a multi-block
decode through `Pipeline.run_file` against the same decode fed by
`readers.read_blocks`. A failed build raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.io import native, readers  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

from test_fused_group import multi_burst_capture  # noqa: E402
from test_torch_fused_group import T0, TINY  # noqa: E402


def blocks_of(it):
    # each block is copied before the next is asked for: the reader
    # refills its buffers
    return [(np.array(b), n) for b, n in it]


@pytest.mark.parametrize("fmt,dtype,scale", [
    ("ci8", np.int8, 127), ("ci16", np.int16, 32767),
    ("cf32", np.float32, 1.0)])
def test_native_matches_python(tmp_path, fmt, dtype, scale):
    rng = np.random.default_rng(1)
    raw = (rng.uniform(-1, 1, 2 * 50_000) * scale).astype(dtype)
    path = str(tmp_path / f"x.{fmt}")
    raw.tofile(path)
    got = blocks_of(native.read_blocks(path, 16_384, fmt))
    want = blocks_of(readers.read_blocks(path, 16_384, fmt))
    assert [n for _, n in got] == [n for _, n in want] == \
        [16_384, 16_384, 16_384, 848]
    for (x, _), (y, _) in zip(got, want):
        assert x.dtype == np.complex64 and x.shape == (16_384,)
        np.testing.assert_array_equal(x, y)


def test_native_empty_file(tmp_path):
    path = str(tmp_path / "empty.cf32")
    open(path, "wb").close()
    assert list(native.read_blocks(path, 4096, "cf32")) == []


def test_native_exact_multiple(tmp_path):
    raw = np.random.default_rng(2).standard_normal(2 * 8192).astype(
        np.float32)
    path = str(tmp_path / "x.cf32")
    raw.tofile(path)
    got = blocks_of(native.read_blocks(path, 4096, "cf32"))
    assert [n for _, n in got] == [4096, 4096]
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in got]), raw.view(np.complex64))


def test_failed_build_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "x.cf32")
    np.zeros(64, np.float32).tofile(path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-g"):
        list(native.read_blocks(path, 16, "cf32"))


def test_run_file_matches_python_reader(tmp_path):
    """Six blocks and a partial seventh in groups of four, both groups in
    flight (depth 3): the native reader's ring of three buffers is reused
    while blocks are in flight, and the lines equal the Python reader's."""
    p = DetectorConfig(**TINY).derived()
    four = multi_burst_capture()
    bs = p.block_samples
    cap = np.concatenate([four, four[:2 * bs], four[:bs // 3]])
    path = tmp_path / "cap.cf32"
    cap.view(np.float32).tofile(path)
    out = {}
    for reader in ("native", "python"):
        pipe = Pipeline(det_cfg=DetectorConfig(**TINY), start_time_ns=T0,
                        device="cpu", burst_batch=4, agg_blocks=4,
                        group_jobs=2)
        if reader == "native":
            frames = list(pipe.run_file(str(path)))
        else:
            frames = [f for fr in pipe.run_blocks(
                readers.read_blocks(str(path), p.block_samples), depth=3)
                for f in fr]
        out[reader] = [RawPrinter("t").format(f) for f in frames]
        assert pipe.timing["n_blocks"] == 7 and pipe.timing["read"] > 0
    assert len(out["native"]) >= 6
    assert out["native"] == out["python"]
