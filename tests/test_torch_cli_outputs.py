"""The port's extra outputs on the CPU: `--save-bursts` (the per-batch
flow's per-burst dumps) against the JAX package's Pipeline on the same
capture, `--profile`, `--agg-blocks`, and the stats line's fields against
the JAX CLI's.

Burst dumps: the same file names, the same `.meta` lines except
magnitude_db, noise_dbfs_hz and uw_start_offset, which agree within 0.01
(they print f32 values whose last bits differ between the two packages),
and `.cf32` samples within 1e-4 of the burst's max |x| (the decimating
FIR sums 801 products in another order in each package).
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch import cli  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

from test_fused_group import multi_burst_capture  # noqa: E402
from test_torch_fused_group import T0, TINY  # noqa: E402

META_FLOATS = ("magnitude_db", "noise_dbfs_hz", "uw_start_offset")
FLOAT_TOL = 0.01
SAMPLE_TOL = 1e-4          # of the burst's max |x|


def read_meta(path):
    with open(path) as f:
        return dict(line.rstrip("\n").split(": ", 1) for line in f)


def test_save_bursts_match_jax(tmp_path):
    # one creation a frame, so that the JAX package's CPU scan gives the
    # same burst ids (test_torch_fused_group.py)
    cfg = dict(TINY, max_new_per_frame=1)
    cap = multi_burst_capture()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**cfg), burst_batch=4,
                        start_time_ns=T0, save_bursts_dir=str(jdir))
    jframes = list(jpipe.run_array(cap))
    pipe = Pipeline(det_cfg=DetectorConfig(**cfg), burst_batch=4,
                    start_time_ns=T0, device="cpu",
                    save_bursts_dir=str(pdir))
    frames = list(pipe.run_array(cap))
    assert [f["id"] for f in frames] == [f["id"] for f in jframes]
    assert pipe.timing["n_burst_batches"] >= 1
    names = sorted(os.listdir(jdir))
    assert len(names) >= 10
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        if name.endswith(".meta"):
            got, want = read_meta(pdir / name), read_meta(jdir / name)
            assert got.keys() == want.keys()
            for k in want:
                if k in META_FLOATS:
                    assert abs(float(got[k]) - float(want[k])) <= FLOAT_TOL
                else:
                    assert got[k] == want[k], (name, k)
        else:
            got = np.fromfile(pdir / name, np.complex64)
            want = np.fromfile(jdir / name, np.complex64)
            assert got.shape == want.shape and len(want) > 0
            top = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=SAMPLE_TOL * top)


@pytest.fixture(scope="module")
def capture_file(tmp_path_factory):
    bits = np.random.default_rng(7).integers(0, 2, 300).astype(np.uint8)
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=137_000.0, snr_db=30.0)
    path = tmp_path_factory.mktemp("cap") / "cap.cf32"
    np.ascontiguousarray(cap).view(np.float32).tofile(path)
    return str(path), "".join(map(str, synth.expected_bits(bits, "DL")))


ARGS = ["--device", "cpu", "--burst-batch", "4", "--frames-per-block", "64"]


def test_profile_writes_trace_and_stage_lines(capture_file, tmp_path,
                                              capsys):
    path, exp = capture_file
    out = tmp_path / "prof"
    assert cli.main(["-f", path, "--profile", str(out)] + ARGS) == 0
    cap = capsys.readouterr()
    assert any(exp in line for line in cap.out.splitlines())
    assert (out / "trace.json").stat().st_size > 0
    prof = [x for x in cap.err.splitlines() if x.startswith("profile:")]
    for key in ("read", "step_dispatch", "group_dispatch",
                "result_fetch_wait", "host_parse", "host_format"):
        assert any(x.split()[1] == key for x in prof), key
    assert any("blocks=" in x and "groups=" in x
               and "overflow_rounds=" in x for x in prof)


def test_agg_blocks_print_the_same_lines(capture_file, capsys):
    path, exp = capture_file
    out = {}
    for agg in (1, 4):
        assert cli.main(["-f", path, "--agg-blocks", str(agg)] + ARGS) == 0
        out[agg] = capsys.readouterr().out.splitlines()
    assert any(exp in line for line in out[1])
    # the same fields from the frequency on (the start time is the clock)
    assert [x.split(" ")[3:] for x in out[1]] == \
        [x.split(" ")[3:] for x in out[4]]


def stats_fields(err: str) -> list[str]:
    """Field names of the stats lines on stderr ("<t> | srr: ... | d: n")."""
    lines = [x for x in err.splitlines() if x.count(" | ") >= 5]
    assert lines, err
    return [[f.split(":")[0] for f in x.split(" | ")[1:]] for x in lines]


def test_stats_line_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Both CLIs on one 1 MHz capture with the clock stepping 2 s a read,
    so that every frame prints a stats line: the same field names in the
    same order (the values depend on the wall clock)."""
    from iridium_tpu import cli as jax_cli
    bits = np.random.default_rng(5).integers(0, 2, 300).astype(np.uint8)
    cap = synth.make_capture(bits, sample_rate=1_000_000,
                             freq_offset_hz=100_000.0, snr_db=30.0)
    path = tmp_path / "cap.cf32"
    np.ascontiguousarray(cap).view(np.float32).tofile(path)
    argv = ["-f", str(path), "-r", "1000000", "--frames-per-block", "256",
            "--burst-batch", "4"]
    clock = iter(range(1_700_000_000, 1_800_000_000, 2))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    fields = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        out = capsys.readouterr()
        assert any(x.startswith("RAW:") for x in out.out.splitlines())
        fields[name] = stats_fields(out.err)
    assert fields["port"] == fields["jax"]
    assert fields["port"][0] == ["srr", "i_avg", "q_max", "i_ok", "o", "ok",
                                 "ok", "ok_avg", "ok", "ok_avg", "d"]
