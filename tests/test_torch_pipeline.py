"""The port's offline decode as a whole (iridium_tpu_torch, device="cpu")
against the JAX package's Pipeline on the same captures, at
test_e2e.py's configurations.

The payload bits must come back exactly, and the RAW lines must equal the
JAX package's field for field, except the frequency, which may differ by
1 Hz (it is rebuilt from float fields whose last bits differ between the
two packages' FFTs). The frames' unpacked LLRs (both pipelines carry
them by default) agree within one u16 quantum (the burst's max LLR /
65535) plus 1e-4 of that max: the f32 LLRs differ in their last bits. The bursts are isolated, so the JAX CPU scan's
documented secondary-creation divergence from the greedy-argmax scan
cannot arise.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu.runtime.pipeline import Pipeline as JaxPipeline  # noqa: E402
from iridium_tpu_torch import cli  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402
from iridium_tpu_torch.output.raw import RawPrinter  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

T0 = 1_700_000_000_000_000_000
SINGLE = dict(sample_rate=10_000_000, frames_per_block=512,
              burst_capacity=64, gone_capacity=128, max_new_per_frame=8)


def payload_bits(n_bits, seed):
    return np.random.default_rng(seed).integers(0, 2, n_bits).astype(
        np.uint8)


def raw_lines(frames, printer):
    return [printer.format(f) for f in frames]


def check_lines(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        gf, wf = g.split(" "), w.split(" ")
        assert len(gf) == len(wf)
        assert abs(int(gf[3]) - int(wf[3])) <= 1, (g, w)
        assert gf[:3] + gf[4:] == wf[:3] + wf[4:], (g, w)


def decode_both(cfg, cap):
    jpipe = JaxPipeline(det_cfg=JaxDetConfig(**cfg), burst_batch=4,
                        start_time_ns=T0)
    jframes = list(jpipe.run_array(cap))
    want = raw_lines(jframes, JaxRawPrinter())
    pipe = Pipeline(det_cfg=DetectorConfig(**cfg), burst_batch=4,
                    start_time_ns=T0, device="cpu")
    frames = list(pipe.run_array(cap))
    check_lines(raw_lines(frames, RawPrinter()), want)
    for f, jf in zip(frames, jframes):
        np.testing.assert_array_equal(f["bits"], jf["bits"])
        top = float(jf["llr"].max())
        assert top > 0
        np.testing.assert_allclose(f["llr"], jf["llr"], rtol=0,
                                   atol=top / 65535 + 1e-4 * top)
    assert pipe.stats.n_detected == jpipe.stats.n_detected
    assert pipe.stats.n_ok == jpipe.stats.n_ok
    # the diagnostic noise floor reads the detector's baseline sums
    assert abs(pipe.noise_floor_db() - jpipe.noise_floor_db()) < 1e-3
    return frames


def test_single_dl_burst_matches_jax():
    bits = payload_bits(300, seed=7)
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=137_000.0, snr_db=30.0)
    frames = decode_both(SINGLE, cap)
    expected = synth.expected_bits(bits, "DL")
    np.testing.assert_array_equal(
        np.asarray(frames[0]["bits"])[:len(expected)], expected)
    assert frames[0]["direction"] == "DL"
    assert abs(frames[0]["frequency"] - 1_622_137_000) < 200.0
    # without LLRs (the RAW path): the same frames, LLRs left at zero
    raw = list(Pipeline(det_cfg=DetectorConfig(**SINGLE), burst_batch=4,
                        start_time_ns=T0, device="cpu",
                        want_llr=False).run_array(cap))
    assert raw_lines(raw, RawPrinter()) == raw_lines(frames, RawPrinter())
    assert not any(f["llr"].any() for f in raw)


def test_cli_prints_pipeline_lines(tmp_path, capsys):
    bits = payload_bits(300, seed=7)
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=137_000.0, snr_db=30.0)
    path = tmp_path / "cap.cf32"
    np.ascontiguousarray(cap).view(np.float32).tofile(path)
    assert cli.main(["-f", str(path), "--device", "cpu",
                     "--burst-batch", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    pipe = Pipeline(det_cfg=DetectorConfig(sample_rate=10_000_000,
                                           frames_per_block=512),
                    burst_batch=4, device="cpu")
    want = raw_lines(pipe.run_file(str(path)), RawPrinter())
    assert len(out) == len(want) >= 1
    # same fields from the frequency on (the start time is the wall clock)
    assert [line.split(" ")[3:] for line in out] == \
        [line.split(" ")[3:] for line in want]
    exp = "".join(map(str, synth.expected_bits(bits, "DL")))
    assert any(exp in line for line in out)


def test_pipeline_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline()


def test_package_imports_no_jax(tmp_path):
    """Every module of the port (detect_fast, detect, the native reader and
    the sharded pipeline among them), and the CLI run with every decoder flag (sockets on
    localhost, pyzmq hidden as on the card's machine), import nothing of
    JAX; the CLI reads the file through the port's own native library,
    not the JAX package's libhostio.so."""
    path = tmp_path / "noise.cf32"
    synth.noise(600_000, seed=1).view(np.float32).tofile(path)
    flags = ["-f", str(path), "--device", "cpu", "--parsed", "--diagnostic",
             "--gsmtap", "127.0.0.1:4729", "--zmq", "--web", "0",
             "--position", "100", "--acars", "--acars-json",
             "--acars-udp", "127.0.0.1:5555", "--feed",
             "udp://127.0.0.1:5590", "--station", "TEST"]
    code = (
        "import importlib, pkgutil, sys\n"
        "import iridium_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'iridium_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.modules['zmq'] = None\n"
        "from iridium_tpu_torch import cli\n"
        f"assert cli.main({flags!r}) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'iridium_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('dsp.detect_fast', 'dsp.detect', 'io.native',\n"
        "          'parallel.stream', 'parallel.distributed',\n"
        "          'tools.exp_mesh', 'tools.captures', 'tools.exp_demod',\n"
        "          'tools.exp_downmix'):\n"
        "    assert 'iridium_tpu_torch.' + m in sys.modules, m\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libhostio-' in maps and '_native/libhostio' not in maps\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('iridium_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "pyzmq not available" in res.stderr
    assert int(res.stdout.splitlines()[-1]) >= 30
