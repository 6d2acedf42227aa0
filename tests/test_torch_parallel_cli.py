"""The port's CLI with `--mesh` on the CPU: `--mesh 2 --device cpu` starts
two gloo ranks (`distributed.spawn`) that decode through the sharded
pipeline (replicated detect, as the JAX CLI runs it) and print, from rank 0,
the lines the plain CLI prints on the same capture: the RAW lines from the
frequency on, burst ids included (the first fields hold the wall-clock
start), the shutdown summary, and the stats line's fields (its values are
rates over the wall clock, and it prints once a second); the same lines
from stdin (`-f -`), which rank 0 reads and broadcasts. Also the errors
of `--mesh`."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch import cli  # noqa: E402

from iridium_tpu_torch.io import synth  # noqa: E402

# 1 MHz, blocks of 256 frames of 1,024 bins (262,144 samples); the
# detector primes over its 512-frame history (2 blocks)
ARGS = ["-r", "1000000", "--frames-per-block", "256", "--burst-batch", "4",
        "--device", "cpu"]
BLOCK = 256 * 1024
ROOT = Path(__file__).resolve().parent.parent


def capture() -> np.ndarray:
    """Four blocks of noise with three DL bursts after the priming, one
    across the boundary of blocks 2 and 3."""
    rng = np.random.default_rng(11)
    cap = synth.noise(4 * BLOCK, seed=11)
    for start, off in ((560_000, 100_000.0), (3 * BLOCK - 5_000, -150_000.0),
                       (900_000, 210_000.0)):
        bits = rng.integers(0, 2, 308).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, 1_000_000, off),
                        start, snr_db=30.0)
    return cap


def ranks() -> set:
    """Processes started by multiprocessing's spawn whose parent is this
    one (from /proc). Its resource tracker, which lives as long as this
    process, is not one of them."""
    me, kids = os.getpid(), set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me \
                and b"spawn_main" in cmd:
            kids.add(int(pid))
    return kids


def stats_fields(err: str) -> list:
    return [[f.split(":")[0] for f in x.split(" | ")[1:]]
            for x in err.splitlines() if x.count(" | ") >= 5]


def test_mesh_cli_prints_the_plain_cli_lines(tmp_path, capfd):
    path = tmp_path / "cap.cf32"
    np.ascontiguousarray(capture()).view(np.float32).tofile(path)
    assert cli.main(["-f", str(path)] + ARGS) == 0
    plain = capfd.readouterr()
    dump = tmp_path / "bursts"
    assert cli.main(["-f", str(path), "--mesh", "2", "--save-bursts",
                     str(dump)] + ARGS) == 0
    mesh = capfd.readouterr()
    assert not ranks(), "a rank is still running"
    raw = [x.split(" ")[3:] for x in plain.out.splitlines()]
    assert len(raw) >= 2
    assert [x.split(" ")[3:] for x in mesh.out.splitlines()] == raw
    assert any("I:" in " ".join(x) for x in raw)

    def summary(err):
        return [x for x in err.splitlines() if x.startswith("burst_detect:")]
    assert summary(mesh.err) == summary(plain.err) != []
    # whichever run took a second or more printed the stats line, rank 0
    # alone: the JAX CLI's fields (test_torch_cli_outputs.py)
    for fields in stats_fields(mesh.err) + stats_fields(plain.err):
        assert fields == ["srr", "i_avg", "q_max", "i_ok", "o", "ok", "ok",
                          "ok_avg", "ok", "ok_avg", "d"]
    assert mesh.err.count("warning: --save-bursts is not supported on the "
                          "--mesh sharded path; ignoring") == 1
    assert not dump.exists()


def test_mesh_cli_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "cap.cf32"
    np.zeros(1024, np.complex64).view(np.float32).tofile(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-f", str(path), "--mesh", "2"])


def _cli_on_stdin(data: bytes, extra: list) -> subprocess.CompletedProcess:
    """`python -m iridium_tpu_torch.cli -f - ...` in its own process (from
    the repo root) with `data` on its stdin."""
    return subprocess.run(
        [sys.executable, "-m", "iridium_tpu_torch.cli", "-f", "-"] + extra,
        input=data, capture_output=True, timeout=300, cwd=ROOT)


def test_mesh_cli_reads_stdin(tmp_path, capfd):
    """`-f - --mesh 2`: rank 0 reads the capture from stdin and broadcasts
    each block; rank 0 prints the lines the plain CLI prints on the same
    file, from the frequency on."""
    path = tmp_path / "cap.cf32"
    np.ascontiguousarray(capture()).view(np.float32).tofile(path)
    assert cli.main(["-f", str(path)] + ARGS) == 0
    plain = capfd.readouterr()
    raw = [x.split(" ")[3:] for x in plain.out.splitlines()]
    assert len(raw) >= 2
    res = _cli_on_stdin(path.read_bytes(),
                        ["--format", "cf32", "--mesh", "2"] + ARGS)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert [x.split(" ")[3:] for x in res.stdout.decode().splitlines()] \
        == raw


def test_mesh_cli_empty_stdin_ends():
    """An empty stdin on the mesh: every rank stops after rank 0's end
    flag, exit 0, no lines."""
    res = _cli_on_stdin(b"", ["--format", "cf32", "--mesh", "2"] + ARGS)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert res.stdout == b""
    assert b"tagged 0 bursts total" in res.stderr
