"""The port's CLI with its protocol decoders (iridium_tpu_torch.cli,
device "cpu") end to end on one small 10 MHz capture with injected IRA,
IBC and IDA frames, one of them an ACARS SBD message split over two IDA
bursts.

`--parsed` prints the same `IDA:`/`RAW:` lines as the JAX package's CLI
on the same file (from the frequency on, which is within 1 Hz: the file
info and times follow the wall clock). The other decoder flags are held
against the JAX package's decoders run on the port's frames: the bytes
that the CLI hands to its GSMTAP and ACARS UDP sockets and to a stand-in
for pyzmq's PUB socket, and the ACARS JSON on stdout. No socket is read
back through a listener.
"""

import io
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu import cli as jcli  # noqa: E402
from iridium_tpu.decode import batch as jbatch  # noqa: E402
from iridium_tpu.decode import ida as jida  # noqa: E402
from iridium_tpu.decode import sbd_acars as jacars  # noqa: E402
from iridium_tpu.output import gsmtap as jgsmtap  # noqa: E402
from iridium_tpu.output.raw import RawPrinter as JaxRawPrinter  # noqa: E402
from iridium_tpu_torch import cli  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.io import synth, synth_frames as sf  # noqa: E402
from iridium_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

FS = 10_000_000
ACARS_TEXT = b"HELLO IRIDM"
IDA_TEXT = b"HELLO-IRIDIUM"


def decode_capture():
    """Two 10 MHz blocks (frames_per_block 512) of noise with an IRA and
    an IBC frame in the simplex band, one single-burst IDA message and an
    ACARS SBD message over two IDA bursts, 90 ms apart on one channel."""
    rng = np.random.default_rng(11)
    cap = synth.noise(6_000_000, seed=3)
    acars = sf.ida_message_bursts(
        sf.sbd_ida_message(sf.acars_sbd(ACARS_TEXT)), lcw_code=6)
    plan = [
        (sf.ira_payload_bits(55, 21, (1000, -500, 1200)), 4_300_000.0,
         4_400_000),
        (sf.ibc_payload_bits(33, 9, timeslot=1, iri_time=123456),
         4_450_000.0, 4_700_000),
        (acars[0], -880_000.0, 4_800_000),
        (sf.ida_payload_bits(IDA_TEXT, lcw_code=6, lcw3_val=0x12345),
         137_000.0, 5_000_000),
        (acars[1], -880_000.0, 5_700_000),
    ]
    for bits, off, start in plan:
        b = np.concatenate([bits, rng.integers(0, 2, 8).astype(np.uint8)])
        synth.add_burst(cap, synth.burst_waveform(b, FS, off), start,
                        snr_db=28.0)
    return cap


@pytest.fixture(scope="module")
def capture_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("parsed") / "frames.cf32"
    np.ascontiguousarray(decode_capture()).view(np.float32).tofile(path)
    return str(path)


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    so, se = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        assert main(argv) == 0
    finally:
        sys.stdout, sys.stderr = so, se
    return out.getvalue().splitlines(), err.getvalue()


def same_lines(got, want):
    """Equal from the frequency on; the frequency within 1 Hz."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gf, wf = g.split(" "), w.split(" ")
        assert gf[0] == wf[0] and len(gf) == len(wf), (g, w)
        assert abs(int(gf[3]) - int(wf[3])) <= 1, (g, w)
        assert gf[4:] == wf[4:], (g, w)


def test_cli_parsed_matches_jax(capture_path):
    got, err = run(cli.main, ["-f", capture_path, "--parsed",
                              "--device", "cpu"])
    want, _ = run(jcli.main, ["-f", capture_path, "--parsed"])
    same_lines(got, want)
    ida = [line for line in got if line.startswith("IDA:")]
    assert len(ida) == 3 and len(got) == 5
    hexed = ".".join(f"{c:02x}" for c in IDA_TEXT)
    assert any(f"[{hexed}]" in line and "CRC:OK" in line for line in ida)
    assert "burst_detect: tagged" in err


class Sent:
    """Records what the CLI hands to its UDP sockets and to a stand-in
    for pyzmq's PUB socket."""

    def __init__(self, monkeypatch):
        import socket
        self.udp, self.zmq = [], []
        monkeypatch.setattr(socket.socket, "sendto",
                            lambda s, data, addr: self.udp.append(
                                (bytes(data), addr)))
        sent = self.zmq

        class Pub:
            def bind(self, endpoint):
                self.endpoint = endpoint

            def send_string(self, line):
                sent.append(line)

            def close(self, linger=None):
                pass

        ctx = types.SimpleNamespace(socket=lambda kind: Pub())
        monkeypatch.setitem(sys.modules, "zmq", types.SimpleNamespace(
            PUB=1, Context=lambda: ctx))

    def to(self, port):
        return [d for d, a in self.udp if a == ("127.0.0.1", port)]


def expected_outputs(path):
    """The port's frames of `path` through the JAX package's decoders:
    `--parsed` lines, GSMTAP packets and ACARS JSON."""
    pipe = Pipeline(det_cfg=DetectorConfig(sample_rate=FS,
                                           frames_per_block=512),
                    device="cpu", start_time_ns=0)
    frames = list(pipe.run_file(path))
    printer, reasm_g, reasm_a = (JaxRawPrinter(), jida.IdaReassembler(),
                                 jida.IdaReassembler())
    acars = jacars.AcarsDecoder(json_out=True, station="TEST1",
                                text_out=io.StringIO(), la=None)
    lines, packets = [], []

    def gsm(data, ts, freq, direction, mag):
        dbm = int(20.0 * np.log10(mag)) if mag > 0 else -128
        packets.append(jgsmtap.build_packet(bytes(data), freq, direction,
                                            dbm))
    for f, (_, b) in zip(frames, jbatch.decode_block(frames)):
        lines.append(printer.format_ida(b) if b is not None
                     else printer.format(f))
        if b is not None:
            reasm_g.push(b, gsm)
            reasm_a.push(b, acars.process)
        reasm_g.flush(f["timestamp_ns"])
        reasm_a.flush(f["timestamp_ns"])
    return lines, packets, acars.text_out.getvalue().splitlines()


def without_time(lines):
    """ACARS JSON objects without "t", the wall-clock time."""
    js = [json.loads(line) for line in lines]
    for j in js:
        del j["iridium"]["t"]
    return js


def test_cli_decoder_flags(capture_path, monkeypatch):
    sent = Sent(monkeypatch)
    out, err = run(cli.main, [
        "-f", capture_path, "--device", "cpu", "--parsed",
        "--gsmtap", "127.0.0.1:4729", "--zmq", "tcp://127.0.0.1:7006",
        "--acars-json", "--acars-udp", "127.0.0.1:5555",
        "--station", "TEST1", "--position", "--web", "0"])
    lines, packets, acars = expected_outputs(capture_path)
    # GSMTAP: one packet per reassembled IDA message, byte for byte
    assert len(packets) == 2 and sent.to(4729) == packets
    assert "gsmtap: sent 2 frames" in err
    # ZMQ: every `--parsed` line; ACARS mode keeps them off stdout
    same_lines(sent.zmq, lines)
    assert len(sent.zmq) == 5
    # ACARS JSON on stdout and over UDP
    assert without_time(out) == without_time(acars)
    udp = [d.decode() for d in sent.to(5555)]
    assert without_time(udp) == without_time(out)
    (msg,) = without_time(out)
    assert msg["iridium"]["station"] == "TEST1"
    assert msg["iridium"]["acars"]["msg_text"] == ACARS_TEXT.decode()
    assert "acars: 1 decoded, 0 with errors" in err
    assert "burst_detect: tagged" in err


def test_cli_zmq_without_pyzmq_warns(capture_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "zmq", None)    # import fails
    out, err = run(cli.main, ["-f", capture_path, "--device", "cpu",
                              "--diagnostic", "--zmq"])
    assert "warning: pyzmq not available, --zmq disabled" in err
    assert out == []                          # diagnostic: no RAW lines
