"""The port's protocol decoders and outputs (iridium_tpu_torch.decode,
.output, .io.synth_frames, .utils) against the JAX package's on the same
inputs, made from a seed with numpy.

Both sides are host code in numpy, so every comparison is exact: equal
frame encodings, field-for-field equal decodes, equal `IDA:` strings,
GSMTAP bytes and ACARS JSON, equal web-map snapshots; the Doppler fix
agrees within 1e-9 relative (the same float64 arithmetic in the same
order). libacars is kept out (`la=None`), as on the card's machine.
"""

import dataclasses
import io
import math

import numpy as np
import pytest

from iridium_tpu.decode import batch as jbatch
from iridium_tpu.decode import doppler as jdoppler
from iridium_tpu.decode import frame as jframe
from iridium_tpu.decode import ida as jida
from iridium_tpu.decode import sbd_acars as jacars
from iridium_tpu.io import synth_frames as jsf
from iridium_tpu.output import gsmtap as jgsmtap
from iridium_tpu.output import raw as jraw
from iridium_tpu.output import web_map as jweb
from iridium_tpu.utils import wgs84 as jwgs84
from iridium_tpu_torch.decode import batch, doppler, frame, ida, sbd_acars
from iridium_tpu_torch.io import synth_frames as sf
from iridium_tpu_torch.output import gsmtap, raw, web_map
from iridium_tpu_torch.utils import wgs84

T0 = 1_700_000_000_000_000_000


def encodings(pkg):
    """Frame bit strings (after the access code) from one package's
    synth_frames."""
    return dict(
        ira=pkg.ira_payload_bits(23, 11, (1000, -500, 1200),
                                 [(0x12345678, 3), (0xDEADBEEF, 7)]),
        ira_bare=pkg.ira_payload_bits(55, 21, (100, -200, 1500)),
        ibc=pkg.ibc_payload_bits(33, 9, timeslot=1, iri_time=123456789),
        ibc_type2=pkg.ibc_payload_bits(7, 40, bc_type=2),
        ida=pkg.ida_payload_bits(b"PARITY-CHECK", cont=0, ctr=0, lcw_ft=0,
                                 lcw_code=6, lcw3_val=0x1ABCD),
        ida_cont=pkg.ida_payload_bits(b"0123456789abcdefghij", cont=1,
                                      ctr=3, lcw_code=6),
        ida_empty=pkg.ida_payload_bits(b""),
    )


@pytest.mark.parametrize("kind", sorted(encodings(sf)))
def test_synth_frames_equal(kind):
    got, want = encodings(sf)[kind], encodings(jsf)[kind]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sf.with_access(got, "UL"),
                                  jsf.with_access(want, "UL"))


def noisy_frames(seed, n=60):
    """Demod-frame dicts of every encoding with bit errors at seeded
    positions, low LLRs on the flipped bits, seeded LLRs elsewhere, and
    some truncated frames."""
    rng = np.random.default_rng(seed)
    encs = list(encodings(sf).values())
    frames = []
    for i in range(n):
        bits = sf.with_access(encs[i % len(encs)]).copy()
        llr = rng.uniform(0.5, 4.0, len(bits)).astype(np.float32)
        for p in rng.choice(np.arange(24, len(bits)), int(rng.integers(0, 7)),
                            replace=False):
            bits[p] ^= 1
            llr[p] = np.float32(rng.uniform(0.0, 0.1))
        if i % 13 == 5:
            bits = bits[:int(rng.integers(10, len(bits)))]
            llr = llr[:len(bits)]
        frames.append(dict(
            bits=bits, llr=llr, timestamp_ns=T0 + i * 90_000_000,
            id=1000 + i, frequency=1.6221e9 + 41_667.0 * (i % 5),
            magnitude=-20.0 + i,
            noise=-100.0, level=0.01 * (1 + i % 7), confidence=90 + i % 10,
            n_symbols=len(bits) // 2,
            direction="UL" if i % 11 == 3 else "DL"))
    return frames


def as_dict(x):
    return None if x is None else dataclasses.asdict(x)


def same_ida(a, b):
    if a is None or b is None:
        return a is None and b is None
    da, db = as_dict(a), as_dict(b)
    sa, sb = da.pop("bch_stream"), db.pop("bch_stream")
    return np.array_equal(np.asarray(sa), np.asarray(sb)) and da == db


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_block_matches_jax(seed):
    frames = noisy_frames(seed)
    got = batch.decode_block(frames)
    want = jbatch.decode_block(frames)
    n_frame = n_ida = 0
    for f, (gd, gi), (wd, wi) in zip(frames, got, want):
        assert (gd is None) == (wd is None)
        if gd is not None:
            assert gd[0] == wd[0]
            assert as_dict(gd[1]) == as_dict(wd[1])
            n_frame += 1
        assert same_ida(gi, wi)
        n_ida += gi is not None
        # the scalar decoders, which decode_block must equal
        sd = frame.frame_decode(f)
        assert (sd is None) == (gd is None)
        assert same_ida(ida.ida_decode(f), jida.ida_decode(f))
        wd2 = jframe.frame_decode(f)
        assert as_dict(None if sd is None else sd[1]) == \
            as_dict(None if wd2 is None else wd2[1])
    assert n_frame >= 10 and n_ida >= 10


@pytest.mark.parametrize("seed", [0, 1])
def test_format_ida_matches_jax(seed):
    frames = noisy_frames(seed)
    p, jp = raw.RawPrinter(), jraw.RawPrinter()
    n = 0
    for f, (_, b) in zip(frames, batch.decode_block(frames)):
        assert p.format(f) == jp.format(f)
        if b is not None:
            assert p.format_ida(b) == jp.format_ida(b)
            n += 1
    assert n >= 10


GSMTAP_CASES = [
    (b"ABCD", 1_622_090_000.0, "DL", 0.05),
    (bytes(range(40)), 1_626_270_833.3, "UL", 1.0),
    (bytes(300), 1_616_000_000.0, "DL", 0.0),
    (b"\x76\x08" + bytes(18), 1_621_120_000.0, "DL", 200.0),
]


@pytest.mark.parametrize("case", range(len(GSMTAP_CASES)))
def test_gsmtap_matches_jax(case):
    data, freq, direction, mag = GSMTAP_CASES[case]
    dbm = int(20.0 * math.log10(mag)) if mag > 0 else -128
    assert gsmtap.build_packet(data, freq, direction, dbm) == \
        jgsmtap.build_packet(data, freq, direction, dbm)
    sent = []
    for mod in (gsmtap, jgsmtap):
        s = mod.GsmtapSender("127.0.0.1", 4729)
        s.sock.close()
        s.sock = type("Sock", (), {"sendto": lambda self, b, a:
                                   sent.append((b, a))})()
        s.send(data, freq, direction, mag)
    assert len(sent) == 2 and sent[0] == sent[1]


def acars_messages(kind):
    """Reassembled IDA messages carrying SBD/ACARS, as the IDA
    reassembler hands them to the ACARS decoder."""
    sbd = sf.acars_sbd(b"TEST MESSAGE 123")
    assert sbd == make_acars_sbd(b"TEST MESSAGE 123")
    if kind == "single":
        return [sf.sbd_ida_message(sbd)]
    if kind == "two_packets":
        half = len(sbd) // 2
        pre = bytes([0x20, 0, 0, 2, 0])
        return [bytes([0x76, 0x08]) + pre + bytes([0x10, half, 1])
                + sbd[:half],
                bytes([0x76, 0x09, 0x10, len(sbd) - half, 2]) + sbd[half:]]
    if kind == "bad_crc":
        m = bytearray(sf.sbd_ida_message(sbd))
        m[-5] ^= 0x01
        return [bytes(m)]
    if kind == "not_sbd":
        return [bytes([0x76, 0x05, 0, 1, 2, 3, 4, 5])]
    raise ValueError(kind)


def make_acars_sbd(text):
    """test_outputs.py's make_acars_sbd, restated: the port's
    synth_frames.acars_sbd must build the same bytes."""
    def odd_parity(b):
        return bytes(c | 0x80 if bin(c).count("1") % 2 == 0 else c
                     for c in b)
    core = odd_parity(b"2" + b".N1234A" + b"\x06" + b"H1" + b"1"
                      + b"\x02" + text + b"\x03")
    crc = jacars.crc16_kermit(core)
    return b"\x01" + core + bytes([crc & 0xFF, (crc >> 8) & 0xFF]) + b"\x7f"


@pytest.mark.parametrize("kind,json_out",
                         [("single", True), ("single", False),
                          ("two_packets", True), ("bad_crc", True),
                          ("not_sbd", False)])
def test_acars_decoder_matches_jax(kind, json_out):
    outs = []
    for mod in (sbd_acars, jacars):
        feed = []
        dec = mod.AcarsDecoder(json_out=json_out, station="TEST1",
                               wall_t0=1_700_000_000.0, la=None,
                               text_out=io.StringIO(),
                               feed_sender=feed.append)
        for i, m in enumerate(acars_messages(kind)):
            dec.process(m, 1_000_000_000 + i * 90_000_000, 1.6262e9, "DL",
                        30.0)
        outs.append((dec.text_out.getvalue(), feed, dec.stats,
                     [dataclasses.asdict(x) for x in dec.messages]))
    assert outs[0] == outs[1]
    if kind in ("single", "two_packets"):
        assert outs[0][2]["acars_total"] == 1
        assert "TEST MESSAGE 123" in outs[0][0]


def ira_points(seed, n=40):
    """Seeded IRA fields along four circular orbits near 47N 8E, with
    channel-folded frequencies (test_doppler.py's scene, seeded)."""
    rng = np.random.default_rng(seed)
    rx = jwgs84.geodetic_to_ecef(47.0, 8.0, 100.0)
    rx_vel = np.array([-jwgs84.OMEGA_EARTH * rx[1],
                       jwgs84.OMEGA_EARTH * rx[0], 0.0])
    r_orb = 7158e3
    w = math.sqrt(jwgs84.GM_EARTH / r_orb ** 3)
    pts = []
    for k in range(4):
        chan = jgsmtap.IR_BASE_FREQ + (120 + k) * jgsmtap.IR_CHANNEL_WIDTH
        raan = math.radians(8.0 + rng.uniform(-15, 15))
        incl = math.radians(86.4)
        phase0 = math.radians(47.0 - 8 + rng.uniform(-2, 2))
        for j in range(n // 4):
            th = phase0 + w * 20.0 * j
            p = np.array([math.cos(th), math.sin(th), 0.0]) * r_orb
            v = np.array([-math.sin(th), math.cos(th), 0.0]) * r_orb * w
            rot = (np.array([[math.cos(raan), -math.sin(raan), 0],
                             [math.sin(raan), math.cos(raan), 0], [0, 0, 1]])
                   @ np.array([[1, 0, 0], [0, math.cos(incl), -math.sin(incl)],
                               [0, math.sin(incl), math.cos(incl)]]))
            pos, vel = rot @ p, rot @ v
            los = pos - rx
            rho = np.linalg.norm(los)
            if np.dot(los, rx) / (rho * np.linalg.norm(rx)) < 0.1:
                continue
            rr = np.dot(los, vel - rx_vel) / rho
            freq = chan - rr / jwgs84.C_LIGHT * chan + rng.normal(0, 20.0)
            xyz = tuple(int(c) for c in np.round(pos / 4000.0))
            pts.append((dict(sat_id=10 + k, beam_id=1, pos_xyz=xyz,
                             lat=math.degrees(math.atan2(
                                 pos[2], math.hypot(pos[0], pos[1]))),
                             lon=math.degrees(math.atan2(pos[1], pos[0])),
                             alt=780, pages=[]),
                        freq, T0 + int(20.0 * j * 1e9) + k * 1_000_000))
    return pts


@pytest.mark.parametrize("seed,height", [(0, None), (1, None), (2, 100.0)])
def test_doppler_matches_jax(seed, height):
    sols = []
    for fmod, dmod in ((frame, doppler), (jframe, jdoppler)):
        s = dmod.DopplerSolver(height_aid_m=height)
        for fields, freq, ts in ira_points(seed):
            s.add_measurement(fmod.IraData(**fields), freq, ts)
        sols.append(s.solve())
    got, want = sols
    assert got.converged == want.converged
    assert want.converged
    assert (got.n_satellites, got.n_measurements) == \
        (want.n_satellites, want.n_measurements)
    for name in ("lat", "lon", "alt", "hdop"):
        g, w = getattr(got, name), getattr(want, name)
        assert abs(g - w) <= 1e-9 * max(abs(w), 1.0), name
    e = wgs84.geodetic_to_ecef(got.lat, got.lon, got.alt)
    np.testing.assert_array_equal(
        e, jwgs84.geodetic_to_ecef(got.lat, got.lon, got.alt))


@pytest.mark.parametrize("seed", [0, 1])
def test_web_map_matches_jax(seed):
    frames = noisy_frames(seed)
    snaps = []
    for wmod, fmod, imod, bmod in ((web_map, frame, ida, batch),
                                   (jweb, jframe, jida, jbatch)):
        wm = wmod.WebMap(port=0)
        reasm = imod.IdaReassembler()
        for f, (d, b) in zip(frames, bmod.decode_block(frames)):
            if d is not None and d[0] == "IRA":
                wm.add_ra(d[1], f["timestamp_ns"], f["frequency"])
            elif d is not None:
                wm.add_sat(d[1], f["timestamp_ns"])
            if b is not None:
                reasm.push(b, wm.mtpos_ida_cb)
            reasm.flush(f["timestamp_ns"])
        # the MT-position layer (test_outputs.py's 0x0605 message)
        x, y, z = 900, 1100, 500
        msg = bytearray(42)
        msg[0], msg[1], msg[36] = 0x06, 0x05, 0x1B
        msg[37:42] = (((x & 0xFFF) << 28) | ((y & 0xFFF) << 16)
                      | ((z & 0xFFF) << 4)).to_bytes(5, "big")
        wm.mtpos_ida_cb(bytes(msg), T0, 1.6261e9, "DL", -40.0)
        wm.set_position(47.123456789, 8.5, 1.25)
        snaps.append(wm.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["total_mt"] == 1 and snaps[0]["total_ibc"] >= 1
