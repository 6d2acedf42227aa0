"""The port's kernel-design tools on the CPU: the source rewriting that
builds kernel variants (`tools/variants.py`), the phase probes of
`tools/exp_scan.py`, and the scan inputs it times, at a small shape; the
front-end tool `tools/exp_frontend.py` and the window-gather tool
`tools/exp_window_gather.py` at their small CPU shapes, and the latter's
shape table; the demod-loop tool `tools/exp_demod.py` at its small CPU
shape, its shape table, inputs, checks, bound, adapter and `ptxas`
summary; the downmix-FIR tool `tools/exp_downmix.py` at its small CPU
shape, its shape table, inputs, bound and comparison; the downmix-chain
tool `tools/exp_downmix_chain.py` at its small CPU shape, its shape
table, inputs, bound and comparison; the demod-tail tool
`tools/exp_demod_tail.py` at its small CPU shape, its edge rows, bound
and swap; the SASS chain walk
of `tools/sass_chain.py` on a made-up listing; the line comparison of the
mesh tool `tools/exp_mesh.py`; the detect_fast tool `tools/exp_fast.py` at
its small CPU shape, its argument handling, cases, bound and comparison.
(Building and timing the variants needs the card; chip_smoke.py and the
tools' own runs do that.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch import _kernels  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan  # noqa: E402
from iridium_tpu_torch.ops import window_gather as wg  # noqa: E402
from iridium_tpu_torch.tools import exp_frontend, exp_scan, variants  # noqa: E402,E501
from iridium_tpu_torch.tools import exp_demod, exp_downmix, exp_mesh  # noqa: E402,E501
from iridium_tpu_torch.tools import captures, exp_fast, exp_window_gather  # noqa: E402,E501
from iridium_tpu_torch.tools import exp_demod_tail  # noqa: E402
from iridium_tpu_torch.tools import exp_downmix_chain  # noqa: E402


def test_variant_source_is_kept_apart(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    base = _kernels.BLOCK_GATHER
    v = variants.Variant(base, "// edited\n" + base.source.read_text())
    assert v.source.parent.parent == tmp_path / "variants"
    assert v.source.read_text().startswith("// edited")
    assert v.library_path() != base.library_path()
    with variants.swapped("BLOCK_GATHER", v):
        assert _kernels.BLOCK_GATHER is v
    assert _kernels.BLOCK_GATHER is base


def test_probed_source_turns_every_marker_into_a_probe():
    text = _kernels.DETECT_SCAN.source.read_text()
    probed, names = exp_scan.probed_source(text)
    assert names[0] == "setup" and "noise" in names and "reduce" in names
    assert "// phase:" not in probed
    for i in range(1, len(names)):
        assert f"PHASE_PROBE({i});" in probed
    # one `begin` a kernel: the resident scan and the tiled one
    assert probed.count("long long pt_ = clock64();") == 2
    assert 'extern "C" int detect_scan_phases(' in probed


def test_scan_inputs_at_a_small_shape():
    p = DetectorConfig(sample_rate=1_000_000, history_size=64,
                       frames_per_block=256, max_new_per_frame=8,
                       gone_capacity=64, max_bursts=20).derived()
    got = exp_scan.inputs(p, torch.device("cpu"))
    assert [name for name, _, _ in got] == ["synthetic", "noise", "dense"]
    for name, mag2, s0 in got:
        assert mag2.shape == (p.frames_per_block, p.fft_size)
        assert bool(torch.isfinite(mag2).all()), name
    # the noise and dense blocks start from a primed history
    assert int(got[1][2].primed) == p.history_size
    dense = detect_scan.scan_plain(got[2][1], got[2][2], p.block_samples, p)
    assert int(dense.n_tagged) + int(dense.a_valid.sum()) > 20
    edge = exp_scan.edge_spectrogram(
        DetectorConfig(sample_rate=10_000_000, history_size=32,
                       frames_per_block=96).derived(), seed=1)
    assert edge.dtype == np.float32 and edge.shape == (96, 8192)


def test_scan_configs_per_fft_size():
    """`exp_scan --fft F` times the derived configuration that gives F:
    the 10 MHz production one at 8192, 20, 25, 50, 100 and 200 MHz (the
    kernel's clusters of 2, 4, 8 and 16 blocks) at 16384 to 262144. The
    cluster edge rows need a cluster edge."""
    for fft, frames in ((8192, 2048), (16384, 1024), (32768, 1024),
                        (65536, 1024), (131072, 1024), (262144, 1024)):
        p = exp_scan.production_params(fft)
        assert (p.fft_size, p.frames_per_block) == (fft, frames)
        assert detect_scan.supports(p)
    assert [detect_scan.clusters(f) for f in (8192, 16384, 32768, 65536,
                                              131072, 262144)
            ] == [1, 2, 4, 8, 16, 16]
    with pytest.raises(ValueError):
        exp_scan.cluster_edge_spectrogram(exp_scan.production_params(), 1)


def test_spill_table_names_every_instantiation():
    """`exp_scan.spill_table` keys `ptxas -v`'s lines by the kernel they
    follow: the resident kernel's instantiations by their template
    arguments, the tiled kernel (no template) by its own name, and no
    kernel's figures land under the one before it."""
    ns = "_ZN12_GLOBAL__N_1"
    lines = [
        f"ptxas info    : Compiling entry function '{ns}18detect_scan_kernel"
        f"ILi8ELi16ELb1EEEvNS_5StateENS_6ParamsEi' for 'sm_90a'",
        f"ptxas info    : Function properties for {ns}18detect_scan_kernel"
        f"ILi8ELi16ELb1EEEvNS_5StateENS_6ParamsEi",
        "    112 bytes stack frame, 112 bytes spill stores, 120 bytes spill "
        "loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{ns}17detect_scan_tiled"
        f"ENS_5StateENS_6ParamsEiP5uint4' for 'sm_90a'",
        f"ptxas info    : Function properties for {ns}17detect_scan_tiled"
        f"ENS_5StateENS_6ParamsEiP5uint4",
        "    148 bytes stack frame, 148 bytes spill stores, 104 bytes spill "
        "loads",
        "ptxas info    : Used 64 registers, used 1 barriers"]
    assert exp_scan.spill_table(lines) == {
        "BPT=8,C=16,grid": dict(spill_stores=112, spill_loads=120,
                                registers=64),
        "BPT=16,C=16,tiled": dict(spill_stores=148, spill_loads=104,
                                  registers=64)}


def test_probed_source_of_the_fused_frontend():
    text = _kernels.FUSED_FRONTEND.source.read_text()
    probed, names = exp_scan.probed_source(text, "fused_frontend")
    assert names == ["setup", "load", "fir", "reduce", "end"]
    assert 'extern "C" int fused_frontend_phases(' in probed
    assert "detect_scan_phases" not in probed


def test_exp_frontend_small_on_cpu(capsys):
    assert exp_frontend.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "small package:" in out and "max|err| 0 " in out
    with pytest.raises(SystemExit):
        exp_frontend.main(["--device", "cpu", "--small", "--source", "x.cu"])


def test_exp_frontend_bound_counts_the_work():
    """The bound at the small-normal class's count of work: 3 TF32
    multiply-adds per tap product on both planes at 495 TFLOP/s, and the
    bytes of the samples the windows cover plus the outputs."""
    B, l_win, ntaps = 4, 327_680, 801
    planes = torch.zeros((2, 5 * l_win))
    # two windows overlap by half; two are apart
    starts2 = torch.tensor([[0, 0], [8, 0], [40, 0], [60, 3]],
                           dtype=torch.int32)
    b = exp_frontend.bound(planes, starts2, l_win, ntaps, 40)
    n_out = l_win // 40
    span = (n_out - 1) * 40 + ntaps
    covered = 3 * span + 8 * 20480
    assert b["bytes_ms"] == pytest.approx(
        (8 * covered + 8 * B * n_out + 4 * ntaps) / 3.35e12 * 1e3)
    assert b["tensor_ms"] == pytest.approx(
        12 * ntaps * B * n_out / 495e12 * 1e3)
    assert b["fp32_fma_ms"] == pytest.approx(
        4 * ntaps * B * n_out / 67e12 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["tensor_ms"])
    assert b["bound_by"] == "bytes"


def test_exp_window_gather_small_on_cpu(capsys):
    assert exp_window_gather.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "small 4 x 40960 package:" in out and '"max_abs_err": 0.0' in out
    with pytest.raises(SystemExit):
        exp_window_gather.main(["--device", "cpu", "--small", "--source",
                                "x.cu"])


def test_exp_window_gather_shapes_follow_the_pipeline():
    """The class batches of the 1 MHz and 25 MHz group programs and their
    group streams (4 blocks), read from the pipeline."""
    got = {(s["rate_mhz"], s["shape"]): s
           for s in exp_window_gather.class_shapes((1.0, 25.0))}
    want = {(1.0, "small_normal"): (1024, 143_360),
            (1.0, "small_simplex"): (96, 143_360),
            (1.0, "large"): (48, 143_360),
            (25.0, "small_normal"): (1024, 614_400),
            (25.0, "small_simplex"): (96, 614_400),
            (25.0, "large"): (48, 2_846_720)}
    assert {k: (s["B"], s["l_win"]) for k, s in got.items()} == want
    for (mhz, _), s in got.items():
        assert s["decim"] == {1.0: 4, 25.0: 100}[mhz]
        assert s["n_stream"] == {1.0: 5_341_184, 25.0: 156_991_488}[mhz]
        assert not s["fused"]


def test_exp_window_gather_inputs_and_bound():
    """Starts keep every window inside the stream with r < decimation;
    the bound counts the covered samples once and the output once."""
    gen = torch.Generator()
    gen.manual_seed(0)
    B, l_win, decim, n = 64, 2 * wg.ALIGN, 100, 6 * wg.ALIGN
    planes, starts2 = exp_window_gather.gather_inputs(
        torch.device("cpu"), gen, B, l_win, decim, n)
    assert planes.shape == (2, n) and starts2.dtype == torch.int32
    r = starts2[:, 1]
    assert int(r.min()) >= 0 and int(r.max()) < decim
    s = starts2[:, 0].long() * wg.ALIGN + r
    assert int(s.min()) >= 0 and int(s.max()) + l_win <= n
    two = torch.tensor([[0, 0], [1, 3]], dtype=torch.int32)
    covered = wg.ALIGN + 3 + l_win          # two windows, overlapping
    assert exp_window_gather.bound_ms(two, l_win, n) == pytest.approx(
        (8 * covered + 8 * 2 * l_win) / 3.35e12 * 1e3)


def test_exp_window_gather_adapts_an_unordered_entry():
    """A source whose entry takes no `order` scratch gets an entry with
    the package's argument list; the package's own source is kept."""
    own = _kernels.WINDOW_GATHER.source.read_text()
    assert exp_window_gather.adapted(own) == own
    old = ('extern "C" int window_gather(const float* planes, long long n,'
           '\n    const int* starts2, int B, int l_win, int align,'
           '\n    float* out_re, float* out_im, cudaStream_t stream) {'
           '\n  return 0;\n}\n')
    new = exp_window_gather.adapted(old)
    assert new.startswith(old.replace("window_gather(",
                                      "window_gather_unordered(", 1))
    assert "const int* starts2, int* order, int B," in new
    assert new.count('extern "C" int window_gather(') == 1


def test_exp_mesh_jobs_and_line_order():
    """The mesh tool's jobs: both binshard captures beside the replicated
    ones; an unknown job is refused before anything runs. A decode's
    lines do not depend on the order its frames come in (binshard's
    follow its rank-strided ids): the printer's time base is the earliest
    frame's second."""
    assert exp_mesh.JOBS["binshard_10mhz"][1:] == (captures.PROD,
                                                   "binshard")
    assert exp_mesh.JOBS["binshard_1mhz"][2] == "binshard"
    with pytest.raises(SystemExit):
        exp_mesh.main(["--jobs", "raw_10mhz,nope"])
    frames = [dict(timestamp_ns=exp_mesh.T0 + t, frequency=f, magnitude=1.0,
                   noise=-1.0, id=i, confidence=90, level=0.1,
                   n_symbols=20, bits=[1, 0])
              for t, f, i in ((1_500_000_000, 5.0, 3), (600_000_000, 7.0, 1),
                              (600_000_000, 6.0, 2))]
    lines = exp_mesh.raw_lines(frames)
    assert lines == exp_mesh.raw_lines(frames[::-1])
    assert [x.split()[2:4] for x in lines] == [
        ["0000600.0000", "0000000006"], ["0000600.0000", "0000000007"],
        ["0001500.0000", "0000000005"]]


def test_exp_mesh_compare_lines():
    """Equal lines, lines whose frequency or level differ (counted, with
    the largest difference), ids masked and sorted, and the differences
    that fail: another field, or another count."""
    a = ("RAW: i-1-t1 0000123.4560 1622137000 N:30.12-80.00 I:00000000007 "
         " 98% 0.01234 179 0101")
    b = a.replace("1622137000", "1622137030").replace("0.01234", "0.01241")
    c = a.replace("I:00000000007", "I:00000000042")
    got = exp_mesh.compare_lines([a, b], [a, a], masked=False)
    assert got["lines"] == 2 and got["equal"] == 1
    assert got["fields"]["frequency"] == dict(lines=1, max_diff=30.0)
    assert got["fields"]["level"]["lines"] == 1
    assert abs(got["fields"]["level"]["max_diff"] - 7e-5) < 1e-9
    assert exp_mesh.compare_lines([c], [a], masked=True) == dict(
        lines=1, equal=1, fields={})
    with pytest.raises(AssertionError, match="id"):
        exp_mesh.compare_lines([c], [a], masked=False)
    with pytest.raises(AssertionError, match="2 lines against 1"):
        exp_mesh.compare_lines([a, a], [a], masked=False)


def test_exp_demod_small_on_cpu(capsys):
    assert exp_demod.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    for mode in ("gardner", "no_gardner"):
        assert f"small 9 x 400 x 40 {mode}:" in out
    assert out.count('"out_bit_equal": true') == 2
    with pytest.raises(SystemExit):
        exp_demod.main(["--device", "cpu", "--small", "--classes"])


def test_exp_downmix_small_on_cpu(capsys):
    assert exp_downmix.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "small 9 x 301:" in out and '"bit_equal": true' in out
    # on the CPU the wrappers are the plain versions: no launch
    assert '"launches": 0' in out
    with pytest.raises(SystemExit):
        exp_downmix.main(["--device", "cpu", "--small", "--classes"])


def test_exp_downmix_shapes_follow_the_pipeline():
    """The 10 MHz class batches are (batch, dec_cap) of the pipeline's
    classes: 1,024 and 96 rows of 8,172 decimated samples, 48 of 28,140."""
    got = [(s["shape"], s["B"], s["L"]) for s in exp_downmix.class_shapes()]
    assert got == [("small_normal", 1024, 8172), ("small_simplex", 96, 8172),
                   ("large", 48, 28140)]


def test_exp_downmix_inputs_have_the_edges():
    x, xf, dl, sd, fl, st, u, corr = exp_downmix.inputs(20, 300, seed=2)
    assert x.shape == xf.shape == (20, 300) and x.dtype == np.complex64
    edges = [0, 1, 19, 20, 24, 25, 26, 300]
    assert list(dl[:8]) == edges and list(fl[:8]) == edges
    assert not sd[:8].any()
    assert (dl[8], sd[8]) == (300, 30) and sd[9] > dl[9]
    assert (fl >= 0).all() and (fl <= dl).all() and (dl <= 300).all()
    # stage 1: the edge frames from 0, the others inside the row but for
    # a start past it and a frame past its end; u's ends and corr 0
    assert not st[:8].any() and (st >= 0).all()
    assert st[10] > 300 and fl[11] == dl[11] >= 75
    assert st[11] + fl[11] == 300 + fl[11] // 2 + fl[11] % 2
    inside = np.ones(20, bool)
    inside[[10, 11]] = False
    assert (st + fl <= 300)[inside].all()
    assert (u[12], u[13], corr[14]) == (-2048, 2048, 0.0)
    assert (np.abs(u) <= 2048).all() and (np.abs(corr) <= 0.5).all()
    assert u.dtype == st.dtype == np.int64 and corr.dtype == np.float32
    assert exp_downmix.cfo_total() == 4096


def test_exp_downmix_bound_counts_the_fold():
    """Stage 1 read from start: the frame's samples the row holds from
    there (8 bytes each) with the fine rotation's 11 operations each, the
    RRC up to 25 past them, and start, u and corr (20 bytes a row)."""
    dl, sd, fl = np.array([50, 10, 0]), np.array([10, 0, 0]), np.array(
        [30, 0, 100])
    st = np.array([90, 5, 30])
    plain = exp_downmix.bound(dl, sd, fl, 100, 25, 20, 51, 2e9)
    b = exp_downmix.bound(dl, sd, fl, 100, 25, 20, 51, 2e9, start=st,
                          rotate=True)
    kept = 40 + 10
    hf = 10 + 0 + 70
    assert b["bound_bytes"] == (8 * kept + 8 * hf + 24 * 3 + 4 * 96
                                + 20 * 3 * 100 + 20 * 3)
    assert b["bound_ops"] == (98 * 40 + kept + 39 * (50 + 10) + 202 * 35
                              + 202 * 95 + 11 * hf)
    assert b["bound_ops"] < plain["bound_ops"]
    assert exp_downmix.bound(dl, sd, fl, 100, 25, 20, 51, 2e9,
                             start=0 * st) == plain


def test_exp_downmix_designs_edit_the_source():
    """`fir_alone` takes the one rotation call out of the package's
    source and `no_taps` the loop over the taps past the first; `adapted`
    leaves an entry with the sync search's arguments alone and puts one in
    front of an entry without them (a9ef2e1's) or without the rotation's
    too (the design before the fold), passing the rotation's where the
    entry takes them."""
    text = _kernels.DOWNMIX_FIR.source.read_text()
    cut = exp_downmix.probe_no_taps(text)
    assert exp_downmix.TAPS_LOOP not in cut and len(cut) < len(text) + 8
    with pytest.raises(ValueError):
        exp_downmix.probe_no_taps(cut)
    alone = exp_downmix.probe_fir_alone(text)
    assert alone.count("turn(") == text.count("turn(") - 1 >= 1
    with pytest.raises(ValueError):
        exp_downmix.probe_fir_alone(alone)
    assert exp_downmix.adapted(text) == text
    no_sync = text.replace("float* out_f, float2* sync,\n"
                           "                           int search_cap, "
                           "int corr_n, cudaStream_t", "float* out_f, "
                           "cudaStream_t", 1)
    old = no_sync.replace("const long long* u, const float* corr,\n"
                          "                           long long two_total, ",
                          "", 1)
    assert text != no_sync != old
    for src, rotation in ((no_sync, True), (old, False)):
        got = exp_downmix.adapted(src)
        assert got.count('extern "C" int downmix_fir(') == 1
        assert 'extern "C" int downmix_fir_inner(' in got
        call = got[got.index("return downmix_fir_inner("):]
        assert ("u, corr, two_total" in call[:call.index(";")]) == rotation


def test_exp_downmix_bound_counts_the_work():
    """Bytes: the kept samples and the frame read once, three lengths a
    row, the taps, 20 bytes a sample written; operations: the noise FIR
    (98) at each kept sample of a row whose LPF runs, a square, the box
    FIR (39) from 19 before the kept samples to their end, the RRC (202)
    up to 25 past the frame."""
    dl, sd, fl = np.array([50, 10, 0]), np.array([10, 0, 0]), np.array(
        [30, 0, 100])
    b = exp_downmix.bound(dl, sd, fl, 100, 25, 20, 51, 2e9)
    kept = 40 + 10
    assert b["bound_bytes"] == (8 * kept + 8 * (30 + 100) + 24 * 3
                                + 4 * 96 + 20 * 3 * 100)
    assert b["bound_ops"] == (98 * 40 + kept + 39 * (50 + 10) + 202 * 55
                              + 202 * 100)
    assert b["ops_ms"] == pytest.approx(
        b["bound_ops"] / (132 * 128 * 2e9) * 1e3)
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])


def test_exp_downmix_compare_names_the_first_difference():
    x = torch.zeros((3, 10), dtype=torch.complex64)
    f = torch.zeros((3, 10))
    want = (x, f, x.clone())
    assert exp_downmix.compare(want, want) == dict(
        bit_equal=True, max_abs_err=0.0, first_diff=None)
    # a zero's sign is no difference
    assert exp_downmix.compare((x, -f, x), want)["bit_equal"]
    xr = x.clone()
    xr[2, 7] = 1e-3j
    xr[1, 9] = 2.0
    res = exp_downmix.compare((x, f, xr), want)
    assert not res["bit_equal"] and res["first_diff"] == ["xr", 1, 9]
    assert res["max_abs_err"] == 2.0


def test_exp_downmix_chain_small_on_cpu(capsys):
    assert exp_downmix_chain.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "small 12 x 1024:" in out and "bit-equal True" in out
    # on the CPU the wrappers are the twins: no launch
    assert '"launches": 0' in out and '"library_ms": null' in out


def test_exp_downmix_chain_shapes_follow_the_pipeline():
    """The 10 MHz class batches (batch, dec_cap) with their Downmix's
    constants: the CFO FFT of 4,096, the sync search of 840 samples in an
    FFT of 2,048, frames of 1,918 (normal) and 4,440 samples."""
    got = [(s["shape"], s["B"], s["L"], s["dm"].chain.max_frame_cap)
           for s in exp_downmix_chain.class_shapes()]
    assert got == [("small_normal", 1024, 8172, 1918),
                   ("small_simplex", 96, 8172, 4440),
                   ("large", 48, 28140, 4440)]
    k = exp_downmix_chain.class_shapes()[0]["dm"].chain
    assert (k.cfo_total, k.search_cap, k.corr_n) == (4096, 840, 2048)


def test_exp_downmix_chain_inputs_have_the_edges():
    k = exp_downmix_chain.small_shape()["dm"].chain
    t = exp_downmix_chain.inputs(12, 300, k, 801, seed=3)
    dec_len = (t["ext_len"] - 800) // k.decim
    assert list(dec_len[:6]) == [0, 1, 19, 20, 21, 300]
    assert t["shift_dec"][6] > dec_len[6] and t["shift_dec"][7] > 300
    # the short window: ext_len - shift_dec decim below 100
    assert t["ext_len"][8] - t["shift_dec"][8] * k.decim < 100
    assert not t["x"][9].any() and t["x"].dtype == np.complex64
    assert (t["center_bin"] >= 0).all() and (
        t["center_bin"] < k.fft_size).all()


def test_exp_downmix_chain_bound_counts_the_work():
    """Bytes a stage: filt below flen, the CFO samples read and the window,
    three lengths, z and the row's fields written; the spectrum read; fwd
    and the templates read, both products written; cc below the search
    span, the extracted samples, the row's fields and the samples
    written. The bound is the larger of bytes and operations, summed."""
    sh = exp_downmix_chain.small_shape()
    dm, B, L = sh["dm"], sh["B"], sh["L"]
    k = dm.chain
    t = {n: torch.from_numpy(v) for n, v in exp_downmix_chain.inputs(
        B, L, k, dm.in_ntaps, 5).items()}
    run = exp_downmix_chain.chain(t, dm)
    b = exp_downmix_chain.bound(run, 2e9)
    st = b["stages"]
    assert st["cfo_peak"]["bytes"] == 8 * B * 4096 + 16 * B
    assert st["sync_products"]["bytes"] == 24 * B * 2048 + 16 * 2048
    assert b["bound_bytes"] == sum(v["bytes"] for v in st.values())
    assert b["bound_ops"] == sum(v["ops"] for v in st.values())
    fl = run["want"]["burst_start"][1]
    search = int(torch.clamp(torch.clamp(fl, max=k.search_cap), min=0).sum())
    n = int(torch.count_nonzero(run["want"]["sync_extract"].samples))
    assert st["sync_extract"]["bytes"] == (16 * search + 8 * n + 46 * B
                                           + 8 * B * k.max_frame_cap)
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == "bytes"


def test_exp_downmix_chain_compare_names_the_first_difference():
    x = torch.zeros((2, 3, 10), dtype=torch.complex64)
    assert exp_downmix_chain.compare(x, x.clone())["bit_equal"]
    y = x.clone()
    y[1, 2, 4] = 3.0
    res = exp_downmix_chain.compare(y, x)
    # the row of the last dimension: template 1, row 2
    assert res["first_diff"] == ["0", 5, 4] and res["max_abs_err"] == 3.0
    ok = torch.tensor([True, False])
    res = exp_downmix_chain.compare((ok,), (~ok,), ["ok"])
    assert not res["bit_equal"] and res["first_diff"] == ["ok", 0, 0]


def test_exp_downmix_chain_card_flags_need_the_card():
    """`--clusters` and `--source` time on the card only."""
    for flag in (["--clusters"], ["--source", "x.cu"]):
        with pytest.raises(SystemExit):
            exp_downmix_chain.main(["--device", "cpu", "--small", *flag])


def test_exp_downmix_chain_adapts_a_layoutless_entry():
    """`--source`: a source whose entry takes no layout (stage 0 five ints)
    is renamed behind an entry that drops each stage's layout ints; the
    package's source is taken as it is."""
    text = ('static const int kCounts[4][3] = {{10, 5, 1}, {4, 0, 0}, '
            '{4, 0, 0},\n {13, 12, 4}};\n'
            'extern "C" int downmix_chain(int stage) { return 0; }\n')
    got = exp_downmix_chain.adapted(text)
    assert got.count('static int downmix_chain_inner(int stage)') == 1
    assert got.count('extern "C" int downmix_chain(') == 1
    assert "kLayout[4] = {2, 1, 0, 1}" in got
    assert "n_ints - drop" in got
    pkg = _kernels.DOWNMIX_CHAIN.source.read_text()
    assert exp_downmix_chain.adapted(pkg) == pkg
    assert exp_downmix_chain.LAYOUT_INTS == (2, 1, 0, 1)


def test_exp_downmix_chain_forces_a_cluster_and_restores_the_plan():
    """`--clusters`: inside `forced_cluster(c)` every wrapper's plan has c
    blocks a row; after it the package's plan is back."""
    from iridium_tpu_torch.dsp import downmix
    plan = downmix.plan
    for c in downmix.CLUSTERS:
        with exp_downmix_chain.forced_cluster(c):
            assert downmix.plan(1024, 8172).cluster == c
    assert downmix.plan is plan


def test_exp_demod_tail_card_flags_need_the_card():
    """`--layouts` and `--source` time on the card only."""
    for flag in (["--layouts"], ["--source", "x.cu"]):
        with pytest.raises(SystemExit):
            exp_demod_tail.main(["--device", "cpu", "--small", *flag])


def test_exp_demod_tail_layouts_and_sources():
    """`--layouts`: the warps a burst the kernel takes at S, each forced in
    turn and the plan restored; `--source`: a source whose entry takes a
    stage first runs as `decide` then `pack` (`staged`)."""
    from iridium_tpu_torch.runtime import pipeline
    assert exp_demod_tail.layouts(1024, 205) == [1, 2, 4, 8, 16]
    assert exp_demod_tail.layouts(48, 471) == [2, 4, 8, 16]
    plan = pipeline.tail_plan
    with exp_demod_tail.forced_layout(8):
        assert pipeline.tail_plan(48, 471).warps == 8
    assert pipeline.tail_plan is plan
    assert not exp_demod_tail.staged(_kernels.DEMOD_TAIL)
    old = variants.Variant.__new__(variants.Variant)
    old.text = 'extern "C" int demod_tail(int stage, int B, long long n,'
    assert exp_demod_tail.staged(old)


def test_exp_demod_tail_fused_bound_counts_the_work():
    """`decide_pack`: `decide`'s reads, six fields (21 bytes a burst) and
    the rows written; no bits or LLRs either way."""
    from iridium_tpu_torch.runtime import pipeline
    sh = dict(exp_demod_tail.SMALL)
    c = exp_demod_tail.case(sh, True, torch.device("cpu"), seed=8)
    args = c["args"]
    want = c["dm"].decide_plain(*args)
    B, S = sh["B"], sh["S"]
    two = exp_demod_tail.bound(args, want, 2 * S, True)["launches"]
    b = exp_demod_tail.fused_bound(args, want, 2 * S, True)
    W = pipeline.row_words(2 * S, True)
    assert b["bound_bytes"] == (two["decide"]["bytes"] - 17 * B
                                - 16 * B * S + 21 * B + 4 * B * W)
    assert b["bound_ops"] == two["decide"]["ops"] + two["pack"]["ops"]
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])


def test_exp_demod_tail_runs_the_two_launch_design(monkeypatch):
    """`--source` of the design of two launches: its Variant binds the
    entry with the stage first (the package's kernel keeps its own), and
    `two_launches` packs stage 0 (`decide`: 13 pointers, UW_MAX_ERRORS,
    three floats, the (B, 2S) bits and LLRs) then stage 1 (`pack`: 14
    pointers, s2_pad, want_llr and the row width) as that entry takes
    them."""
    import ctypes
    from iridium_tpu_torch.dsp import demod, downmix
    from iridium_tpu_torch.runtime import pipeline
    base = _kernels.DEMOD_TAIL
    old = variants.Variant(base, 'extern "C" int demod_tail(int stage,')
    monkeypatch.setattr(variants, "candidates",
                        lambda b, sources: [("package", b), ("old", old)])
    cands = exp_demod_tail.candidates(["old.cu"])
    assert old.argtypes == [ctypes.c_int] + list(base.argtypes)
    assert base.argtypes[0] is ctypes.c_int and len(base.argtypes) == 9
    calls = []

    class Fake:
        def launch(self, device, *args):
            calls.append((device, args))
    monkeypatch.setattr(_kernels, "ptr", lambda t: 0)
    meta = torch.device("meta")
    B, S = 5, 40
    dm = demod.Demod(S, 10.0, True, meta)

    def e(dtype, *shape):
        return torch.empty(shape or (B,), dtype=dtype, device=meta)
    dmo = downmix.DownmixOut(samples=e(torch.complex64, B, 400),
                             n_samples=e(torch.int32), ok=e(torch.bool),
                             direction=e(torch.int32),
                             start_dec=e(torch.int32),
                             fine_offset=e(torch.float32),
                             uw_corr=e(torch.float32))
    rows = exp_demod_tail.two_launches(
        Fake(), dm, e(torch.complex64, B, S), e(torch.bool, B, S),
        e(torch.float32), dmo, 2 * S + 6, True)
    W = pipeline.row_words(2 * S + 6, True)
    assert rows.shape == (B, W) and cands[1][1] is old
    (d0, a0), (d1, a1) = calls
    assert d0 == d1 == meta and a0[:3] == (0, B, S) and a1[:3] == (1, B, 2 * S)
    assert (a0[4], a0[6], a0[8]) == (13, 1, 3)
    assert list(a0[5]) == [demod.UW_MAX_ERRORS]
    assert (a1[4], a1[6], a1[8]) == (14, 3, 0)
    assert list(a1[5]) == [2 * S + 6, 1, W]


def test_exp_demod_tail_small_on_cpu(capsys):
    assert exp_demod_tail.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    for mode in ("gardner", "no_gardner"):
        assert f"small 12 x 40 {mode}:" in out
    assert out.count("bit-equal True") == 2
    # on the CPU the wrappers are the twins: no launch
    assert '"launches": 0' in out and '"library_ms": null' in out


def test_exp_demod_tail_inputs_have_the_edges():
    """`inputs` keeps exp_demod's first five lengths and puts the edge
    rows from row 5 on, as many as the batch holds."""
    x, n, d = exp_demod_tail.inputs(16, 400, 10.0, seed=3)
    ex, en, ed = exp_demod_tail.edge_rows(400, 10.0, seed=4)
    assert list(n[:5]) == [0, 3, 4, 400, 1]
    np.testing.assert_array_equal(x[5:12], ex)
    np.testing.assert_array_equal(n[5:12], en)
    edges = dict(zip(exp_demod_tail.EDGES, range(5, 12)))
    assert n[edges["zero"]] == 0 and n[edges["short"]] == 80
    assert not x[edges["short"], 80:].any()
    r = edges["drop"]
    assert np.abs(x[r, 200:]).max() < np.abs(x[r, :200]).max() / 8
    z = x[edges["signed_zero"]].view(np.float32)
    assert np.signbit(z[z == 0]).any() and not np.signbit(z[z == 0]).all()
    # a batch of 7 holds two edge rows; one of 3 none
    x7, n7, _ = exp_demod_tail.inputs(7, 400, 10.0, seed=3)
    np.testing.assert_array_equal(x7[5:], ex[:2])
    assert len(exp_demod_tail.inputs(3, 400, 10.0, seed=3)[1]) == 3


def test_exp_demod_tail_bound_counts_the_work():
    """`decide`: the valid flags up to the trim (the row where none), the
    symbols up to the larger of that and the unique word, the directions
    and tables read; five fields, the bits and LLRs written. `pack`: the
    bits, LLRs and eleven fields read, the rows written."""
    from iridium_tpu_torch.runtime import pipeline
    sh = dict(exp_demod_tail.SMALL)
    c = exp_demod_tail.case(sh, True, torch.device("cpu"), seed=8)
    args = c["args"]
    want = c["dm"].decide_plain(*args)
    B, S = sh["B"], sh["S"]
    b = exp_demod_tail.bound(args, want, 2 * S, True)
    n_sym = args[1].sum(1)
    actual = want.n_symbols.long()
    trimmed = actual < n_sym
    assert bool(trimmed.any())
    scan = torch.where(trimmed, actual + 3, S)
    sym = torch.clamp(torch.maximum(torch.where(trimmed, actual + 3, n_sym),
                                    torch.tensor(12)), max=S)
    st = b["launches"]
    assert st["decide"]["bytes"] == (int(scan.sum()) + 8 * int(sym.sum())
                                     + 4 * B + 16 * 12 + 32 + 17 * B
                                     + 16 * B * S)
    W = pipeline.row_words(2 * S, True)
    assert W == (2 * S + 31) // 32 + 1 + S + 11
    assert st["pack"]["bytes"] == 16 * B * S + 38 * B + 4 * B * W
    assert b["bound_bytes"] == st["decide"]["bytes"] + st["pack"]["bytes"]
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == "bytes"


def test_exp_demod_tail_swaps_the_twins_in_and_back():
    from iridium_tpu_torch.dsp import demod
    from iridium_tpu_torch.runtime import pipeline
    kernel = pipeline.decide_pack
    decide, pack = demod.Demod.decide, pipeline.pack_outputs
    with exp_demod_tail.plain_in_place():
        assert pipeline.decide_pack is pipeline.decide_pack_plain
    assert pipeline.decide_pack is kernel
    assert (demod.Demod.decide, pipeline.pack_outputs) == (decide, pack)


def test_exp_demod_shapes_inputs_and_bound():
    """The three 10 MHz class batches (batch, frame cap, symbols) from the
    pipeline; inputs with the edge lengths and zeros from each length on;
    the bound counts the samples below each length once (Gardner) or the
    S strided samples (--no-gardner), and the outputs once."""
    got = {s["shape"]: (s["B"], s["L"], s["S"], s["sps"])
           for s in exp_demod.class_shapes()}
    assert got == {"small_normal": (1024, 1918, 205, 10.0),
                   "small_simplex": (96, 4440, 471, 10.0),
                   "large": (48, 4440, 471, 10.0)}
    x, n, direction = exp_demod.inputs(20, 400, 10.0, seed=5)
    assert x.shape == (20, 400) and x.dtype == np.complex64
    assert list(n[:5]) == [0, 3, 4, 400, 1] and n.min() >= 0
    assert n.max() <= 400 and set(direction) <= {0, 1}
    for row, k in zip(x, n):
        assert not row[k:].any() and (k < 8 or row[:k].any())
    nt = torch.from_numpy(n)
    b, by, n_bytes = exp_demod.bound(nt, 20, 400, 40, True)
    assert n_bytes == 8 * int(n.sum()) + 8 * 20 + 9 * 20 * 40 + 4 * 20
    assert by == "bytes" and b == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert exp_demod.bound(nt, 20, 400, 40, False)[2] == (
        8 * 20 * 40 + 8 * 20 + 9 * 20 * 40 + 4 * 20)


def test_exp_demod_checks_catch_a_parting_burst():
    """compare_loop passes equal outputs and names the burst and symbol
    where one parts; beyond 1e-4 of the peak, or with other valid flags,
    it raises. compare_demod raises on a differing integer field."""
    from iridium_tpu_torch.dsp import demod
    x, n, direction = (torch.from_numpy(v) for v in
                       exp_demod.inputs(6, 400, 10.0, seed=6))
    want = demod.loop_plain(x, n, 10.0, 40, True)
    assert exp_demod.compare_loop(want, want)["n_parted"] == 0
    out = want[0].clone()
    out[3, 17] += 1e-6 * out[3].abs().max()
    res = exp_demod.compare_loop((out, want[1], want[2]), want)
    assert res["parted"] == [[3, 17]] and not res["out_bit_equal"]
    out[3, 17] += 1e-3 * out[3].abs().max()
    with pytest.raises(AssertionError, match="out"):
        exp_demod.compare_loop((out, want[1], want[2]), want)
    valid = want[1].clone()
    valid[2, 0] = ~valid[2, 0]
    with pytest.raises(AssertionError, match="valid"):
        exp_demod.compare_loop((want[0], valid, want[2]), want)
    dm = demod.Demod(40, 10.0)
    d = dm.decide(*want, direction)
    assert exp_demod.compare_demod(d, d)["llr_max_abs_err"] == 0.0
    with pytest.raises(AssertionError, match="bits"):
        exp_demod.compare_demod(d._replace(bits=1 - d.bits), d)


def test_exp_demod_reports_bit_equality_and_first_diff():
    """compare_loop's `bit_equal` and `first_diff` (the first symbol where
    any burst parts), and the wideband decodes' batches."""
    from iridium_tpu_torch.dsp import demod
    x, n, _ = (torch.from_numpy(v) for v in
               exp_demod.inputs(6, 400, 10.0, seed=8))
    want = demod.loop_plain(x, n, 10.0, 40, True)
    res = exp_demod.compare_loop(want, want)
    assert res["bit_equal"] and res["first_diff"] == -1
    out = torch.view_as_real(want[0].clone())
    for b, t in ((5, 30), (1, 12)):       # one ulp of a real part
        out[b, t, 0] = torch.nextafter(out[b, t, 0], torch.tensor(np.inf))
    out = torch.view_as_complex(out)
    res = exp_demod.compare_loop((out, want[1], want[2]), want)
    assert not res["bit_equal"] and res["first_diff"] == 12
    assert res["parted"] == [[1, 12], [5, 30]]
    total = want[2].clone()
    total[0] += 1e-7
    assert not exp_demod.compare_loop((want[0], want[1], total),
                                      want)["bit_equal"]
    # a probe's output is compared, not held to the limits
    out[1, 12] += 1.0
    assert exp_demod.compare_loop((out, want[1], want[2]), want,
                                  check=False)["n_parted"] == 2
    assert exp_demod.decode_shapes(10.0) == exp_demod.class_shapes()


ONE_THREAD_ENTRY = '''extern "C" int demod_loop(const float2* x, long long L,
                          const long long* n_samp, int B, int S, float sps,
                          float half, int isps, int gardner, float2* out,
                          unsigned char* valid, float* total,
                          cudaStream_t stream) {
  return 0;
}
'''


def test_exp_demod_adapts_an_unplanned_entry():
    """A source whose entry takes no plan (the one-thread design) gets an
    entry
    with the package's argument list that drops it; the package's own
    source is left as it is, and the probes refuse a source that is not
    the one-thread design."""
    got = exp_demod.adapted(ONE_THREAD_ENTRY)
    assert 'extern "C" int demod_loop_unplanned(' in got
    head = got[got.index('extern "C" int demod_loop(const'):]
    assert "int ring, int chunk, int threads" in head
    assert "demod_loop_unplanned(x, L, n_samp, B, S, sps, half" in head
    package = _kernels.DEMOD_LOOP.source.read_text()
    assert exp_demod.adapted(package) == package
    for name, edit in exp_demod.PROBES.items():
        with pytest.raises(ValueError, match="one-thread"):
            edit(package)


PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112demod_kernelILb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112demod_kernelILb1EEEvNS_4ArgsE
    32 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 16 barriers, 32 bytes cumulative stack size
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_114gardner_kernelEPK6float2xPKxiiffPS0_PhPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, 416 bytes cmem[0]
"""


def test_exp_demod_ptxas_summary(tmp_path):
    class Built:
        def ptxas_path(self):
            path = tmp_path / "k.ptxas"
            path.write_text(PTXAS)
            return path
    got = exp_demod.ptxas_summary(Built())
    assert got == {
        "demod_kernel<1>": dict(stack_frame=32, spill_stores=4,
                                spill_loads=8, registers=48),
        "gardner_kernel": dict(stack_frame=0, spill_stores=0,
                               spill_loads=0, registers=44)}


def _sass(body: str, name: str) -> str:
    lines = [f"\t\tFunction : {name}"]
    for i, ins in enumerate(body.strip().splitlines()):
        lines.append(f"        /*{16 * i:04x}*/  {ins.strip()} ;"
                     "   /* 0x000000000000000000 */")
    return "\n".join(lines) + "\n"


# a PLL-like loop: a special-function op, a short slow path around a call
# (taken: skipped), and a timing-like loop with a conversion
PLL_LOOP = """
MOV R9, RZ
FMUL R2, R9, R3
MUFU.RCP R4, R2
FCHK P0, R2, R3
@!P0 BRA 0x0080
MOV R20, 0x70
CALL.REL.NOINC 0x0200
MOV R4, R23
FFMA R9, R4, R9, R2
ISETP.NE.AND P1, PT, R7, RZ, PT
@P1 BRA 0x0010
EXIT
"""
TIMING_LOOP = """
MOV R5, RZ
F2I.NTZ R6, R5
I2FP.F32.S32 R7, R6
LDS.64 R10, [R6]
FADD R5, R10, R7
@P2 BRA 0x0010
EXIT
"""


def test_sass_chain_walks_the_loop_chains():
    """The SASS parser finds each loop, skips a short slow path around a
    call, and counts the loop-carried chain with the given latencies; the
    demod loop's step loops are named by their MUFU and F2I."""
    from iridium_tpu_torch.tools import sass_chain
    lat = dict(fadd=4.0, fmul=4.0, ffma=4.0, fmnmx=4.0, fsetp_fsel=4.0,
               mufu=16.0, f2i_i2f=12.0, iadd=2.0, imad=4.0, lop=4.0,
               shf=4.0, imnmx=4.0, isetp_sel=4.0, lds=24.0, ldg=32.0,
               clock_ghz=2.0)
    sass = (_sass(PLL_LOOP, "_ZN12_GLOBAL__N_112demod_kernelILb0EEEvv")
            + _sass(TIMING_LOOP,
                    "_ZN12_GLOBAL__N_114timing_kernelEv"))
    fns = sass_chain.functions(sass)
    pll = next(v for k, v in fns.items() if "demod" in k)
    assert pll[4]["op"] == "BRA" and pll[4]["guard"] == "@!P0"
    assert sass_chain.loops(pll) == [(1, 10)]
    dests, srcs = sass_chain.operands(pll[3])
    assert dests == ["P0"] and srcs == ["R2", "R3"]
    # R9 -> FMUL -> MUFU -> FFMA -> R9: 4 + 16 + 4 cycles, the call
    # skipped (else R4 would come from the MOV)
    assert sass_chain.chain_cycles(pll, 1, 10, lat) == pytest.approx(24.0)
    got = sass_chain.step_chains(sass, lat)
    assert got["demod_kernel<0>"]["pll"] == pytest.approx(24.0)
    assert got["demod_kernel<0>"]["step_ns"] == pytest.approx(12.0)
    # R5 -> F2I -> I2F -> FADD, and LDS from the F2I: 12 + 24 + 4
    assert got["timing_kernel"]["timing"] == pytest.approx(40.0)
    assert "pll" not in got["timing_kernel"]


def test_exp_fast_small_on_cpu(capsys):
    assert exp_fast.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "small 64 x 1024:" in out and '"bit_equal": true' in out
    # on the CPU the wrapper is the twin: no launch
    assert '"kernel_launches": 0' in out
    for bad in (["--small", "--source", "x.cu"], ["--shapes", "10mhz,nope"],
                ["--small", "--reps", "0"]):
        with pytest.raises(SystemExit):
            exp_fast.main(["--device", "cpu"] + bad)


def test_exp_fast_cases_bound_and_comparison():
    from iridium_tpu_torch.dsp import detect_fast
    from iridium_tpu_torch.dsp import state as st
    cpu = torch.device("cpu")
    edge = exp_fast.case("edge", cpu)
    assert tuple(edge.mag2.shape) == (256, 8192)
    assert detect_fast.active_frames(edge.p, edge.n_valid) == 252
    local = exp_fast.case("local", cpu)
    assert local.FL == 2114 == local.mag2.shape[1]
    assert local.rng == dict(bin_lo=2015, own_lo=2048, own_hi=4096)
    assert local.id_stride == 4 and int(local.state.burst_id) == 10
    # bytes bound: 252 rows, the state read and written once
    p = edge.p
    state = 4 * 64 * 8192 + 29 * 8192 + 28 * 64 + 36
    ms, by = exp_fast.bound(edge)
    assert by == "bytes"
    assert ms == pytest.approx((4 * 252 * 8192 + 2 * state) / 3.35e12 * 1e3)
    with pytest.raises(ValueError):
        exp_fast.case("nope", cpu)
    # the split's shapes: binshard's ranges of the block
    c = exp_fast.split_case("split_local", cpu)
    (m, s0, rng), = c.ranges
    assert torch.equal(m, local.mag2) and rng == local.rng
    assert (c.FL, c.id_stride, int(s0.burst_id)) == (2114, 4, 10)
    c = exp_fast.split_case("split1", cpu)
    assert c.FL == 8258 and c.ranges[0][2] == dict(bin_lo=-33, own_lo=0,
                                                   own_hi=8192)
    lay = detect_fast.plan(c.p, c.FL)
    assert (lay.blocks, lay.clusters) == (2, 2)
    c = exp_fast.split_case("split1_1mhz", cpu)
    assert c.FL == 1106 and c.ranges[0][2] == dict(bin_lo=-41, own_lo=0,
                                                   own_hi=1024)
    lay = detect_fast.plan(c.p, c.FL)
    assert (lay.blocks, lay.bpt, c.id_stride) == (1, 2, 1)
    c = exp_fast.split_case("lockstep4", cpu)
    assert [r for _, _, r in c.ranges] == [
        dict(bin_lo=256 * k - 41, own_lo=256 * k, own_hi=256 * (k + 1))
        for k in range(4)]
    assert c.FL == 338 and c.n_valid == c.p.block_samples
    assert exp_fast.bound(c)[0] == pytest.approx(
        4 * exp_fast.bound(exp_fast.Case("one", c.p, *c.ranges[0][:2],
                                         c.n_valid, c.FL))[0])
    with pytest.raises(ValueError):
        exp_fast.split_case("nope", cpu)
    with pytest.raises(SystemExit):
        exp_fast.main(["--device", "cpu", "--shapes", "lockstep4"])
    # the comparison: bit-equal, a dB ulp reported, anything else raised
    a = st.init_state(p, cpu)
    a.a_noise.fill_(-120.0)
    assert exp_fast.compare_bits(a, a.clone())["first_diff"] is None
    b = a.clone()
    b.a_noise[5] = torch.nextafter(b.a_noise[5], torch.tensor(0.0))
    r = exp_fast.compare_bits(a, b)
    assert r["first_diff"] == ["a_noise", 5] and not r["db_bit_equal"]
    b = a.clone()
    b.mask_count[7] = 1
    with pytest.raises(AssertionError, match="mask_count"):
        exp_fast.compare_bits(b, a)
