"""The demodulator's tail (iridium_tpu_torch/dsp/demod.py `Demod.decide`,
its twin `Demod.decide_plain`) and the packing of the output rows
(runtime/pipeline.py `pack_outputs`, its twin `pack_plain`) against the
JAX package's (iridium_tpu/dsp/demod.py `make_demod(S, sps, use_gardner,
gather_mode="gather")` under `jax.vmap`; runtime/pipeline.py
`pack_outputs`), on rows built to reach every branch of the tail
(`tools/exp_demod_tail.py` `edge_rows`): a 20x magnitude drop mid-burst
(the end-of-frame trim), 8 symbols (under the unique word: both errors
999), noise alone (both checks fail), a clean UL burst, a clean DL burst
(with UW tables within UW_MAX_ERRORS of each other: both hard checks
pass and the direction given is kept), a zero-length row, tiny symbols
with +-0 components; beside `exp_demod.inputs`' bursts. Both modes, one
JAX compile per mode and one for the changed tables.

Tolerances are those of tests/test_torch_downmix_demod.py: ok, direction,
n_symbols, confidence and bits exact; level, total_phase and LLRs within
rtol 1e-4, atol 1e-5 (the two packages round their complex arithmetic and
their sums in different places; the twin sums in the kernel's order,
`demod.warp_sum`). Packed rows: the words equal but for the LLR quanta,
which agree within one (tests/test_torch_packed_rows.py's reason).

On a CPU tensor `decide`, `pack_outputs` and `decide_pack` are the twins
and never reach the kernel; on any other device `decide_pack` launches it
(checked here on the meta device with the launch recorded) and never runs
the twins, and `decide` and `pack_outputs`, which have no launch of their
own, raise. The kernel is held to the twins on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu import iridium as jiridium  # noqa: E402
from iridium_tpu.dsp import demod as jdemod  # noqa: E402
from iridium_tpu.runtime import pipeline as jpl  # noqa: E402
from iridium_tpu_torch import _kernels, iridium  # noqa: E402
from iridium_tpu_torch.dsp import demod, downmix  # noqa: E402
from iridium_tpu_torch.runtime import pipeline as pl  # noqa: E402
from iridium_tpu_torch.tools import exp_demod_tail as tool  # noqa: E402

B, L, S, SPS = 16, 400, 40, 10.0
AT = 5                       # the edge rows' first row (tool.EDGE_AT)
ROW = {name: AT + i for i, name in enumerate(tool.EDGES)}
INT_FIELDS = ("ok", "direction", "n_symbols", "confidence", "bits")
FLOAT_FIELDS = ("level", "total_phase", "llr")
# UL's unique word within UW_MAX_ERRORS of DL's: DL's with two symbols
# moved by one quadrant
NEAR_UL = (1, 2, 2, 2, 2, 0, 0, 0, 2, 0, 0, 1)


def _jax_demod(use_gardner, x, n, direction):
    f = jax.vmap(jdemod.make_demod(S, SPS, use_gardner,
                                   gather_mode="gather"))
    want = f(jnp.asarray(x), jnp.asarray(n.astype(np.int32)),
             jnp.asarray(direction))
    return jax.tree_util.tree_map(np.asarray, want)


@pytest.fixture(scope="module", params=[True, False],
                ids=["gardner", "no_gardner"])
def case(request):
    use_gardner = request.param
    x, n, direction = tool.inputs(B, L, SPS, seed=51, at=AT)
    return dict(use_gardner=use_gardner, x=x, n=n, direction=direction,
                want=_jax_demod(use_gardner, x, n, direction))


def _port(use_gardner, x, n, direction, uw_ul=None):
    dm = demod.Demod(S, SPS, use_gardner)
    if uw_ul is not None:
        dm.uw_ul = torch.tensor(uw_ul)
    xt, nt = torch.from_numpy(x), torch.from_numpy(n)
    loop_out = demod.loop_plain(xt, nt, SPS, S, use_gardner)
    return dm, loop_out, dm.decide_plain(*loop_out,
                                         torch.from_numpy(direction))


def _assert_fields(got, want, rows=slice(None)):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name)[rows],
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name)[rows], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_edge_rows_match_jax(case):
    _, _, got = _port(case["use_gardner"], case["x"], case["n"],
                      case["direction"])
    _assert_fields(got, case["want"])
    # Demod (the wrapper) on CPU tensors is the twin
    dm = demod.Demod(S, SPS, case["use_gardner"])
    out = dm(torch.from_numpy(case["x"]), torch.from_numpy(case["n"]).int(),
             torch.from_numpy(case["direction"]))
    for a, b in zip(out, got):
        assert torch.equal(a, b)


def test_edge_rows_reach_every_branch(case):
    """Each edge row takes its branch in the JAX package's tail."""
    w = case["want"]
    _, (_, valid, _), got = _port(case["use_gardner"], case["x"],
                                  case["n"], case["direction"])
    n_sym = valid.sum(1).numpy()
    U = iridium.UW_LENGTH
    r = ROW["drop"]
    assert w.ok[r] and U <= w.n_symbols[r] < n_sym[r] - 3
    r = ROW["short"]
    assert 0 < w.n_symbols[r] < U and not w.ok[r]
    # both errors 999: DL is chosen
    assert w.direction[r] == demod.DIR_DL
    assert not w.ok[ROW["noise"]] and w.n_symbols[ROW["noise"]] >= U
    r = ROW["ul"]
    assert w.ok[r] and w.direction[r] == demod.DIR_UL
    r = ROW["dl"]
    assert w.ok[r] and w.direction[r] == demod.DIR_DL
    assert w.n_symbols[ROW["zero"]] == 0 and not w.ok[ROW["zero"]]
    assert w.level[ROW["zero"]] == 0 and not w.llr[ROW["zero"]].any()
    # confidence and level over the trimmed symbols only
    assert 0 < w.confidence[ROW["drop"]] <= 100


def test_signed_zero_symbols_reach_the_tail():
    """--no-gardner hands the tiny symbols to the tail as they are: a
    component of each is +0 or -0, the other tiny or zero."""
    x, n, direction = tool.edge_rows(L, SPS, seed=3)
    r = tool.EDGES.index("signed_zero")
    _, (out, valid, _), _ = _port(False, x[r:r + 1], n[r:r + 1],
                                  direction[r:r + 1])
    # the pattern's first 7 symbols have a zero part, the 8th none
    re, im = out.real[0, :7], out.imag[0, :7]
    zero = (re == 0) | (im == 0)
    assert bool(zero.all()) and bool(valid[0, :8].all())
    # -0 components among them, and both hard decisions at a zero part
    assert bool(torch.signbit(re[re == 0]).any())
    assert bool(torch.signbit(im[im == 0]).any())


def test_both_hard_checks_keep_the_direction(monkeypatch):
    """With UL's unique word within UW_MAX_ERRORS of DL's, a clean DL
    burst passes both hard checks and keeps the direction it was given
    (both values), in both packages."""
    x, n, direction = tool.edge_rows(L, SPS, seed=5)
    r = tool.EDGES.index("dl")
    x, n = np.repeat(x[r:r + 1], 2, 0), np.repeat(n[r:r + 1], 2, 0)
    direction = np.array([0, 1], np.int32)
    monkeypatch.setattr(jiridium, "UW_UL", NEAR_UL)
    want = _jax_demod(True, x, n, direction)
    _, _, got = _port(True, x, n, direction, uw_ul=NEAR_UL)
    _assert_fields(got, want)
    assert list(want.direction) == [0, 1] and want.ok.all()


@pytest.mark.parametrize("name", tool.EDGES)
def test_each_edge_row_alone_matches_jax(case, name):
    r = ROW[name]
    rows = slice(r, r + 1)
    _, _, got = _port(case["use_gardner"], case["x"][rows],
                      case["n"][rows], case["direction"][rows])
    _assert_fields(got, case["want"], rows)


def test_warp_sum_takes_the_kernels_order():
    """`warp_sum` is a lane's column summed chunk by chunk, then the
    butterfly (lane l adds lane l + h), bit for bit, in f32; within f32
    rounding of the plain sum."""
    rng = np.random.default_rng(7)
    for n in (1, 12, 31, 32, 33, 205, 471):
        x = rng.uniform(0, 2, (3, n)).astype(np.float32)
        C = -(-n // 32)
        pad = np.zeros((3, 32 * C), np.float32)
        pad[:, :n] = x
        acc = pad[:, :32].copy()
        for c in range(1, C):
            acc = (acc + pad[:, 32 * c:32 * c + 32]).astype(np.float32)
        for h in (16, 8, 4, 2, 1):
            acc = (acc[:, :h] + acc[:, h:2 * h]).astype(np.float32)
        got = demod.warp_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, acc[:, 0])
        np.testing.assert_allclose(got, x.sum(1, dtype=np.float64),
                                   rtol=1e-5)


def _pack_inputs(case):
    dm, _, dd = _port(case["use_gardner"], case["x"], case["n"],
                      case["direction"])
    f = tool.pack_fields(B, torch.device("cpu"), seed=9)
    dmo = downmix.DownmixOut(samples=torch.from_numpy(case["x"]),
                             n_samples=f["n_samples"], ok=f["ok"],
                             direction=torch.from_numpy(case["direction"]),
                             start_dec=f["start_dec"],
                             fine_offset=f["fine_offset"],
                             uw_corr=f["uw_corr"])
    return dmo, dd


@pytest.mark.parametrize("want_llr,pad", [(True, 0), (False, 0), (True, 7),
                                          (False, 40)])
def test_pack_plain_matches_jax(case, want_llr, pad):
    """The twin's rows of the demodulator's real outputs against the JAX
    package's packing of the same fields, with s2_pad = 2S and above it:
    every word equal but the LLR quanta, within one."""
    dmo, dd = _pack_inputs(case)
    s2_pad = 2 * S + pad
    got = pl.pack_plain(dmo, dd, s2_pad, want_llr).numpy()
    assert torch.equal(pl.pack_outputs(dmo, dd, s2_pad, want_llr),
                       torch.from_numpy(got))
    jdm = jdemod.DemodOut(**{k: jnp.asarray(getattr(dd, k).numpy())
                             for k in jdemod.DemodOut._fields})

    class JDm:
        fine_offset = jnp.asarray(dmo.fine_offset.numpy())
        uw_corr = jnp.asarray(dmo.uw_corr.numpy())
        ok = jnp.asarray(dmo.ok.numpy())
        start_dec = jnp.asarray(dmo.start_dec.numpy())
        n_samples = jnp.asarray(dmo.n_samples.numpy())
    want = np.asarray(jpl.pack_outputs(JDm, jdm, want_llr, s2_pad))
    assert got.shape == want.shape == (B, pl.row_words(s2_pad, want_llr))
    NW = (s2_pad + 31) // 32
    if want_llr:
        NL = (s2_pad + 1) // 2
        np.testing.assert_array_equal(got[:, :NW + 1], want[:, :NW + 1])
        q = got[:, NW + 1:NW + 1 + NL].view(np.uint16).astype(np.int64)
        wq = want[:, NW + 1:NW + 1 + NL].view(np.uint16).astype(np.int64)
        assert (np.abs(q - wq) <= 1).all()
        np.testing.assert_array_equal(got[:, NW + 1 + NL:],
                                      want[:, NW + 1 + NL:])
    else:
        np.testing.assert_array_equal(got, want)


def test_tail_on_cpu_never_reaches_the_kernel(monkeypatch, case):
    def refuse(*args):
        raise AssertionError("a CPU tensor launched the kernel")
    monkeypatch.setattr(_kernels.DEMOD_TAIL, "launch", refuse)
    dmo, dd = _pack_inputs(case)
    dm, loop_out, want = _port(case["use_gardner"], case["x"], case["n"],
                               case["direction"])
    got = dm.decide(*loop_out, torch.from_numpy(case["direction"]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(pl.pack_outputs(dmo, dd, 2 * S, True),
                       pl.pack_plain(dmo, dd, 2 * S, True))


def _meta_demod_out(Bm, meta):
    def e(dtype, *shape):
        return torch.empty(shape or (Bm,), dtype=dtype, device=meta)
    dd = demod.DemodOut(ok=e(torch.bool), direction=e(torch.int32),
                        n_symbols=e(torch.int32), confidence=e(torch.int32),
                        level=e(torch.float32), total_phase=e(torch.float32),
                        bits=e(torch.int32, Bm, 2 * S),
                        llr=e(torch.float32, Bm, 2 * S))
    dmo = downmix.DownmixOut(samples=e(torch.complex64, Bm, L),
                             n_samples=e(torch.int32), ok=e(torch.bool),
                             direction=e(torch.int32),
                             start_dec=e(torch.int32),
                             fine_offset=e(torch.float32),
                             uw_corr=e(torch.float32))
    return dmo, dd


def test_decide_and_pack_outputs_take_cpu_tensors_only(monkeypatch):
    """`Demod.decide`, `Demod.__call__` and `pack_outputs` on tensors that
    are not on the CPU raise, and neither launch the kernel nor run the
    twins: on the card the class batches decide and pack in one launch
    (`decide_pack`)."""
    def refuse(*args):
        raise AssertionError("a launch or a twin ran for a non-CPU tensor")
    monkeypatch.setattr(_kernels.DEMOD_TAIL, "launch", refuse)
    monkeypatch.setattr(demod.Demod, "decide_plain", refuse)
    monkeypatch.setattr(pl, "pack_plain", refuse)
    monkeypatch.setattr(demod, "loop", lambda *a: (out, valid, total))
    meta = torch.device("meta")
    Bm = 6
    dm = demod.Demod(S, SPS, True, meta)
    out = torch.empty((Bm, S), dtype=torch.complex64, device=meta)
    valid = torch.empty((Bm, S), dtype=torch.bool, device=meta)
    total = torch.empty(Bm, dtype=torch.float32, device=meta)
    direction = torch.empty(Bm, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="decide_pack"):
        dm.decide(out, valid, total, direction)
    with pytest.raises(ValueError, match="decide_pack"):
        dm(out, total.int(), direction)
    dmo, dd = _meta_demod_out(Bm, meta)
    with pytest.raises(ValueError, match="decide_pack"):
        pl.pack_outputs(dmo, dd, 2 * S, True)


# (B, S) of every class batch of the 10 MHz, 400 MHz and 1.6 GHz decodes,
# each run in both modes (tools/exp_demod.py `decode_shapes`)
TAIL_BATCHES = [(1024, 205), (96, 471), (48, 471), (32, 205), (24, 471),
                (24, 471), (32, 205), (24, 471), (24, 471)]


@pytest.mark.parametrize("B, S", TAIL_BATCHES + [(13, 12), (1, 40)])
def test_tail_plan_gives_every_batch_a_layout(B, S):
    """`decide_pack`'s layout at each class batch (and S = UW_LENGTH): the
    warps a burst hold its chunks of 32 symbols, at most 8 a warp; a block
    of at most 16 warps; shared memory a burst's words times its bursts,
    within 48 KiB (and so within a block's 232,448 bytes)."""
    p = pl.tail_plan(B, S)
    C = -(-S // 32)
    assert p.warps * p.chunks >= C and p.chunks <= pl.TAIL_MAX_CHUNKS
    assert p.chunks == -(-C // p.warps)
    assert p.threads == 32 * p.warps * p.bursts <= 32 * pl.TAIL_MAX_WARPS
    assert p.smem == 4 * p.bursts * (5 * p.warps + 1 + 33 * C)
    assert p.smem <= pl.TAIL_MAX_SMEM <= 232_448
    # more than one warp a burst at S = 471: more blocks than bursts / 4
    if S == 471:
        assert p.warps > 1 and -(-B // p.bursts) > B // 4


def test_tail_plan_refuses_what_the_kernel_does_not_take():
    """More than 8 chunks a warp, no warps or more than 16, a burst past
    16 warps of 8 chunks."""
    for S, warps in ((471, 1), (205, 0), (205, 17), (300, 1)):
        with pytest.raises(ValueError):
            pl.tail_plan(8, S, warps)
    with pytest.raises(ValueError):
        pl.tail_plan(8, 16 * 8 * 32 + 1)
    assert pl.tail_plan(8, 16 * 8 * 32).warps == 16


@pytest.mark.parametrize("want_llr,pad",
                         [(True, 0), (False, 0), (True, 10)])
def test_decide_pack_plain_matches_jax(case, want_llr, pad):
    """The twins composed (`decide_pack_plain`, which `decide_pack` is on a
    CPU tensor) against the JAX package's tail and packing of its own
    demodulator's outputs, unpacked: integer fields and bits exact, level
    and total_phase within rtol 1e-4, atol 1e-5, LLRs within two quanta
    of each one's scale (each side quantises its own f32 LLRs, which
    agree within rtol 1e-4)."""
    dm, loop_out, dd = _port(case["use_gardner"], case["x"], case["n"],
                             case["direction"])
    f = tool.pack_fields(B, torch.device("cpu"), seed=9)
    dmo = downmix.DownmixOut(samples=torch.from_numpy(case["x"]),
                             n_samples=f["n_samples"], ok=f["ok"],
                             direction=torch.from_numpy(case["direction"]),
                             start_dec=f["start_dec"],
                             fine_offset=f["fine_offset"],
                             uw_corr=f["uw_corr"])
    s2_pad = 2 * S + pad
    got = pl.decide_pack(dm, *loop_out, dmo, s2_pad, want_llr)
    assert torch.equal(got, pl.pack_plain(dmo, dd, s2_pad, want_llr))
    w = case["want"]
    jdm = jdemod.DemodOut(**{k: jnp.asarray(getattr(w, k))
                             for k in jdemod.DemodOut._fields})

    class JDm:
        fine_offset = jnp.asarray(dmo.fine_offset.numpy())
        uw_corr = jnp.asarray(dmo.uw_corr.numpy())
        ok = jnp.asarray(dmo.ok.numpy())
        start_dec = jnp.asarray(dmo.start_dec.numpy())
        n_samples = jnp.asarray(dmo.n_samples.numpy())
    want = np.asarray(jpl.pack_outputs(JDm, jdm, want_llr, s2_pad))
    assert got.shape == want.shape
    u = pl.unpack_outputs(got.numpy(), S + pad // 2, want_llr)
    v = pl.unpack_outputs(want, S + pad // 2, want_llr)
    for k in ("dm_ok", "dd_ok", "n_sym", "conf", "direc", "sdec", "bits"):
        np.testing.assert_array_equal(u[k], v[k], err_msg=k)
    for k in ("fine", "level", "total"):
        np.testing.assert_allclose(u[k], v[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    q = np.maximum(w.llr.max(1, initial=0), 1e-30)[:, None] / 65535
    assert (np.abs(u["llr"][:, :2 * S] - v["llr"][:, :2 * S])
            <= 2 * q + 1e-4 * np.abs(v["llr"][:, :2 * S])).all()


def test_decide_pack_elsewhere_launches_the_kernel_only(monkeypatch):
    """Tensors that are not on the CPU go to `decide_pack`'s launch, once,
    with the C entry's counts and `tail_plan`'s layout last, and never to
    the twins; what the kernel cannot take raises."""
    calls = []
    monkeypatch.setattr(_kernels.DEMOD_TAIL, "launch",
                        lambda device, *a: calls.append((device, a)))

    def refuse(*args):
        raise AssertionError("a twin ran for a non-CPU tensor")
    monkeypatch.setattr(demod.Demod, "decide_plain", refuse)
    monkeypatch.setattr(pl, "pack_plain", refuse)
    monkeypatch.setattr(pl, "decide_pack_plain", refuse)
    monkeypatch.setattr(_kernels, "ptr", lambda t: 0)
    meta = torch.device("meta")
    Bm = 6
    dm = demod.Demod(S, SPS, True, meta)
    out = torch.empty((Bm, S), dtype=torch.complex64, device=meta)
    valid = torch.empty((Bm, S), dtype=torch.bool, device=meta)
    total = torch.empty(Bm, dtype=torch.float32, device=meta)
    dmo, _ = _meta_demod_out(Bm, meta)
    rows = pl.decide_pack(dm, out, valid, total, dmo, 2 * S + 6, True)
    W = pl.row_words(2 * S + 6, True)
    assert rows.shape == (Bm, W) and rows.dtype == torch.int32
    (device, args), = calls
    lay = pl.tail_plan(Bm, S)
    assert device == meta and args[:2] == (Bm, S)
    assert (args[3], args[5], args[7]) == (13, 6, 3)
    assert list(args[4]) == [demod.UW_MAX_ERRORS, 2 * S + 6, 1, W,
                             lay.warps, lay.bursts]
    assert list(args[6]) == [demod.MAGNITUDE_DROP, demod.CONFIDENCE_ANGLE,
                             demod.UW_SOFT_THRESHOLD]
    for bad in ((out[:, :S - 1].contiguous(), valid, total, dmo, 2 * S),
                (out, valid, total, dmo, 2 * S - 1),
                (out, valid.int(), total, dmo, 2 * S),
                (out, valid, total, dmo._replace(ok=dmo.ok.int()), 2 * S),
                (out, valid, total, dmo._replace(
                    direction=dmo.direction.long()), 2 * S)):
        with pytest.raises(ValueError):
            pl.decide_pack(dm, *bad, True)
