"""The demodulator's symbol loop (iridium_tpu_torch/dsp/demod.py `loop`,
`loop_plain`) against the JAX package's compiled scan
(iridium_tpu/dsp/demod.py `make_demod(S, sps, use_gardner,
gather_mode="gather")` under `jax.vmap`), on the same bursts made from a
numpy seed (`tools/exp_demod.py` `inputs`): lengths 0, 1, 3, 4 and L
beside random ones, bursts that end mid-row, residual CFO, noise, both
modes, and each burst alone (batch 1). One JAX compile per mode.

Tolerances are those of tests/test_torch_downmix_demod.py: ok, direction,
n_symbols, confidence and bits exact; level, total_phase and LLRs within
rtol 1e-4, atol 1e-5 (the two packages' complex arithmetic rounds in
different places).

On a CPU tensor `loop` is `loop_plain` and never reaches the kernel; on any
other device it launches the kernel (checked here on the meta device with
the launch recorded). The kernel itself is held to `loop_plain` on the
card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iridium_tpu.dsp import demod as jdemod  # noqa: E402
from iridium_tpu_torch import _kernels, iridium  # noqa: E402
from iridium_tpu_torch.dsp import demod  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402
from iridium_tpu_torch.tools import exp_demod  # noqa: E402

B, L, S, SPS = 12, 400, 40, 10.0
CFO_ROW = B - 1             # a clean burst with a 200 Hz residual CFO
CFO_HZ = 200.0
INT_FIELDS = ("ok", "direction", "n_symbols", "confidence", "bits")
FLOAT_FIELDS = ("level", "total_phase", "llr")


def _cfo_burst(seed: int) -> np.ndarray:
    bits = np.random.default_rng(seed).integers(0, 2, 100).astype(np.uint8)
    w = synth.modulate(synth.burst_symbols(bits))
    lead = iridium.PREAMBLE_LENGTH_SHORT * 10
    t = np.arange(L)
    return (w[lead:lead + L]
            * np.exp(2j * np.pi * CFO_HZ / 250_000.0 * t)).astype(
                np.complex64)


@pytest.fixture(scope="module", params=[True, False],
                ids=["gardner", "no_gardner"])
def case(request):
    use_gardner = request.param
    x, n, direction = exp_demod.inputs(B, L, SPS, seed=31)
    x[CFO_ROW], n[CFO_ROW] = _cfo_burst(32), L
    want = jax.vmap(jdemod.make_demod(S, SPS, use_gardner,
                                      gather_mode="gather"))(
        jnp.asarray(x), jnp.asarray(n.astype(np.int32)),
        jnp.asarray(direction))
    want = jax.tree_util.tree_map(np.asarray, want)
    return dict(use_gardner=use_gardner, x=x, n=n, direction=direction,
                want=want)


def _port(case, rows):
    dm = demod.Demod(S, SPS, case["use_gardner"])
    return dm(torch.from_numpy(case["x"][rows]),
              torch.from_numpy(case["n"][rows].astype(np.int32)),
              torch.from_numpy(case["direction"][rows]))


def _assert_rows(got, want, rows):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name)[rows],
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name)[rows], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_batch_matches_jax(case):
    rows = np.arange(B)
    _assert_rows(_port(case, rows), case["want"], rows)
    # lengths 0, 3, 4 and 1: Gardner needs a position below n - 3, the
    # strided decimation a sample index below n
    assert list(case["n"][:5]) == [0, 3, 4, L, 1]
    assert list(case["want"].n_symbols[[0, 1, 2, 4]]) == (
        [0, 0, 1, 0] if case["use_gardner"] else [0, 1, 1, 1])


@pytest.mark.parametrize("row", [0, 1, 2, 3, 4, 7, CFO_ROW])
def test_batch_of_one_matches_jax(case, row):
    _assert_rows(_port(case, [row]), case["want"], [row])


def test_pll_tracks_a_residual_cfo(case):
    """The clean 200 Hz burst verifies its UW in both packages, and the
    summed PLL corrections follow the rotation (0.050 rad a symbol)."""
    want = case["want"]
    got = _port(case, np.arange(B))
    assert bool(want.ok[CFO_ROW]) and bool(got.ok[CFO_ROW])
    n_sym = int(want.n_symbols[CFO_ROW])
    per_symbol = 2 * np.pi * CFO_HZ * SPS / 250_000.0
    assert n_sym >= S - 4
    assert 0.7 < abs(float(got.total_phase[CFO_ROW])) / (
        per_symbol * n_sym) < 1.1


def test_loop_on_cpu_never_reaches_the_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor launched the kernel")
    monkeypatch.setattr(_kernels.DEMOD_LOOP, "launch", refuse)
    x, n, direction = exp_demod.inputs(5, L, SPS, seed=33)
    x, n = torch.from_numpy(x), torch.from_numpy(n)
    for use_gardner in (True, False):
        got = demod.loop(x, n, SPS, S, use_gardner)
        want = demod.loop_plain(x, n, SPS, S, use_gardner)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        demod.Demod(S, SPS, use_gardner)(x, n.int(),
                                         torch.from_numpy(direction))


def test_loop_elsewhere_launches_the_kernel_only(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel, with the
    arguments of the C entry point, and never to `loop_plain`."""
    calls = []

    def record(device, *args):
        calls.append((device, args))

    def refuse(*args):
        raise AssertionError("loop_plain ran for a non-CPU tensor")
    monkeypatch.setattr(_kernels.DEMOD_LOOP, "launch", record)
    monkeypatch.setattr(demod, "loop_plain", refuse)
    monkeypatch.setattr(_kernels, "ptr", lambda t: 0)
    meta = torch.device("meta")
    x = torch.empty((6, L), dtype=torch.complex64, device=meta)
    n = torch.empty(6, dtype=torch.int64, device=meta)
    out, valid, total = demod.loop(x, n, 9.75, S, False)
    assert out.shape == (6, S) and out.dtype == torch.complex64
    assert valid.shape == (6, S) and valid.dtype == torch.bool
    assert total.shape == (6,) and total.dtype == torch.float32
    (device, args), = calls
    assert device == meta
    # x, L, n_samp, B, S, sps, sps / 2, round(sps), gardner, out, valid,
    # total
    assert args[1:9] == (L, 0, 6, S, 9.75, 4.875, 10, 0)
    with pytest.raises(ValueError):
        demod.loop(torch.empty((6, 3), dtype=torch.complex64, device=meta),
                   n, SPS, S, True)
    with pytest.raises(ValueError):
        demod.loop(x, n.int(), SPS, S, True)
