"""The port's `RAW:` lines (iridium_tpu_torch/output/raw.py
`RawPrinter.format`) against the JAX package's printer, byte for byte,
for every form the frames' `bits` take: the int32 row slices of an
`unpack_outputs` matrix that `build_frames_np` hands over, other integer
dtypes, bool, strided slices, Python lists, values other than 0 and 1,
and the empty bit field of a frame of 12 symbols or fewer.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.output import raw as jraw  # noqa: E402
from iridium_tpu_torch.output import raw  # noqa: E402
from iridium_tpu_torch.runtime import pipeline as pl  # noqa: E402

T0 = 1_700_000_000_123_456_789


def fields(rng, i, n_symbols):
    """A frame's fields other than `bits`."""
    return dict(
        id=int(rng.integers(0, 10**9)),
        timestamp_ns=T0 + i * 8_765_432,
        frequency=float(1_621_000_000 + rng.uniform(-5e6, 5e6)),
        magnitude=float(rng.uniform(0, 40)),
        noise=float(rng.uniform(-99, -40)),
        confidence=int(rng.integers(0, 101)),
        level=float(rng.uniform(0, 1)),
        n_symbols=n_symbols, direction="DL")


def unpacked_bits(seed, B=8, S=186):
    """An `unpack_outputs` bit matrix (B, 2 S) int32, from packed rows."""
    rng = np.random.default_rng(seed)
    pi = rng.integers(-2**31, 2**31, (B, pl.packed_width(S, False)),
                      dtype=np.int64).astype(np.int32)
    return pl.unpack_outputs(pi, S, False)["bits"]


def row_slices(rng, u):
    return [u[i, :int(rng.integers(0, u.shape[1] + 1))]
            for i in range(u.shape[0])]


BIT_FORMS = {
    "int32_rows": row_slices,
    "int64": lambda rng, u: [b.astype(np.int64) for b in row_slices(rng, u)],
    "uint8": lambda rng, u: [b.astype(np.uint8) for b in row_slices(rng, u)],
    "bool": lambda rng, u: [b.astype(bool) for b in row_slices(rng, u)],
    "strided": lambda rng, u: [u[i, ::3] for i in range(u.shape[0])]
    + [u[::-1, 5], u[:, 7]],
    "list": lambda rng, u: [b.tolist() for b in row_slices(rng, u)],
    "not_0_1": lambda rng, u: [
        rng.integers(-3, 4, 300).astype(np.int32),
        np.array([0, 255, 1, 128, 0], np.uint8),
        np.array([2, -1, 0, 7, 0], np.int64),
        [0, 2, -5, 1, 0],
        np.array([0.0, -0.0, 0.5, np.nan, -2.0, 1.0])],
    "empty": lambda rng, u: [u[0, :0], np.zeros(0, np.int32),
                             np.zeros(0, bool), [], u[1:1, 3]],
}


@pytest.mark.parametrize("form", sorted(BIT_FORMS))
def test_raw_line_matches_jax(form):
    rng = np.random.default_rng(sorted(BIT_FORMS).index(form))
    p, jp = raw.RawPrinter(), jraw.RawPrinter()
    bits = BIT_FORMS[form](rng, unpacked_bits(len(form)))
    for i, b in enumerate(bits):
        # a frame of at most 12 symbols has no payload and no bits
        ns = int(rng.integers(0, 13)) if form == "empty" else (
            len(b) // 2 + int(rng.integers(0, 3)))
        f = dict(fields(rng, i, ns), bits=b)
        line = p.format(f)
        assert line == jp.format(f)
        assert line.endswith(" " + "".join("1" if x else "0" for x in b))
    assert p.t0_ns == jp.t0_ns and p.file_info == jp.file_info


@pytest.mark.parametrize("seed", [0, 1])
def test_raw_lines_of_built_frames_match_jax(seed):
    """The frames `build_frames_np` makes from packed rows, as a decode's
    finish hands them over: int32 row slices of the unpacked bits."""
    rng = np.random.default_rng(seed)
    B, S = 12, 186
    dm = types.SimpleNamespace(
        fine_offset=torch.from_numpy(
            rng.normal(0, 0.01, B).astype(np.float32)),
        uw_corr=torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32)),
        ok=torch.ones(B, dtype=torch.bool),
        start_dec=torch.from_numpy(
            rng.integers(0, 5000, B).astype(np.int32)),
        n_samples=torch.from_numpy(
            rng.integers(0, 5000, B).astype(np.int32)))
    n_sym = rng.integers(0, S + 1, B).astype(np.int32)
    n_sym[:3] = [0, 12, 13]
    dd = types.SimpleNamespace(
        bits=torch.from_numpy(rng.integers(0, 2, (B, 2 * S)).astype(np.int32)),
        llr=torch.zeros(B, 2 * S),
        level=torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32)),
        total_phase=torch.from_numpy(
            rng.normal(0, 3, B).astype(np.float32)),
        ok=torch.ones(B, dtype=torch.bool),
        n_symbols=torch.from_numpy(n_sym),
        confidence=torch.from_numpy(
            rng.integers(0, 101, B).astype(np.int32)),
        direction=torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)))
    u = pl.unpack_outputs(pl.pack_outputs(dm, dd, 2 * S, False).numpy(),
                          S, False)
    p = types.SimpleNamespace(fft_size=8192, sample_rate=10_000_000,
                              center_frequency=1_622_000_000.0)
    dmp = types.SimpleNamespace(output_sample_rate=250_000)
    js = rng.permutation(B)
    frames = pl.build_frames_np(
        p, dmp, 101, T0, rng.integers(0, 10**6, B), rng.integers(0, 8192, B),
        rng.uniform(0, 40, B), rng.uniform(-99, -40, B),
        rng.integers(0, 2**33, B), u, js)
    printer, jprinter = raw.RawPrinter("cap"), jraw.RawPrinter("cap")
    for j, f in zip(js, frames):
        assert f["bits"].dtype == np.int32
        np.testing.assert_array_equal(f["bits"],
                                      dd.bits[j, :2 * n_sym[j]].numpy())
        assert printer.format(f) == jprinter.format(f)
