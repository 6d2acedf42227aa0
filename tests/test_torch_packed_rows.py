"""The port's packed output rows (iridium_tpu_torch/runtime/pipeline.py
pack_outputs/unpack_outputs), with and without LLRs, against the JAX
package's on the same demod outputs. (tests/test_torch_pipeline.py
holds the LLRs of whole decodes against the JAX pipeline's.)

Tolerances: packed rows from the same demod outputs are bit-equal but
for the LLR quanta, which agree within one (XLA may round a half-quantum
tie the other way); each unpacked LLR is within half a quantum (the
burst's max LLR / 65535) of its f32 value, up to f32 rounding.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu.runtime import pipeline as jpl  # noqa: E402
from iridium_tpu_torch.runtime import pipeline as pl  # noqa: E402


def demod_outputs(seed, B, S):
    """Random demod/downmix outputs of one batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    llr = rng.uniform(0.0, 3.0, (B, 2 * S)).astype(np.float32)
    llr[0] = 0.0                              # an all-zero row: scale 0
    llr[1, ::7] = 0.0
    return dict(
        bits=rng.integers(0, 2, (B, 2 * S)).astype(np.int32), llr=llr,
        level=rng.uniform(0, 1, B).astype(np.float32),
        total_phase=rng.normal(0, 3, B).astype(np.float32),
        dd_ok=rng.integers(0, 2, B).astype(bool),
        n_symbols=rng.integers(0, S, B).astype(np.int32),
        confidence=rng.integers(0, 101, B).astype(np.int32),
        direction=rng.integers(0, 2, B).astype(np.int32),
        fine_offset=rng.normal(0, 0.01, B).astype(np.float32),
        uw_corr=rng.uniform(0, 1, B).astype(np.float32),
        dm_ok=rng.integers(0, 2, B).astype(bool),
        start_dec=rng.integers(0, 5000, B).astype(np.int32),
        n_samples=rng.integers(0, 5000, B).astype(np.int32))


def split(o, asarray):
    dm = types.SimpleNamespace(
        fine_offset=asarray(o["fine_offset"]), uw_corr=asarray(o["uw_corr"]),
        ok=asarray(o["dm_ok"]), start_dec=asarray(o["start_dec"]),
        n_samples=asarray(o["n_samples"]))
    dd = types.SimpleNamespace(
        bits=asarray(o["bits"]), llr=asarray(o["llr"]),
        level=asarray(o["level"]), total_phase=asarray(o["total_phase"]),
        ok=asarray(o["dd_ok"]), n_symbols=asarray(o["n_symbols"]),
        confidence=asarray(o["confidence"]),
        direction=asarray(o["direction"]))
    return dm, dd


@pytest.mark.parametrize("want_llr,S,pad", [(True, 205, 0), (True, 7, 3),
                                            (False, 205, 0), (False, 7, 3)])
def test_packed_rows_match_jax(want_llr, S, pad):
    o = demod_outputs(S, 6, S)
    s2_pad = 2 * (S + pad)
    got = pl.pack_outputs(*split(o, torch.from_numpy), s2_pad,
                          want_llr).numpy()
    want = np.asarray(jpl.pack_outputs(*split(o, jnp.asarray), want_llr,
                                       s2_pad))
    W = pl.packed_width(S + pad, want_llr)
    assert got.shape == want.shape == (6, W)
    assert W == jpl.packed_width(S + pad, want_llr)
    if not want_llr:
        # the RAW path's row width is unchanged: bit words and metadata
        assert W == (2 * (S + pad) + 31) // 32 + 11
    u = pl.unpack_outputs(got, S + pad, want_llr)
    w = jpl.unpack_outputs(want, S + pad, want_llr)
    assert u.keys() == w.keys()
    for k in u:
        if k != "llr":
            np.testing.assert_array_equal(u[k], w[k])
    if want_llr:
        # XLA may round llr * (65535 / scale) a last bit differently
        # at a half-quantum tie: the quanta agree within one, the
        # bit-cast scale exactly
        NW = (s2_pad + 31) // 32
        np.testing.assert_array_equal(got[:, NW], want[:, NW])
        scale = o["llr"].max(1, keepdims=True)
        q = scale / np.float32(65535)
        ulp = 4 * np.finfo(np.float32).eps * scale    # f32 rounding
        assert (np.abs(u["llr"] - w["llr"]) <= q + ulp).all()
        assert (np.abs(u["llr"][:, :2 * S] - o["llr"]) <= q / 2 + ulp).all()
        assert not u["llr"][:, 2 * S:].any()
    else:
        np.testing.assert_array_equal(got, want)
