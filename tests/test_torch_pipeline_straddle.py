"""The port's offline decode against the JAX package's Pipeline on a
burst that straddles two blocks (test_e2e.py's configuration): the device
tail carries the burst's start into the next block's extraction window.
Held as test_torch_pipeline.py holds its cases (own file so that the two
slow JAX decodes run on separate test workers)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch.io import synth  # noqa: E402

from test_torch_pipeline import decode_both, payload_bits  # noqa: E402

STRADDLE = dict(sample_rate=10_000_000, frames_per_block=256,
                history_size=128, burst_capacity=64, gone_capacity=128,
                max_new_per_frame=8)


def test_block_straddling_burst_matches_jax():
    bits = payload_bits(200, seed=9)
    block = 256 * 8192
    cap = synth.make_capture(bits, sample_rate=10_000_000,
                             freq_offset_hz=-220_000.0,
                             burst_start_sample=block - 30_000,
                             total_samples=block + 2_000_000, snr_db=30.0)
    frames = decode_both(STRADDLE, cap)
    expected = synth.expected_bits(bits, "DL")
    np.testing.assert_array_equal(
        np.asarray(frames[0]["bits"])[:len(expected)], expected)
