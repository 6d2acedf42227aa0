"""The slice above the largest resident grid at 1.6 GHz (F = 2,097,152,
which the port runs on its tiled scan kernel: `scan_plain` on the CPU):
the port's detect step against the JAX package's on the CPU. The JAX
Pipeline at this F holds ~19.6 GB and takes ~100 s on the CPU even at 16
frames a block, so the slice is held at its detect step; the tiled
layouts are walked bin by bin in `test_torch_scan_grid.py`, the kernel
held to `scan_plain` on the card in `test_torch_kernels_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iridium_tpu.config import DetectorConfig as JaxDetConfig  # noqa: E402
from iridium_tpu.dsp import detect, detect_fast  # noqa: E402
from iridium_tpu_torch import convert  # noqa: E402
from iridium_tpu_torch.config import DetectorConfig  # noqa: E402
from iridium_tpu_torch.dsp import detect_scan, state as st  # noqa: E402
from iridium_tpu_torch.io import synth  # noqa: E402

from test_torch_detect_scan import (check_states, jax_state_dict,  # noqa: E402
                                    spectrogram)


def test_1600mhz_detect_step_matches_jax():
    """The slice at 1.6 GHz (F = 2,097,152, which the port runs on its
    tiled kernel: `scan_plain` on the CPU) over two blocks of 16 frames
    (history 8: the first 8 frames prime it), on two DL bursts at 0-3 dB a
    sample far apart in bin (-600 MHz, +137 kHz) and in time, the second
    across the block boundary, where detect_fast (the JAX package's
    scan on the CPU) and the argmax walk agree. On the same |X|^2 rows the
    port's scan and the JAX package's give the same state block by block
    (`check_states`' tolerances); end to end, the port's detect step
    (`detect_scan.detect_block`: window, FFT, |X|^2, fftshift, scan) and
    the JAX package's give the same gone tables and active bins (its two
    FFTs sum otherwise, so the sums are held only through the rows). The
    JAX Pipeline at this F holds ~19.6 GB and takes ~100 s on the CPU even
    at 16 frames a block, so the slice is held at its detect step."""
    cfg = dict(sample_rate=1_600_000_000, frames_per_block=16,
               history_size=8, gone_capacity=64, max_new_per_frame=8)
    jp, pp = JaxDetConfig(**cfg).derived(), DetectorConfig(**cfg).derived()
    assert pp.fft_size == jp.fft_size == 2097152
    assert detect_scan.resolve_impl(pp) == "scan"
    assert detect_scan.tiles(pp.fft_size) == 2
    bs = pp.block_samples
    rng = np.random.default_rng(7)
    cap = rng.standard_normal(4 * bs, dtype=np.float32).view(np.complex64)
    cap *= np.float32(0.01 / np.sqrt(2))
    for start, off in ((17 * pp.fft_size // 2, -600e6),
                       (bs - 4_000_000, 137_000.0)):
        bits = rng.integers(0, 2, 108).astype(np.uint8)
        synth.add_burst(cap, synth.burst_waveform(bits, pp.sample_rate, off),
                        start, snr_db=float(rng.uniform(0.0, 3.0)))
    det_j = detect_fast.make_detect_block_fast(jp)
    cpu = torch.device("cpu")
    sj = detect_fast.init_state(jp)
    rows_p, step_p = st.init_state(pp, cpu), st.init_state(pp, cpu)
    gone = 0
    for b in range(2):
        x = cap[b * bs:(b + 1) * bs]
        if b:
            sj = detect.rebase_state(sj, bs)
            st.rebase_(rows_p, bs)
            st.rebase_(step_p, bs)
        # the JAX detect step computes these rows, then scans them
        m = spectrogram(jp, x)
        sj = det_j(jnp.asarray(x), sj, jnp.int32(bs))
        want = jax_state_dict(sj)
        rows_p = detect_scan.scan(torch.from_numpy(m.copy()), rows_p, bs,
                                  pp)
        check_states(convert.state_to_numpy(rows_p), want)
        step_p = detect_scan.detect_block(torch.from_numpy(x), step_p, bs,
                                          pp)
        got = convert.state_to_numpy(step_p)
        for k in ("g_count", "g_id", "g_start", "g_stop", "g_last", "g_bin",
                  "a_valid", "a_start", "a_last", "n_tagged"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        gone += int(step_p.g_count)
    assert gone >= 2
