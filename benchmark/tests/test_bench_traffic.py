"""The traffic generator: the same seed gives the same capture, and the
injected rate, the UL share and the ranges are the mix's."""

import numpy as np
import pytest
import torch

import traffic

RATE, F = 1_000_000, 1024
BS = 512 * F


def tiny(name="mix_live", **kw):
    return dict(traffic.load(name), pool_blocks=4, offset_hz=400_000.0, **kw)


def test_same_seed_same_capture():
    a, pa = traffic.capture(tiny(), RATE, F, BS, 2**31 + 11, "cpu")
    b, pb = traffic.capture(tiny(), RATE, F, BS, 2**31 + 11, "cpu")
    c, _ = traffic.capture(tiny(), RATE, F, BS, 12, "cpu")
    assert torch.equal(a, b)
    assert np.array_equal(pa["starts"], pb["starts"])
    assert not torch.equal(a, c)


@pytest.mark.parametrize("name", ["mix_live", "mix_sparse"])
def test_injected_rate_and_mix(name):
    mix = dict(traffic.load(name), pool_blocks=8)
    rate, fft, bs = 10_000_000, 8192, 2048 * 8192
    counts = []
    for seed in (1, 2**31 + 3, 2**33 + 5):
        pl = traffic.plan(mix, rate, fft, bs, seed)
        total = pl["total"]
        lo = mix["prime_frames"] * fft
        s = pl["starts"]
        assert s.min() >= lo and s.max() + max(
            len(w["x"]) for w in pl["pool"]) <= total
        span = (total - max(len(w["x"]) for w in pl["pool"]) - lo) / rate
        assert abs(len(s) / span - mix["burst_rate"]) < 0.5
        assert np.all(np.diff(s) >= 0)
        ul = sum(w["direction"] == "UL" for w in pl["pool"])
        assert ul == round(mix["ul_share"] * mix["pool_waveforms"])
        assert {len(w["bits"]) for w in pl["pool"]} == set(
            mix["payload_bits"])
        assert np.abs(pl["offsets"]).max() <= mix["offset_hz"]
        lo_s, hi_s = mix["snr_db"]
        assert lo_s <= pl["snrs"].min() and pl["snrs"].max() <= hi_s
        # stratified: one draw in each of n equal parts of the range
        parts = np.floor((pl["snrs"] - lo_s) / (hi_s - lo_s) * len(s))
        assert sorted(parts.tolist()) == list(range(len(s)))
        counts.append(np.bincount(pl["which"]))
        counts[-1] = (counts[-1].min(), counts[-1].max())
    # every seed the same count of bursts, each waveform placed equally
    # often (to one)
    assert all(hi - lo <= 1 for lo, hi in counts)
