"""The benchmark's one traffic generator: a pool of capture blocks made
from `--seed` and the parameters of a traffic file (`traffic/<name>.json`),
which the window cycles through.

The mix is the repository's `bench.py` `make_capture` (:75-135), written
here on the frozen waveforms of `synth.py`: a noise floor, then bursts
after the detector's noise priming (`prime_frames` frames), `ul_share` of
them uplink, payloads drawn from `payload_bits`, a pool of
`pool_waveforms` waveforms at the full rate with a raised-cosine ramp of
`ramp_symbols` symbols at both edges, each placement with its own carrier
offset (uniform in +-`offset_hz`) and SNR (uniform in `snr_db`). No burst
reaches past the pool's end, so none straddles the cycle's wrap.

So that every seed asks the same work of the system, the count of bursts
is fixed (`burst_rate` x the span they may start in), their starts are
that many uniform draws, sorted (Poisson arrivals conditioned on their
count), each waveform of the pool is placed equally often (to one), and
the offsets and SNRs are stratified: one draw in each of as many equal
parts of their ranges, in an order drawn from the seed. The pool's UL
share and payload lengths are fixed counts in a drawn order; the payload
bits are drawn. The noise is drawn on the device with a generator seeded
from `--seed`, the bursts are added there, and the pool is copied once
into pinned host memory, as the port's file reader hands blocks over.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

import synth

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def waveforms(mix: dict, sample_rate: int, rng: np.random.Generator):
    """The pool of `pool_waveforms` bursts at the full rate (complex64,
    unit peak before the ramp), with their directions and payloads."""
    from scipy.signal import resample_poly

    n = int(mix["pool_waveforms"])
    n_ul = int(round(mix["ul_share"] * n))
    dirs = rng.permutation(["UL"] * n_ul + ["DL"] * (n - n_ul))
    sizes = list(mix["payload_bits"])
    lens = rng.permutation([sizes[i % len(sizes)] for i in range(n)])
    sps_full = sample_rate // 25_000
    ramp_len = int(mix["ramp_symbols"]) * sps_full
    ramp = (0.5 - 0.5 * np.cos(np.pi * np.arange(ramp_len) / ramp_len)
            ).astype(np.float32)
    pool = []
    for d, nbits in zip(dirs, lens):
        bits = rng.integers(0, 2, int(nbits)).astype(np.uint8)
        bb = synth.modulate(synth.burst_symbols(bits, str(d)))
        x = resample_poly(bb, up=sample_rate // 250_000, down=1
                          ).astype(np.complex64)
        x[:ramp_len] *= ramp
        x[-ramp_len:] *= ramp[::-1]
        pool.append(dict(x=x, direction=str(d), bits=bits))
    return pool


def plan(mix: dict, sample_rate: int, fft_size: int, block_samples: int,
         seed: int) -> dict:
    """The host's part of the pool: waveforms and placements (start,
    waveform, offset Hz, SNR dB), all from `seed`."""
    rng = np.random.default_rng(seed)
    total = int(mix["pool_blocks"]) * block_samples
    pool = waveforms(mix, sample_rate, rng)
    max_len = max(len(w["x"]) for w in pool)
    lo = int(mix["prime_frames"]) * fft_size
    hi = total - max_len
    n = int(round(mix["burst_rate"] * (hi - lo) / sample_rate))
    starts = np.sort(rng.integers(lo, hi, n))
    which = rng.permutation(np.arange(n) % len(pool))

    def stratified(a, b):
        return a + (b - a) * (rng.permutation(n) + rng.random(n)) / n

    off = float(mix["offset_hz"])
    return dict(pool=pool, total=total, starts=starts, which=which,
                offsets=stratified(-off, off),
                snrs=stratified(*map(float, mix["snr_db"])),
                noise_floor=float(mix["noise_floor"]))


def capture(mix: dict, sample_rate: int, fft_size: int, block_samples: int,
            seed: int, device) -> tuple[torch.Tensor, dict]:
    """(pool_blocks, block_samples) complex64 blocks (pinned host memory
    where `device` is a card) and the plan they were made from."""
    dev = torch.device(device)
    pl = plan(mix, sample_rate, fft_size, block_samples, seed)
    total, nf = pl["total"], pl["noise_floor"]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    cap = torch.randn((total, 2), generator=g, device=dev,
                      dtype=torch.float32)
    cap.mul_(float(np.float32(nf / np.sqrt(2))))
    cap = torch.view_as_complex(cap)
    wave = [torch.from_numpy(w["x"]).to(dev) for w in pl["pool"]]
    max_len = max(len(w) for w in wave)
    n_idx = torch.arange(max_len, dtype=torch.float64, device=dev)
    for s, k, f, snr in zip(pl["starts"].tolist(), pl["which"].tolist(),
                            pl["offsets"].tolist(), pl["snrs"].tolist()):
        x = wave[k]
        ln = len(x)
        amp = float(np.float32(nf * 10.0 ** (snr / 20.0)))
        ph = n_idx[:ln] * (2.0 * np.pi * f / sample_rate)
        rot = torch.polar(torch.ones_like(ph), ph)
        cap[s:s + ln] += (x.to(torch.complex128) * amp * rot).to(
            torch.complex64)
    blocks = cap.view(int(mix["pool_blocks"]), block_samples)
    if dev.type == "cuda":
        host = torch.empty(blocks.shape, dtype=torch.complex64,
                           pin_memory=True)
        host.copy_(blocks)
        del cap, blocks
        blocks = host
    return blocks, pl
