"""Detector state: the `FastState` contract of the JAX package
(iridium_tpu/dsp/detect_fast.py:77-166) as tensors on one device.

Field names are the JAX ones. The per-bin active-burst table is keyed by
FFT bin (entry i is the burst centred at bin i). The noise history is a
ring whose oldest row is at `hist_idx`; `convert.py` brings it to
oldest-first order for hand-over and comparison. The integer and float
scalars live in two small tensors (`ints`, `floats`) so that a kernel
updates them without a host round trip; each has a field-named 0-d view.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..config import DetectorParams

E_DEL = 8          # natural-deletion emissions per frame
E_SQ = 16          # squelch emissions per frame

INT_FIELDS = ("hist_idx", "primed", "burst_id", "squelch_count",
              "n_tagged", "burst_dropped", "create_waits", "g_count")
FLOAT_FIELDS = ("peak_signal_db",)
PLANE_FIELDS = ("baseline_hist", "baseline_sum", "a_valid", "a_id",
                "a_start", "a_last", "a_mag", "a_noise", "mask_count")
GONE_FIELDS = ("g_id", "g_start", "g_stop", "g_last", "g_bin", "g_mag",
               "g_noise")
# the f32 tensors (a_valid is bool, the rest int32)
FLOAT_PLANES = ("baseline_hist", "baseline_sum", "a_mag", "a_noise",
                "g_mag", "g_noise", "floats")


@dataclasses.dataclass
class ScanState:
    baseline_hist: torch.Tensor   # (H, F) f32 ring
    baseline_sum: torch.Tensor    # (F,) f32
    a_valid: torch.Tensor         # (F,) bool
    a_id: torch.Tensor            # (F,) i32
    a_start: torch.Tensor         # (F,) i32 samples, rel. block start
    a_last: torch.Tensor          # (F,) i32
    a_mag: torch.Tensor           # (F,) f32
    a_noise: torch.Tensor         # (F,) f32
    mask_count: torch.Tensor      # (F,) i32
    g_id: torch.Tensor            # (G,) i32
    g_start: torch.Tensor         # (G,) i32
    g_stop: torch.Tensor          # (G,) i32
    g_last: torch.Tensor          # (G,) i32
    g_bin: torch.Tensor           # (G,) i32
    g_mag: torch.Tensor           # (G,) f32
    g_noise: torch.Tensor         # (G,) f32
    ints: torch.Tensor            # (8,) i32, INT_FIELDS order
    floats: torch.Tensor          # (1,) f32, FLOAT_FIELDS order

    def clone(self) -> "ScanState":
        return ScanState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


def add_scalar_views(cls, int_fields, float_fields) -> None:
    """Give `cls` a property per scalar field: the 0-d view of its entry
    in the `ints` or `floats` tensor."""
    for group, names in (("ints", int_fields), ("floats", float_fields)):
        for i, name in enumerate(names):
            setattr(cls, name, property(
                lambda self, group=group, i=i: getattr(self, group)[i]))


add_scalar_views(ScanState, INT_FIELDS, FLOAT_FIELDS)


def init_state(p: DetectorParams, device: torch.device,
               id_offset: int = 0, n_bins: int | None = None) -> ScanState:
    """A fresh state over `n_bins` local bins (all fft_size bins by
    default)."""
    F = n_bins if n_bins is not None else p.fft_size
    H, G = p.history_size, p.gone_capacity

    def zi(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    def zf(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    ints = zi(len(INT_FIELDS))
    ints[INT_FIELDS.index("burst_id")] = id_offset * 10
    return ScanState(
        baseline_hist=torch.zeros((H, F), dtype=torch.float32,
                                  device=device),
        baseline_sum=zf(F),
        a_valid=torch.zeros(F, dtype=torch.bool, device=device),
        a_id=zi(F), a_start=zi(F), a_last=zi(F), a_mag=zf(F),
        a_noise=zf(F), mask_count=zi(F),
        g_id=zi(G), g_start=zi(G), g_stop=zi(G), g_last=zi(G), g_bin=zi(G),
        g_mag=zf(G), g_noise=zf(G),
        ints=ints, floats=zf(len(FLOAT_FIELDS)))


def check(state: ScanState, p: DetectorParams, device: torch.device,
          n_bins: int | None = None) -> None:
    """Raise unless every tensor of `state` is contiguous on `device` in
    the dtype and shape `init_state` gives them (a kernel's C entry takes
    their pointers)."""
    F = n_bins if n_bins is not None else p.fft_size
    H, G = p.history_size, p.gone_capacity
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if f.name == "baseline_hist":
            shape = (H, F)
        elif f.name in ("ints", "floats"):
            shape = (len(INT_FIELDS if f.name == "ints" else FLOAT_FIELDS),)
        else:
            shape = (G,) if f.name in GONE_FIELDS else (F,)
        dtype = (torch.bool if f.name == "a_valid" else torch.float32
                 if f.name in FLOAT_PLANES else torch.int32)
        _kernels.check(t, f.name, dtype, device, shape)


def rebase_(state, block_samples: int) -> None:
    """In place: shift the per-burst sample indices by -block_samples and
    clear the gone count, preparing the carry for the next block (a
    `ScanState`, or detect.py's `DetectorState`)."""
    state.a_start.sub_(block_samples)
    state.a_last.sub_(block_samples)
    state.g_count.zero_()
