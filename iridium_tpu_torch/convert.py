"""Carry detector state across from the JAX package and back.

The system has no weights: what carries over is the detector state. A JAX
`FastState` fetched as a dict of numpy arrays (field name -> array) becomes
a `ScanState` on a device, and back. The JAX ring resolves to oldest-first
order on the way in; on the way out the port's ring is resolved the same
way, with hist_idx 0 (the form the JAX Pallas scan returns).
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp.state import (FLOAT_FIELDS, GONE_FIELDS, INT_FIELDS, PLANE_FIELDS,
                        ScanState)

_DTYPES = {"a_valid": torch.bool, "baseline_hist": torch.float32,
           "baseline_sum": torch.float32, "a_mag": torch.float32,
           "a_noise": torch.float32, "g_mag": torch.float32,
           "g_noise": torch.float32}


def state_from_numpy(d: dict, device: str | torch.device) -> ScanState:
    hist = np.roll(np.asarray(d["baseline_hist"]),
                   -int(d["hist_idx"]), axis=0)
    fields = {}
    for name in PLANE_FIELDS + GONE_FIELDS:
        a = hist if name == "baseline_hist" else np.asarray(d[name])
        fields[name] = torch.as_tensor(
            np.ascontiguousarray(a),
            dtype=_DTYPES.get(name, torch.int32)).to(device)
    ints = [0 if name == "hist_idx" else int(d[name])
            for name in INT_FIELDS]
    fields["ints"] = torch.tensor(ints, dtype=torch.int32, device=device)
    fields["floats"] = torch.tensor([float(d[n]) for n in FLOAT_FIELDS],
                                    dtype=torch.float32, device=device)
    return ScanState(**fields)


def state_to_numpy(state: ScanState) -> dict:
    ints = state.ints.cpu().numpy()
    hidx = int(ints[INT_FIELDS.index("hist_idx")])
    out = {name: getattr(state, name).cpu().numpy()
           for name in PLANE_FIELDS + GONE_FIELDS}
    out["baseline_hist"] = np.roll(out["baseline_hist"], -hidx, axis=0)
    for i, name in enumerate(INT_FIELDS):
        out[name] = np.int32(0 if name == "hist_idx" else ints[i])
    for i, name in enumerate(FLOAT_FIELDS):
        out[name] = np.float32(state.floats[i].item())
    return out
