"""Aligned row-block gather: B windows of nt rows from two (Mt, width) f32
stream planes at per-window block starts,

    o[b, i, :] = s[st[b] * R + i, :]    for i < nt,

the function of the Pallas prototype in tools/exp_pallas_gather.py
(kernel :55-57, grid (B, nt / R) with R-row blocks at block index
st[b] + t, :59-80).

`block_gather` launches csrc/block_gather.cu (TMA bulk copies through
shared memory, each covered source row loaded once) on CUDA planes and
runs `block_gather_plain` on CPU planes. Both are pure copies and agree bit
for bit; rows outside the planes read as 0.
"""

from __future__ import annotations

import torch

from .. import _kernels


def block_gather_plain(sre: torch.Tensor, sim: torch.Tensor,
                       st: torch.Tensor, R: int, nt: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    mt = sre.shape[0]
    rows = st.long()[:, None] * R + torch.arange(nt, device=st.device)
    inside = ((rows >= 0) & (rows < mt))[..., None]
    idx = rows.clamp(0, mt - 1)
    zero = torch.zeros((), dtype=sre.dtype, device=sre.device)
    return (torch.where(inside, sre[idx], zero),
            torch.where(inside, sim[idx], zero))


def block_gather(sre: torch.Tensor, sim: torch.Tensor, st: torch.Tensor,
                 R: int, nt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """sre, sim (Mt, width) f32 planes, st (B,) i32 block starts in units
    of R rows -> (B, nt, width) f32 real and imaginary windows."""
    if R < 1 or nt < 0 or nt % R:
        raise ValueError(f"nt={nt} must be a non-negative multiple of "
                         f"R={R} >= 1")
    if sre.device.type == "cpu":
        return block_gather_plain(sre, sim, st, R, nt)
    dev = sre.device
    if sre.dim() != 2:
        raise ValueError(f"sre: shape {tuple(sre.shape)}, expected "
                         "(Mt, width)")
    mt, width = sre.shape
    B = st.shape[0]
    _kernels.check(sre, "sre", torch.float32, dev)
    _kernels.check(sim, "sim", torch.float32, dev, (mt, width))
    _kernels.check(st, "st", torch.int32, dev, (B,))
    if width % 4 or sre.data_ptr() % 16 or sim.data_ptr() % 16:
        raise ValueError("planes must be 16-byte aligned with a width "
                         "that is a multiple of 4")
    o_re, o_im = torch.empty((2, B, nt, width), dtype=torch.float32,
                             device=dev)
    if B == 0 or nt == 0:
        return o_re, o_im
    k = _kernels
    k.BLOCK_GATHER.launch(dev, k.ptr(sre), k.ptr(sim), mt, width,
                          k.ptr(st), B, nt, R, k.ptr(o_re), k.ptr(o_im))
    return o_re, o_im
