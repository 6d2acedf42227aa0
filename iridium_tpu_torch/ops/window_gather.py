"""Burst-window gather: B windows of l_win samples from the device stream
at per-burst starts.

The stream is held as one (2, N) f32 tensor: the real plane, then the
imaginary plane. A window beginning at sample `w` is addressed as
    w = tile * ALIGN + r,   r = w mod decimation
(the start contract of iridium_tpu/ops/window_gather.py:11-22): the
delivered window starts at a sample congruent to the reference's window
start modulo the decimation factor, and the multiple-of-decimation
alignment lead is zeroed downstream (dsp/downmix.py shift_dec).

`gather` launches csrc/window_gather.cu on CUDA planes and runs
`gather_plain` on CPU planes. Both are pure copies and agree bit for bit,
for any r >= 0; samples outside the planes read as 0. On the card the
kernel walks the windows in order of their start, ranked on the card into
an `order` scratch that the wrapper allocates; nothing is read back to the
host, so the gather captures into a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import _kernels

TILE = 128
R_ROWS = 160
ALIGN = TILE * R_ROWS          # 20480 samples; a multiple of 128 and 40
MAX_SHIFT = 40                 # fine shift r < decimation factor


def _window_index(planes: torch.Tensor, starts2: torch.Tensor,
                  length: int):
    n = planes.shape[1]
    s = starts2[:, 0].long() * ALIGN + starts2[:, 1].long()
    idx = s[:, None] + torch.arange(length, device=planes.device)
    inside = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), inside


def gather_plain(planes: torch.Tensor, starts2: torch.Tensor,
                 l_win: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx, inside = _window_index(planes, starts2, l_win)
    zero = torch.zeros((), dtype=planes.dtype, device=planes.device)
    return (torch.where(inside, planes[0][idx], zero),
            torch.where(inside, planes[1][idx], zero))


def gather(planes: torch.Tensor, starts2: torch.Tensor,
           l_win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """planes (2, N) f32, starts2 (B, 2) i32 [tile, r] -> (B, l_win) f32
    real and imaginary windows."""
    if planes.device.type == "cpu":
        return gather_plain(planes, starts2, l_win)
    dev = planes.device
    B = starts2.shape[0]
    _kernels.check(planes, "planes", torch.float32, dev)
    _kernels.check(starts2, "starts2", torch.int32, dev, (B, 2))
    n = planes.shape[1]
    if planes.dim() != 2 or planes.shape[0] != 2 or n % 4 \
            or planes.data_ptr() % 16:
        raise ValueError("planes must be a 16-byte aligned (2, N) tensor "
                         "with N a multiple of 4")
    if l_win % 4:
        raise ValueError(f"l_win={l_win} must be a multiple of 4")
    out_re = torch.empty((B, l_win), dtype=torch.float32, device=dev)
    out_im = torch.empty((B, l_win), dtype=torch.float32, device=dev)
    if B == 0:
        return out_re, out_im
    order = torch.empty(B, dtype=torch.int32, device=dev)
    k = _kernels
    k.WINDOW_GATHER.launch(dev, k.ptr(planes), n, k.ptr(starts2),
                           k.ptr(order), B, l_win, ALIGN, k.ptr(out_re),
                           k.ptr(out_im))
    return out_re, out_im
