"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: there is no
silent fallback, so a missing GPU is an error and not a slow run.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """`None` means the current CUDA device. Raises RuntimeError when a
    CUDA device is asked for and none is present.

    Turns TF32 off for matmuls and cuDNN convolutions: the plain
    reference paths compare against float32 results, and TF32 keeps only
    about three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
