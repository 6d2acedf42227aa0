"""Native host ingest: `read_blocks` with the reading and the format
conversion on a C++ thread (csrc/hostio.cpp), straight into a ring of
buffers this reader owns (pinned host memory when the blocks go to a
CUDA device). The port of iridium_tpu/io/native.py.

The library is built with g++ at first use into
`build/hostio/libhostio-<hash>.so` (the hash covers the source and the
flags; git-ignored). A failed build raises RuntimeError: there is no
fallback to the Python reader. Stdin ("-") has no file to hand to the
thread and is read by `readers.read_blocks`, as in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np
import torch

from . import readers

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hostio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "hostio"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
N_BUFFERS = 3

_FMT = {"ci8": 0, "ci16": 1, "cf32": 2}
_lib = None


def build() -> Path:
    """Compile csrc/hostio.cpp unless a library of the same hash exists."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = Path(BUILD_DIR) / f"libhostio-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX} to build {SOURCE.name}: {e}"
                           ) from e
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {SOURCE.name}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.hostio_open.restype = ctypes.c_void_p
        lib.hostio_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_long]
        lib.hostio_give.restype = None
        lib.hostio_give.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.hostio_next.restype = ctypes.c_long
        lib.hostio_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p)]
        lib.hostio_close.restype = None
        lib.hostio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def read_blocks(path: str, block_samples: int, fmt: str | None = None,
                device: str | torch.device = "cpu"
                ) -> Iterator[Tuple[torch.Tensor | np.ndarray, int]]:
    """Yield (block, n_valid) as `readers.read_blocks` does (the last
    block zero-padded), each block a (block_samples,) complex64 tensor in
    one of N_BUFFERS ring buffers: pinned host memory when `device` is a
    CUDA device, so that its upload needs no host copy.

    The consumer must be done with a block when it asks for the next one:
    on the CPU it has read or copied it; on the card it has enqueued its
    reads (the host-to-device copy) on the device's current stream. The
    buffer goes back to the reader thread after an event recorded at that
    moment has completed, so never while the copy may still run. For "-"
    it yields `readers.read_blocks`' numpy blocks."""
    fmt = fmt or ("ci8" if path == "-" else readers.detect_format(path))
    if path == "-":
        yield from readers.read_blocks(path, block_samples, fmt)
        return
    if fmt not in _FMT:
        raise ValueError(f"unknown IQ format: {fmt}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    lib = _load()
    ring = [torch.empty(block_samples, dtype=torch.complex64,
                        pin_memory=on_card) for _ in range(N_BUFFERS)]
    slot = {t.data_ptr(): i for i, t in enumerate(ring)}
    h = lib.hostio_open(os.fsencode(path), _FMT[fmt], block_samples)
    if not h:
        raise OSError(f"cannot open {path}")
    held = collections.deque()     # (ring index, event) out of the reader
    try:
        for t in ring:
            lib.hostio_give(h, t.data_ptr())
        while True:
            buf = ctypes.c_void_p()
            n = lib.hostio_next(h, ctypes.byref(buf))
            if n < 0:
                raise OSError(f"read error in {path}")
            if n == 0:
                return
            i = slot[buf.value]
            yield ring[i], int(n)
            if n < block_samples:
                return
            if on_card:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                held.append((i, ev))
            else:
                held.append((i, None))
            # give back every buffer whose reads have run; if the reader
            # has none left to fill, wait for the oldest
            while held and (held[0][1] is None or held[0][1].query()
                            or len(held) == N_BUFFERS):
                j, ev = held.popleft()
                if ev is not None:
                    ev.synchronize()
                lib.hostio_give(h, ring[j].data_ptr())
    finally:
        lib.hostio_close(h)
