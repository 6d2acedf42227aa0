"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exports plain `extern "C"` functions. On first use
one `nvcc` per source compiles it for `sm_90a` into
`build/kernels/<name>-<hash>.so` (the hash covers the source and the
flags, so an edited source rebuilds), with ptxas's register and spill
report beside it (`<name>-<hash>.ptxas`), and `ctypes` binds it. Importing
this module needs no compiler: nothing is built until a kernel is
launched on a CUDA tensor, or `build_all()` is called.

Every launch goes through `Kernel.launch`, which raises on a non-zero
`cudaError_t` from the C side and counts the launch in `Kernel.launches`;
a source may also export helpers that launch nothing (`entries`, called
through `Kernel.call`).
A launch recorded into a CUDA graph is counted at each of the graph's
replays instead (runtime/pipeline.py, `GroupGraph`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F32 = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


class Kernel:
    """One CUDA source, its C entry point (`name`, taking `argtypes`), the
    helpers it exports that launch nothing ({symbol: argtypes}) and its
    launch count."""

    def __init__(self, name: str, argtypes: list, extra_flags=(),
                 entries=None):
        self.name = name
        self.argtypes = argtypes
        self.extra_flags = tuple(extra_flags)
        self.entries = dict(entries or {})
        self.launches = 0
        self._fn = None
        self._fns = {}
        self._err = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.h")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS + self.extra_flags).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def ptxas_path(self) -> Path:
        """`ptxas -v`'s report of the library's build."""
        return self.library_path().with_suffix(".ptxas")

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        out, report = self.library_path(), self.ptxas_path()
        if out.exists() and report.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *self.extra_flags,
               "-Xptxas", "-v", "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                               f"{res.stdout}\n{res.stderr}")
        report.write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
        return out

    def _bind(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(self.build()))
            for symbol, argtypes in self.entries.items():
                other = getattr(lib, symbol)
                other.argtypes = argtypes
                other.restype = ctypes.c_int
                self._fns[symbol] = other
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            # a source's one-time set-up (kernel attributes), run at load,
            # before any graph capture
            init = getattr(lib, f"{self.name}_init", None)
            if init is not None:
                init.restype = ctypes.c_int
                code = init()
                if code != 0:
                    raise RuntimeError(f"{self.name}_init: CUDA error "
                                       f"{code}: {err(code).decode()}")
            self._err, self._fn = err, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point on `device`'s current stream. The last
        argument the C side takes is the stream; it is appended here."""
        fn = self._bind()
        if device.index is None or device.index == torch.cuda.current_device():
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        else:
            with torch.cuda.device(device):
                code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        self._raise(code, self.name)
        self.launches += 1

    def call(self, entry: str, *args) -> None:
        """Call the source's entry point `entry`, which launches nothing
        (no stream, no count); raise on a non-zero `cudaError_t`."""
        self._bind()
        self._raise(self._fns[entry](*args), entry)

    def _raise(self, code: int, entry: str) -> None:
        if code != 0:
            raise RuntimeError(f"{entry}: CUDA error {code}: "
                               f"{self._err(code).decode()}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          device: torch.device, shape: tuple | None = None) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device` (of
    `shape`, where given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


DETECT_SCAN = Kernel(
    "detect_scan",
    # the state's 19 planes, the halo, grid and tile scratch, ..., the
    # layout (clusters, block_bins, threads, bins_per_thread,
    # grid_clusters, tiles), the stream
    [P] * 22 + [I] * 11 + [F32] * 5 + [I] * 6 + [P],
    # keep the noise-sum and relative-magnitude arithmetic free of fused
    # multiply-adds, so baseline_sum stays bit-equal to the plain scan
    extra_flags=("--fmad=false",))
FUSED_FRONTEND = Kernel(
    "fused_frontend",
    [P, LL, P, P, P, P, I, I, I, I, I, I, P, P, P, P])
WINDOW_GATHER = Kernel(
    "window_gather",
    [P, LL, P, P, I, I, I, P, P, P])
BLOCK_GATHER = Kernel(
    "block_gather",
    [P, P, LL, I, P, I, I, I, P, P, P])

DEMOD_LOOP = Kernel(
    "demod_loop",
    # ..., the plan (bursts, ring, chunk, threads), the outputs, the stream
    [P, LL, P, I, I, F32, F32, I, I, I, I, I, I, P, P, P, P],
    # every product and sum rounded on its own, as the plain loop's
    # separate tensor operations round them
    extra_flags=("--fmad=false",))

DOWNMIX_FIR = Kernel(
    "downmix_fir",
    # stage, x, B, L, the lengths, u, corr and 2 cfo_total (stage 1's
    # rotation), the two FIRs' taps and counts, the outputs, the stream
    [I, P, I, LL, P, P, P, P, LL, P, I, P, I, P, P, P],
    # every product and sum rounded on its own, as the plain version's
    # separate tensor operations round them
    extra_flags=("--fmad=false",))

DETECT_FAST = Kernel(
    "detect_fast",
    # a launch from a block's packed arguments: the packing, the mode (the
    # whole block, or the split's launch A or B), the frame, the stream
    [P, I, I, P],
    # the noise sums, relative magnitudes and dB values rounded as the
    # plain twin's separate tensor operations round them (no fused
    # multiply-add; IEEE division is nvcc's default)
    extra_flags=("--fmad=false",),
    # the block's arguments checked and packed once: |X|^2, the state's 9
    # planes, 7 gone fields and 2 scalar tensors, the scratch, 15 shape and
    # detector integers, 5 float constants, the plan (blocks, blocks a
    # cluster, block bins, threads, bins a thread, bins a segment), the
    # scratch's words, the split flag, the buffer and its size
    entries={"detect_fast_args": [P] * 20 + [I] * 15 + [F32] * 5 + [I] * 6
             + [LL, I, P, I]})

KERNELS = (DETECT_SCAN, FUSED_FRONTEND, WINDOW_GATHER, BLOCK_GATHER,
           DEMOD_LOOP, DOWNMIX_FIR, DETECT_FAST)


def build_all() -> None:
    """Compile every kernel, one nvcc process per source, all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(k.build) for k in KERNELS]:
            fut.result()


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def graph_nodes(raw_graph: int) -> int:
    """Node count of a captured `cudaGraph_t` (`CUDAGraph.raw_cuda_graph()`),
    through the driver's `cuGraphGetNodes`."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [P, P, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    code = lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {code}")
    return n.value
