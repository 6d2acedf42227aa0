"""The demod loop kernel's plan (`dsp/demod.py` `plan`) on the CPU: at the
class batches of the 10 MHz, 400 MHz and 1.6 GHz decodes and at the
edges, it stays within the block's shared memory, covers every burst, and
equals the plan of `csrc/demod_plan.h`, which the kernel's C entry checks
(the header is plain C++: g++ builds it here).
"""

import ctypes
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from iridium_tpu_torch import _kernels  # noqa: E402
from iridium_tpu_torch.dsp import demod  # noqa: E402

# (B, L, S) of each decode's three class batches (`exp_demod.class_shapes`
# at 10 MHz; at WIDE_RUN for 400 MHz and for 1.6 GHz at 256 frames a block:
# the same three)
CLASS_BATCHES = [(1024, 1918, 205), (96, 4440, 471), (48, 4440, 471),
                 (32, 1918, 205), (24, 4440, 471)]
EDGES = [(1, 4, 10), (7, 1917, 205), (1, 1918, 205), (5, 1918, 0),
         (3, demod.MAX_RING, 900), (3, demod.MAX_RING + 1, 900),
         (1024, 2 * demod.MAX_RING, 1700), (133, 401, 40), (5000, 30000, 5),
         (1, 5, 1)]
SHAPES = CLASS_BATCHES + EDGES


def _blocks(B, p):
    return -(-B // p.bursts)


@pytest.mark.parametrize("use_gardner", [True, False],
                         ids=["gardner", "no_gardner"])
@pytest.mark.parametrize("B, L, S", SHAPES)
def test_plan_fits_and_covers_the_batch(B, L, S, use_gardner):
    p = demod.plan(B, L, S, use_gardner)
    assert p.smem == demod.shared_bytes(p.bursts, p.ring, p.chunk)
    assert 0 < p.smem <= demod.SMEM_BYTES
    assert 1 <= p.bursts <= demod.MAX_BURSTS
    assert p.threads == demod.THREADS == 64
    # every burst a lane of a block; only the last block has idle lanes
    n = _blocks(B, p)
    assert n * p.bursts >= B > (n - 1) * p.bursts
    if not use_gardner:
        assert p.ring == p.chunk == 0
        return
    # rings and chunks are powers of two, a whole number of slots
    assert p.ring & (p.ring - 1) == 0 and p.chunk & (p.chunk - 1) == 0
    assert p.ring % p.chunk == 0 and p.chunk <= demod.CHUNK
    if L <= demod.MAX_RING and p.bursts * 8 * p.ring < demod.SMEM_BYTES:
        assert p.ring >= L            # the whole row
    else:
        # a ring of at least 4 slots walks the row
        assert p.ring >= demod.MIN_RING and p.ring // p.chunk >= 4


def test_class_batches_stage_whole_rows():
    """At every decode's class batches the rows come in whole, and the
    batch spreads over at most one block an SM."""
    for B, L, S in CLASS_BATCHES:
        p = demod.plan(B, L, S, True)
        assert p.ring >= L
        assert _blocks(B, p) <= demod.SMS
    assert demod.plan(1024, 1918, 205, True) == demod.Plan(
        8, 2048, 512, 64, 136512)


def test_plan_refuses_rows_past_int32_positions():
    with pytest.raises(ValueError):
        demod.plan(1, 2 ** 31, 10, True)
    with pytest.raises(ValueError):
        demod.plan(1, 3, 10, False)


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """demod_plan::plan from csrc/demod_plan.h, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("demod_plan")
    (d / "shim.cpp").write_text(
        '#include "demod_plan.h"\n'
        'extern "C" long long plan_c(int B, long long L, int S, int g,\n'
        '                            long long* out) {\n'
        '  const demod_plan::Plan p = demod_plan::plan(B, L, S, g != 0);\n'
        '  out[0] = p.bursts; out[1] = p.ring; out[2] = p.chunk;\n'
        '  out[3] = p.threads; out[4] = p.smem;\n'
        '  return demod_plan::kSmemBytes;\n'
        '}\n')
    lib = d / "libplan.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_kernels.CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).plan_c
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong

    def call(B, L, S, g):
        out = (ctypes.c_longlong * 5)()
        smem_max = fn(B, L, S, int(g), out)
        return demod.Plan(*out), smem_max
    return call


@pytest.mark.parametrize("use_gardner", [True, False],
                         ids=["gardner", "no_gardner"])
def test_c_entry_plan_is_the_python_plan(c_plan, use_gardner):
    """The C entry accepts exactly the plan `csrc/demod_plan.h` computes:
    it is `plan`'s at every shape here and along L and B sweeps."""
    shapes = SHAPES + [(B, L, 100) for B in (1, 31, 132, 133, 264, 1000,
                                             4224, 9000)
                       for L in (4, 5, 127, 128, 129, 2047, 2048, 2049,
                                 4440, 8191, 8192, 8193, 16384, 100000)]
    for B, L, S in shapes:
        got, smem_max = c_plan(B, L, S, use_gardner)
        assert got == demod.plan(B, L, S, use_gardner), (B, L, S)
    assert smem_max == demod.SMEM_BYTES
