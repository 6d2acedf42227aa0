"""The chain bound of a latency-bound loop: the least time one iteration
of a loop's dependent chain takes, read from the compiled machine code
(SASS) with instruction latencies measured on the card.

    python -m iridium_tpu_torch.tools.sass_chain [--source PATH ...]

`latencies(dev)` builds a small kernel (`LATENCY_SRC`) that runs, on one
thread, dependent chains of each kind of instruction the loops use
(FP32 add, multiply, fused multiply-add, min, compare-and-select; the
special-function unit; float-integer conversions; integer add,
multiply-add, logic, shift, min, compare-and-select; a shared-memory load
and a cached global load, each a pointer chase) and reads clock64()
around them: cycles an instruction. It also times a spin of a known
number of cycles with CUDA events, which gives the SM clock in GHz.

`disassemble(lib)` runs `cuobjdump -sass` on a built kernel library;
`loops(sass, fn)` finds each loop of a kernel function (a backward
branch and its target) and `chain_cycles` walks one loop's body in
program order as a dataflow graph with unbounded issue: an instruction
starts when its source registers (general, uniform and predicate) are
ready, and its results are ready its latency later. Inner loops run
once; a forward branch over a block that calls a subroutine, spills to
local memory or loops without a special-function instruction (sinf/cosf
at large arguments), or a short block around a call (the slow paths of
IEEE division, reciprocal and square root), is taken; every other branch
falls through (an active step's path). The
body is walked 8 times; the growth of the latest ready time per walk,
once steady, is the loop's chain in cycles an iteration. No issue slot,
bank, or pipe limit is counted, so the real loop is slower: the bound
says how far a design could still go. `step_chains` names the loops of
the demod loop kernel: the innermost loop holding a special-function
instruction (the PLL's step) and the innermost one holding a
float-to-integer conversion (the Gardner position's); in the one-thread
design both are one loop.

On the card without flags: the latencies, the clock and the package's
demod loop kernel's loops; `--source` adds another source of the same C
entry point (`tools/exp_demod.py`'s adapter).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .. import _kernels

# dependent chains: each op reads the last op's result
LATENCY_OPS = {
    "fadd": ("f", "add.rn.f32 %0, %0, %1;"),
    "fmul": ("f", "mul.rn.f32 %0, %0, %1;"),
    "ffma": ("f", "fma.rn.f32 %0, %0, %1, %2;"),
    "fmnmx": ("f", "min.f32 %0, %0, %1; max.f32 %0, %0, %2;"),
    "fsetp_fsel": ("f", "{ .reg .pred p; setp.lt.f32 p, %0, %1; "
                        "selp.f32 %0, %2, %0, p; }"),
    "mufu": ("f", "rsqrt.approx.ftz.f32 %0, %0;"),
    "f2i_i2f": ("f", "{ .reg .s32 i; cvt.rzi.s32.f32 i, %0; "
                     "cvt.rn.f32.s32 %0, i; }"),
    # a logic op paired with a min and an add with a logic op, which keeps
    # ptxas from folding two of them into one three-input instruction
    "lop": ("i", "xor.b32 %0, %0, %1; min.s32 %0, %0, %2;"),
    "iadd": ("i", "add.s32 %0, %0, %1; xor.b32 %0, %0, %2;"),
    "imad": ("i", "mad.lo.s32 %0, %0, %1, %2;"),
    "shf": ("i", "shf.l.wrap.b32 %0, %0, %0, %1;"),
    "imnmx": ("i", "min.s32 %0, %0, %1; max.s32 %0, %0, %2;"),
    "isetp_sel": ("i", "{ .reg .pred p; setp.lt.s32 p, %0, %1; "
                       "selp.s32 %0, %2, %0, p; }"),
    "lds": ("s", "ld.shared.u32 %0, [%0];"),
    "ldg": ("g", "ld.global.ca.u64 %0, [%0];"),
}
# how many instructions one chain link is (a pair counts as two)
LINK_OPS = {"fmnmx": 2, "fsetp_fsel": 2, "f2i_i2f": 2, "imnmx": 2,
            "isetp_sel": 2}
PAIRED = {"lop": "imnmx", "iadd": "lop"}   # less the partner's latency
N_LINKS = 512

LATENCY_SRC = r"""
#include <cuda_runtime.h>

#define CHAIN(...) \
  _Pragma("unroll") for (int k = 0; k < 64; ++k) __VA_ARGS__

__global__ void spin_kernel(long long cycles, long long* out) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  out[0] = clock64() - t0;
}
{kernels}

extern "C" int sass_latency(int op, float* f, unsigned long long* g,
                            long long* cycles, long long spin,
                            cudaStream_t stream) {
  switch (op) {
{cases}
    case -1: spin_kernel<<<1, 1, 0, stream>>>(spin, cycles); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sass_latency_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""

KERNEL_F = r"""
__global__ void lat_{name}(float* f, unsigned long long* g, long long* c) {
  float x = f[0];
  const float a = f[1], b = f[2];
  const long long t0 = clock64();
  for (int r = 0; r < {reps}; ++r)
    CHAIN(asm volatile("{asm}" : "+f"(x) : "f"(a), "f"(b)));
  const long long t1 = clock64();
  f[3] = x;
  c[0] = t1 - t0;
}
"""

KERNEL_I = r"""
__global__ void lat_{name}(float* f, unsigned long long* g, long long* c) {
  int x = __float_as_int(f[0]);
  const int a = __float_as_int(f[1]), b = __float_as_int(f[2]);
  const long long t0 = clock64();
  for (int r = 0; r < {reps}; ++r)
    CHAIN(asm volatile("{asm}" : "+r"(x) : "r"(a), "r"(b)));
  const long long t1 = clock64();
  f[3] = __int_as_float(x);
  c[0] = t1 - t0;
}
"""

# a pointer chase: each word holds its own address
KERNEL_S = r"""
__global__ void lat_{name}(float* f, unsigned long long* g, long long* c) {
  __shared__ unsigned int s[32];
  s[threadIdx.x] = (unsigned)__cvta_generic_to_shared(&s[threadIdx.x]);
  __syncwarp();
  unsigned int x = s[0];
  const long long t0 = clock64();
  for (int r = 0; r < {reps}; ++r)
    CHAIN(asm volatile("{asm}" : "+r"(x)));
  const long long t1 = clock64();
  f[3] = (float)x;
  c[0] = t1 - t0;
}
"""

KERNEL_G = r"""
__global__ void lat_{name}(float* f, unsigned long long* g, long long* c) {
  g[0] = (unsigned long long)g;
  __threadfence();
  unsigned long long x = g[0];
  const long long t0 = clock64();
  for (int r = 0; r < {reps}; ++r)
    CHAIN(asm volatile("{asm}" : "+l"(x)));
  const long long t1 = clock64();
  f[3] = (float)x;
  c[0] = t1 - t0;
}
"""


def latency_source() -> str:
    reps = N_LINKS // 64
    kernels, cases = [], []
    for i, (name, (kind, asm)) in enumerate(LATENCY_OPS.items()):
        tmpl = dict(f=KERNEL_F, i=KERNEL_I, s=KERNEL_S, g=KERNEL_G)[kind]
        kernels.append(tmpl.replace("{name}", name)
                       .replace("{reps}", str(reps))
                       .replace("{asm}", asm))
        cases.append(f"    case {i}: lat_{name}<<<1, 1, 0, stream>>>"
                     f"(f, g, cycles); break;")
    return (LATENCY_SRC.replace("{kernels}", "".join(kernels))
            .replace("{cases}", "\n".join(cases)))


class _Latency(_kernels.Kernel):
    """The latency kernel, built from LATENCY_SRC like a `csrc/` source."""

    def __init__(self):
        super().__init__("sass_latency", [_kernels.I, _kernels.P,
                                          _kernels.P, _kernels.P,
                                          _kernels.LL, _kernels.P])
        self.text = latency_source()

    @property
    def source(self) -> Path:
        path = _kernels.BUILD_DIR / "sass_latency.cu"
        if not path.exists() or path.read_text() != self.text:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(self.text)
        return path


def latencies(dev: torch.device) -> dict:
    """{op: cycles an instruction} for LATENCY_OPS, and `clock_ghz`: the
    SM clock over a spin of 2e8 cycles (median of 3)."""
    k = _Latency()
    f = torch.tensor([1.0001, 0.999, 1e-7, 0.0], device=dev)
    g = torch.zeros(4, dtype=torch.int64, device=dev)
    c = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {}
    for i, name in enumerate(LATENCY_OPS):
        for _ in range(2):                 # the second run is timed
            k.launch(dev, i, f.data_ptr(), g.data_ptr(), c.data_ptr(), 0)
            torch.cuda.synchronize(dev)
        out[name] = int(c.item()) / (N_LINKS * LINK_OPS.get(name, 1))
    for name, partner in PAIRED.items():
        out[name] -= out[partner]
    ghz = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        k.launch(dev, -1, f.data_ptr(), g.data_ptr(), c.data_ptr(),
                 int(2e8))
        b.record()
        b.synchronize()
        ghz.append(int(c.item()) / (a.elapsed_time(b) * 1e6))
    out["clock_ghz"] = sorted(ghz)[1]
    return out


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc")


def disassemble(lib: Path) -> str:
    res = subprocess.run([cuobjdump(), "-sass", str(lib)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr}")
    return res.stdout


INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                  r"\s*([^;]*);")
FUNC = re.compile(r"Function : (\S+)")
TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")
REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(?![\w])")
NO_DEST = ("ST", "STS", "STG", "STL", "RED", "ATOM", "ATOMS", "BRA", "BAR",
           "EXIT", "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC", "NOP",
           "MEMBAR", "FENCE", "ERRBAR", "DEPBAR", "YIELD", "UBLKCP",
           "SYNCS", "CCTL", "BPT", "NANOSLEEP", "JMP", "BREAK", "ELECT")


def functions(sass: str) -> dict[str, list[dict]]:
    """{mangled name: [instruction dicts]} with each instruction's
    address, guard, opcode and operands."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSN.search(line) if cur is not None else None
        if m:
            cur.append(dict(addr=int(m.group(1), 16),
                            guard=(m.group(2) or "").strip(),
                            op=m.group(3), args=m.group(4).strip()))
    return out


def _target(ins: list[dict], k: int, at: dict) -> int | None:
    """The instruction index a branch at k goes to."""
    m = TARGET.search(ins[k]["args"])
    return at.get(int(m.group(1), 16)) if m else None


def _pairs(op: str) -> int:
    if ".128" in op:
        return 4
    if ".64" in op or ".WIDE" in op or op.startswith(("D", "F2I.S64",
                                                      "I2F.S64")):
        return 2
    return 1


def _expand(reg: str, n: int) -> list[str]:
    if n == 1 or not reg.startswith(("R", "UR")):
        return [reg]
    pre = "UR" if reg.startswith("UR") else "R"
    k = int(reg[len(pre):])
    return [f"{pre}{k + i}" for i in range(n)]


def operands(ins: dict) -> tuple[list[str], list[str]]:
    """(destination registers, source registers) of an instruction."""
    op = ins["op"]
    base = op.split(".")[0]
    parts = [p.strip() for p in ins["args"].split(",")] if ins["args"] else []
    srcs = REG.findall(ins["guard"])
    dests = []
    if parts and base not in NO_DEST:
        first = REG.findall(parts[0])
        if first and not parts[0].startswith("["):
            dests = _expand(first[0], _pairs(op))
            parts = parts[1:]
            if base.endswith("SETP") and parts:   # two predicate results
                dests += REG.findall(parts[0])
                parts = parts[1:]
            while parts and re.fullmatch(r"U?P\d", parts[0]):
                dests.append(parts[0])           # a carry out
                parts = parts[1:]
    for p in parts:
        for r in REG.findall(p):
            srcs += _expand(r, 2 if ".64" in p else 1)
    return dests, srcs


# the measured latency (LATENCY_OPS) each opcode takes; the rest take an
# integer add's
LATENCY_CLASS = {
    "FADD": "fadd", "FMUL": "fmul", "FFMA": "ffma", "FSET": "ffma",
    "FSWZADD": "ffma", "FMNMX": "fmnmx", "FSEL": "fsetp_fsel",
    "FSETP": "fsetp_fsel", "FCHK": "fsetp_fsel", "MUFU": "mufu",
    "F2I": "f2i_i2f", "I2F": "f2i_i2f", "I2FP": "f2i_i2f",
    "F2F": "f2i_i2f", "FRND": "f2i_i2f", "I2I": "f2i_i2f",
    "F2FP": "f2i_i2f", "LDS": "lds", "LDSM": "lds", "LDG": "ldg",
    "LD": "ldg", "LDL": "ldg", "LDC": "ldg", "ULDC": "ldg",
    "IMAD": "imad", "IMUL": "imad", "LEA": "imad", "IDP": "imad",
    "LOP3": "lop", "PLOP3": "lop", "PRMT": "lop", "SHF": "shf",
    "SHL": "shf", "SHR": "shf", "IMNMX": "imnmx", "VIMNMX": "imnmx",
    "ISETP": "isetp_sel", "SEL": "isetp_sel", "ICMP": "isetp_sel"}


def latency_of(op: str, lat: dict) -> float:
    return lat[LATENCY_CLASS.get(op.split(".")[0], "iadd")]


def loops(ins: list[dict]) -> list[tuple[int, int]]:
    """(first, last) instruction indices of each loop: a branch back to an
    earlier instruction."""
    at = {x["addr"]: i for i, x in enumerate(ins)}
    out = []
    for i, x in enumerate(ins):
        if x["op"].startswith("BRA"):
            t = _target(ins, i, at)
            if t is not None and t <= i:
                out.append((t, i))
    return out


def _slow(ins: list[dict], i: int, j: int, at: dict) -> bool:
    """Whether the block [i, j) is a slow path: it touches local memory or
    loops (sinf and cosf at large arguments) and holds no MUFU (a block
    that does is the main path, skipped only on an inactive step), or it
    is a short block around a call (the slow paths of IEEE division,
    reciprocal and square root: the call, its argument and its result)."""
    if any(ins[k]["op"].startswith("MUFU") for k in range(i, j)):
        return False
    for k in range(i, j):
        op = ins[k]["op"]
        if op.startswith(("STL", "LDL")):
            return True
        if op.startswith("CALL") and j - i <= 6:
            return True
        if op.startswith("BRA"):
            t = _target(ins, k, at)
            if t is not None and i <= t <= k:
                return True
    return False


def chain_cycles(ins: list[dict], first: int, last: int, lat: dict,
                 walks: int = 8) -> float:
    """Cycles an iteration of the loop [first, last]'s dependent chain
    (module docstring)."""
    at = {x["addr"]: i for i, x in enumerate(ins)}
    ready: dict[str, float] = {}
    ends = []
    for _ in range(walks):
        k = first
        while k < last:
            x = ins[k]
            op = x["op"]
            if op.startswith("BRA"):
                tgt = _target(ins, k, at)
                cond = bool(x["guard"]) or "P" in x["args"].split("0x")[0]
                if tgt is not None and k < tgt <= last and (
                        not cond or _slow(ins, k + 1, tgt, at)):
                    k = tgt
                    continue
                if tgt is not None and not cond and not k < tgt <= last:
                    break               # leaves the body or loops back
                k += 1
                continue
            if op.startswith(("CALL", "EXIT", "RET")):
                k += 1
                continue
            dests, srcs = operands(x)
            start = max([ready.get(r, 0.0) for r in srcs
                         if r not in ("RZ", "URZ", "PT", "UPT")] + [0.0])
            for r in dests:
                ready[r] = start + latency_of(op, lat)
            k += 1
        ends.append(max(ready.values(), default=0.0))
    steady = ends[walks // 2:]
    return (steady[-1] - steady[0]) / max(len(steady) - 1, 1)


def step_chains(sass: str, lat: dict) -> dict:
    """{function: cycles of each step loop's chain} for each kernel
    function of a demod loop build: "pll", the innermost loop holding a
    MUFU (the PLL step; in the one-thread design the whole step, timing
    included), "timing", the innermost loop holding an F2I and no MUFU
    (the Gardner position's step, on its own warp), and "step", the
    longer of the two: the chain bound of a symbol step. A function with
    neither is left out."""
    out = {}
    for name, ins in functions(sass).items():
        lps = loops(ins)

        def holds(a, b, mark):
            return any(ins[k]["op"].startswith(mark)
                       for k in range(a, b + 1))
        res = {}
        for key, want, unwanted in (("pll", "MUFU", None),
                                    ("timing", "F2I", "MUFU")):
            cand = [(b - a, a, b) for a, b in lps if holds(a, b, want)
                    and not (unwanted and holds(a, b, unwanted))]
            if cand:
                _, a, b = min(cand)
                res[key] = chain_cycles(ins, a, b, lat)
                res[f"{key}_insns"] = b - a + 1
        if res:
            res["step"] = max(res.get("pll", 0.0), res.get("timing", 0.0))
            res["step_ns"] = res["step"] / lat["clock_ghz"]
            out[short_name(name)] = res
    return out


def chain_bound(kernel: _kernels.Kernel, use_gardner: bool, lat: dict
                ) -> float | None:
    """ns a symbol step of `kernel`'s chain in one mode: its function
    `demod_kernel<1>` or `<0>` (the one-thread design's gardner_kernel or
    simple_kernel); None where that function has no step loop (a probe's
    copy without the PLL, --no-gardner)."""
    chains = step_chains(disassemble(kernel.build()), lat)
    names = ((f"demod_kernel<{int(use_gardner)}>",)
             + (("gardner_kernel",) if use_gardner else ("simple_kernel",)))
    for name in names:
        if name in chains:
            return chains[name]["step_ns"]
    return None


def short_name(mangled: str) -> str:
    """`demod_kernel<1>` for a mangled instantiation, `gardner_kernel` for
    a plain function."""
    names = re.findall(r"[A-Za-z_]*kernel", mangled)
    name = names[-1] if names else mangled
    m = re.search(r"kernelIL\w(\d+)E", mangled)
    return f"{name}<{m.group(1)}>" if m else name


def main(argv=None) -> int:
    from . import exp_demod, variants
    ap = argparse.ArgumentParser(prog="sass_chain",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another demod loop source, repeatable")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs the card")
    dev = torch.device("cuda")
    lat = latencies(dev)
    print("latencies " + json.dumps(lat), flush=True)
    for name, k in variants.candidates(_kernels.DEMOD_LOOP, args.source,
                                       exp_demod.adapted):
        chains = step_chains(disassemble(k.build()), lat)
        print(f"{name} " + json.dumps(chains), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
