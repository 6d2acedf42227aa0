// Demodulator symbol loop: the Gardner timing loop with the PLL fed by it,
// or (--no-gardner) strided decimation and then the PLL. Each burst's
// PLL output and valid flag are written for every symbol, active or not.
//
// Replaces: iridium_tpu/dsp/demod.py, make_demod's compiled scans
// gardner_pll (:142-171), gardner_pll_win (:193-230) and pll_only
// (:238-247), which the JAX package runs as one lax.scan with (batch,)
// carries. The plain version is dsp/demod.py `loop_plain`: a Python loop of
// ~130 tensor operations a symbol, each a launch (or a graph node) on the
// card.
//
// Bound on the H100: with each input byte read once and each output byte
// written once ((B, L) c64 rows in; (B, S) c64 outputs and u8 flags out),
// a few microseconds at the class batches; ~150 FP32 operations a symbol
// are far below either peak. What bounds the kernel is latency: each
// burst is a chain of S dependent steps, in two chains. The timing chain
// (position -> sample reads -> Gardner error -> position) does not depend
// on the PLL; the PLL chain (phasor -> product -> atan2f -> cosf, sinf ->
// product -> hypotf -> division -> phasor) depends on the timing chain
// only through each step's interpolated symbol. The kernel's first
// design (a thread a burst, rows read through L1 and L2, two strided
// stores a step; in the git history, timed beside this one by
// tools/exp_demod.py --source) ran both chains in one thread in program
// order, ~0.94 us a step on the H100. This design takes ~0.39-0.45 us
// (PERF.md): the PLL chain. Its dependent chain, counted from the SASS
// with measured latencies (tools/sass_chain.py), is ~170 ns; the rest is
// one warp issuing in order through the branches of atan2f, hypotf and
// IEEE division, which libdevice keeps for their slow paths.
//
// Design: a block of P bursts (`demod_plan.h`, dsp/demod.py `plan`; the C
// entry refuses any other plan) runs two warps, a lane of each a burst.
//   - Warp 0 produces. In Gardner mode it walks the timing chain: each
//     burst's row comes into a ring in shared memory by 1-D bulk copies
//     (cp.async.bulk, completing on an mbarrier a ring slot; no tensor
//     map, so capturable into a graph) of `chunk` samples, the whole row
//     where it fits in the ring, else slots refilled ahead of the walk
//     (reads only move forward: `pos` grows by sps + adjust, adjust in
//     [-0.5, 0.5], `midpos` trails by sps / 2, the clamps only pull the
//     base into [0, L - 4], and an inactive step re-reads the last
//     position). A row whose samples are not 16-byte aligned (odd L) is
//     shifted by one sample in its ring: the bulk copies take the aligned
//     middle of each chunk and plain loads its ragged ends. Positions and
//     indices are 32-bit (the wrapper refuses L >= 2^31). In
//     --no-gardner mode there is no timing chain: the producer loads the
//     S strided samples of each burst ahead, as independent loads.
//   - Warp 1 runs the PLL on each step's symbol and active flag, which it
//     takes from a shared-memory buffer of kSteps steps that the producer
//     fills; two buffers, handed over by named barriers once per chunk of
//     steps (full: producer arrives, PLL waits; empty: the reverse). So a
//     step costs the longer of the two chains, not their sum. The PLL
//     writes its outputs over the symbols in the buffer, and then the
//     chunk goes out coalesced: a burst's kSteps outputs and flags as
//     contiguous runs, in place of two strided stores a step.
//
// Arithmetic: the plain loop's tensor operations in f32, one for one and in
// their order, so that on the card the kernel is bit-equal to `loop_plain`
// (tools/exp_demod.py checks it, and that the complex product and magnitude
// below are PyTorch's). Every product and sum is rounded on its own, as
// separate tensor operations round them: the source is built with
// --fmad=false (left to contract, the Gardner loop parts from the plain one
// within a few symbols) and no fast math (IEEE division, full-precision
// atan2f, cosf, sinf). A complex product is `cmul`, PyTorch's; a product of
// a real by a complex (or by a real scalar) is rounded per component. A
// complex magnitude is hypotf, which PyTorch's complex `abs` calls on the
// card (thrust::abs).

#include <cuda_runtime.h>

#include <cstdint>

#include "demod_plan.h"

namespace {

using demod_plan::kSteps;
using demod_plan::kThreads;
static_assert(kSteps == 32, "a chunk of steps is a step a lane");

// named barriers (0 is __syncthreads): a buffer full, a buffer empty
constexpr int kFull = 1;
constexpr int kEmpty = 3;

// the Python constants as PyTorch casts them to f32
constexpr float kSqrt1_2 = static_cast<float>(0.70710678118654752);
constexpr float kAlpha = static_cast<float>(0.2);
constexpr float kKp = static_cast<float>(0.02);
constexpr float kKi = static_cast<float>(0.0002);
constexpr float kSkip = static_cast<float>(1e-10);

struct cf {
  float re, im;
};

// (a + bi)(c + di) as PyTorch's CUDA complex product computes it: its
// c10::complex operator*= is (a c - b d) + (a d + b c) i, and PyTorch's
// build contracts each part into one fused multiply-add whose addend is
// the second product, rounded
__device__ __forceinline__ cf cmul(cf x, cf y) {
  return {__fmaf_rn(x.re, y.re, -(x.im * y.im)),
          __fmaf_rn(x.re, y.im, x.im * y.re)};
}

struct Pll {
  cf phi = {1.0f, 0.0f};
  float total = 0.0f;

  // one PLL step on `sym` (dsp/demod.py `_pll_update`); returns sym * phi.
  // An inactive step changes neither phi nor total, so it computes its
  // output alone: a burst past its end (a batch's unused rows are zeros,
  // whose magnitude and angle take hypotf's and atan2f's slow paths)
  // costs its warp nothing more. The normalisation divides
  // unconditionally and selects: the same values as dividing only where
  // pm > 0. Each change keeps the plain loop's values and takes branches
  // off the chain, which the warp would otherwise issue one after another.
  __device__ __forceinline__ cf step(cf sym, bool v) {
    const cf out = cmul(sym, phi);
    if (!v) return out;
    const cf xh_conj = {out.re >= 0.0f ? kSqrt1_2 : -kSqrt1_2,
                        out.im >= 0.0f ? -kSqrt1_2 : kSqrt1_2};
    const cf er = cmul(xh_conj, out);
    // hypotf(er) >= the larger part less 3 ulp, so above 2e-10 it is not
    // under kSkip: the magnitude is taken only for a tiny error
    const float big = fmaxf(fabsf(er.re), fabsf(er.im));
    const bool skip = big < 2e-10f && hypotf(er.re, er.im) < kSkip;
    const float sc = kAlpha * atan2f(er.im, er.re);
    // one range reduction for both: sincosf's values are sinf's and cosf's
    float sn, cs;
    sincosf(sc, &sn, &cs);
    const cf corr_conj = {cs, -sn};
    const cf phi2 = cmul(corr_conj, phi);
    const float pm = hypotf(phi2.re, phi2.im);
    const cf q = {phi2.re / pm, phi2.im / pm};
    if (!skip) {
      phi = pm > 0.0f ? q : phi2;
      total = total + sc;
    }
    return out;
  }
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;          // NaN passes through, as torch.clamp's
  return v > hi ? hi : v;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned n, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// The Catmull-Rom read position of `pos` with the reference's clamps
// (dsp/demod.py `_cubic4`): mu keeps the fraction before the clamp; the
// index truncates toward zero (pos is negative early in a burst), is
// clamped to [1, n - 3] (below 1 when n < 4), and the 4-sample read to
// the row. `n` is the burst's length clamped to [-8, L + 8], which gives
// the same base as the length itself.
struct Tap {
  int base;
  float mu;
};

__device__ __forceinline__ Tap tap(float pos, int n, int L) {
  const int idx0 = (int)pos;
  const float mu = pos - (float)idx0;
  int idx = idx0 < 1 ? 1 : idx0;
  idx = idx < n - 3 ? idx : n - 3;
  int base = idx - 1;
  base = base < 0 ? 0 : base;
  base = base > L - 4 ? L - 4 : base;
  return {base, mu};
}

// The interpolation at a tap from the burst's ring: sample i lies at
// ring[(i + sh) & mask]
__device__ __forceinline__ cf cubic4(const float2* ring, int mask, int sh,
                                     Tap p) {
  const int r = p.base + sh;
  const float2 s0 = ring[r & mask];
  const float2 s1 = ring[(r + 1) & mask];
  const float2 s2 = ring[(r + 2) & mask];
  const float2 s3 = ring[(r + 3) & mask];
  const float mu = p.mu;
  const float mu2 = mu * mu;
  const float mu3 = mu2 * mu;
  const float ar = -0.5f * s0.x + 1.5f * s1.x - 1.5f * s2.x + 0.5f * s3.x;
  const float ai = -0.5f * s0.y + 1.5f * s1.y - 1.5f * s2.y + 0.5f * s3.y;
  const float br = s0.x - 2.5f * s1.x + 2.0f * s2.x - 0.5f * s3.x;
  const float bi = s0.y - 2.5f * s1.y + 2.0f * s2.y - 0.5f * s3.y;
  const float cr = -0.5f * s0.x + 0.5f * s2.x;
  const float ci = -0.5f * s0.y + 0.5f * s2.y;
  return {ar * mu3 + br * mu2 + cr * mu + s1.x,
          ai * mu3 + bi * mu2 + ci * mu + s1.y};
}

// One burst's row ring: chunk c (samples [c * chunk, c * chunk + chunk)
// of the samples [0, need) the walk can read) goes to slot c % slots,
// loaded in chunk order, `slots` at most in flight or resident.
struct Ring {
  float2* ring;
  const float2* row;
  uint32_t bars;          // the burst's first slot mbarrier
  int mask, sh, need, chunk_shift, slot_shift, nch;
  int issued = 0, ready = 0;

  // the bulk copy of chunk c: the 16-byte aligned middle by cp.async.bulk,
  // a ragged first or last sample by a plain load
  __device__ void issue(int c) {
    const int chunk = 1 << chunk_shift;
    const int e = c * chunk;
    const int cnt = min(chunk, need - e);
    const int m = (cnt - sh) & ~1;
    if (sh) ring[(e + sh) & mask] = row[e];
    if (cnt - sh - m) ring[(e + cnt - 1 + sh) & mask] = row[e + cnt - 1];
    const uint32_t bar = bars + 8 * (c & ((1 << slot_shift) - 1));
    // the walk's reads of the slot's last chunk come before the copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (m)
      bulk_load(smem(ring + ((e + 2 * sh) & mask)), row + e + sh, 8u * m,
                bar);
    else
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
  }

  // chunks below `lo` are read no more; every chunk up to `hi` is resident
  __device__ void sync(int lo, int hi) {
    const int slots = 1 << slot_shift;
    while (issued < nch && issued < lo + slots) issue(issued++);
    while (ready <= hi) {
      mbar_wait(bars + 8 * (ready & (slots - 1)), (ready >> slot_shift) & 1);
      ++ready;
    }
  }

  // every copy issued has landed: none may be in flight when the block
  // leaves its shared memory
  __device__ void drain() {
    for (; ready < issued; ++ready)
      mbar_wait(bars + 8 * (ready & ((1 << slot_shift) - 1)),
                (ready >> slot_shift) & 1);
  }

  // the first sample a step may read before `sync` is due again
  __device__ int ready_end() const { return ready << chunk_shift; }
  // the least read base at which another chunk can be issued
  __device__ int refill_at() const {
    return issued < nch ? (issued - (1 << slot_shift) + 1) << chunk_shift
                        : 0x7fffffff;
  }
};

struct Args {
  const float2* x;
  const long long* n_samp;
  float2* out;
  unsigned char* valid;
  float* total;
  int L, B, S, isps, P, ring, chunk;
  float sps, half;
};

// the buffers of kSteps steps: symbols and flags of (buffer, step, burst)
struct Steps {
  float2* sym;
  unsigned char* act;
  int pad;
  __device__ int at(int k, int i, int p) const {
    return (k * kSteps + i) * pad + p;
  }
};

__device__ void timing_warp(const Args& a, const Steps& st, float2* rows,
                            uint32_t bars, int nchunks) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * a.P + lane;
  const bool live = lane < a.P && b < a.B;
  const long long n64 = live ? a.n_samp[b] : 0;
  const int n = (int)(n64 < -8 ? -8 : (n64 > a.L + 8 ? a.L + 8 : n64));
  const float lim = (float)n64 - 3.0f;
  Ring r;
  r.ring = rows + (size_t)lane * a.ring;
  r.row = a.x + (size_t)(live ? b : 0) * a.L;
  r.bars = bars + 8 * lane * (a.ring / a.chunk);
  r.mask = a.ring - 1;
  r.sh = (int)((reinterpret_cast<uintptr_t>(r.row) >> 3) & 1);
  r.need = min(a.L, max(n, 4));
  r.chunk_shift = __ffs(a.chunk) - 1;
  r.slot_shift = __ffs(a.ring / a.chunk) - 1;
  r.nch = (r.need + a.chunk - 1) >> r.chunk_shift;
  float pos = 0.0f, tmo = 0.0f;
  cf prev = {0.0f, 0.0f};
  bool done = false;
  int ready_end = 0, refill_at = 0;
  for (int j = 0; j < nchunks; ++j) {
    const int k = j & 1;
    if (j >= 2) bar_sync(kEmpty + k);
    const int t0 = j * kSteps;
    const int nt = min(kSteps, a.S - t0);
    for (int i = 0; live && i < nt; ++i) {
      const int t = t0 + i;
      const bool active = !done && pos < lim;
      done = done || !active;
      const Tap on_at = tap(pos, n, a.L);
      const float midpos = pos - a.half;
      const Tap mid_at = tap(midpos, n, a.L);
      if (on_at.base + 3 >= ready_end || mid_at.base >= refill_at) {
        r.sync(mid_at.base >> r.chunk_shift,
               (on_at.base + 3) >> r.chunk_shift);
        ready_end = r.ready_end();
        refill_at = r.refill_at();
      }
      const cf on = cubic4(r.ring, r.mask, r.sh, on_at);
      const cf mid = cubic4(r.ring, r.mask, r.sh, mid_at);
      const bool do_mid = t > 0 && midpos >= 1.0f;
      // real part of (prev - on) * conj(mid)
      const cf d = {prev.re - on.re, prev.im - on.im};
      const float err = clampf(cmul(d, {mid.re, -mid.im}).re, -1.0f, 1.0f);
      const float tmo2 = do_mid ? tmo + kKi * err : tmo;
      const float adjust = clampf(kKp * err + tmo2, -0.5f, 0.5f);
      const float pos2 = do_mid ? pos + adjust : pos;
      if (active) {
        pos = pos2 + a.sps;
        tmo = tmo2;
        prev = on;
      }
      st.sym[st.at(k, i, lane)] = make_float2(on.re, on.im);
      st.act[st.at(k, i, lane)] = active;
    }
    __syncwarp();
    bar_arrive(kFull + k);
  }
  if (live) r.drain();
}

__device__ void strided_warp(const Args& a, const Steps& st, int nchunks) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nchunks; ++j) {
    const int k = j & 1;
    if (j >= 2) bar_sync(kEmpty + k);
    const int t = j * kSteps + lane;      // a step a lane
    if (t < a.S) {
      const long long i = (long long)t * a.isps;
      const int c = (int)(i < 0 ? 0 : (i > a.L - 1 ? a.L - 1 : i));
#pragma unroll 4
      for (int p = 0; p < a.P; ++p) {
        const int b = blockIdx.x * a.P + p;
        if (b < a.B) {
          st.sym[st.at(k, lane, p)] = a.x[(size_t)b * a.L + c];
          st.act[st.at(k, lane, p)] = i < a.n_samp[b];
        }
      }
    }
    __syncwarp();
    bar_arrive(kFull + k);
  }
}

__device__ void pll_warp(const Args& a, const Steps& st, int nchunks) {
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * a.P;
  const bool live = lane < a.P && b0 + lane < a.B;
  Pll pll;
  for (int j = 0; j < nchunks; ++j) {
    const int k = j & 1;
    bar_sync(kFull + k);
    const int t0 = j * kSteps;
    const int nt = min(kSteps, a.S - t0);
    if (live) {
      float2 s = st.sym[st.at(k, 0, lane)];
      for (int i = 0; i < nt; ++i) {
        const float2 next = st.sym[st.at(k, i + 1 < nt ? i + 1 : i, lane)];
        const cf y = pll.step({s.x, s.y}, st.act[st.at(k, i, lane)]);
        st.sym[st.at(k, i, lane)] = make_float2(y.re, y.im);
        s = next;
      }
    }
    __syncwarp();
    // the chunk out: a burst's nt outputs and flags, contiguous, a step a
    // lane
    for (int p = 0; p < a.P && b0 + p < a.B; ++p) {
      if (lane < nt) {
        const size_t o = (size_t)(b0 + p) * a.S + t0 + lane;
        a.out[o] = st.sym[st.at(k, lane, p)];
        a.valid[o] = st.act[st.at(k, lane, p)];
      }
    }
    __syncwarp();
    if (j + 2 < nchunks) bar_arrive(kEmpty + k);
  }
  if (live) a.total[b0 + lane] = pll.total;
}

template <bool kGardner>
__global__ void __launch_bounds__(kThreads) demod_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int pad = a.P | 1;
  const int slots = kGardner ? a.ring / a.chunk : 0;
  float2* rows = reinterpret_cast<float2*>(shared);
  Steps st;
  st.pad = pad;
  st.sym = rows + (size_t)a.P * a.ring;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(st.sym + 2 * kSteps * pad);
  st.act = reinterpret_cast<unsigned char*>(bars + a.P * slots);
  if (kGardner) {
    for (int i = threadIdx.x; i < a.P * slots; i += kThreads)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nchunks = (a.S + kSteps - 1) / kSteps;
  if (threadIdx.x >= 32)
    pll_warp(a, st, nchunks);
  else if (kGardner)
    timing_warp(a, st, rows, smem(bars), nchunks);
  else
    strided_warp(a, st, nchunks);
}

}  // namespace

// Sets the kernels' dynamic shared memory limit, once, when the library is
// loaded (before any graph capture).
extern "C" int demod_loop_init() {
  cudaError_t err = cudaFuncSetAttribute(
      demod_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)demod_plan::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(demod_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)demod_plan::kSmemBytes);
  return (int)err;
}

// x (B, L) c64 as float2, n_samp (B,) i64; out (B, S) c64 as float2,
// valid (B, S) u8, total (B,) f32. `half` is sps * 0.5 rounded to f32 and
// `isps` round(sps) (--no-gardner's stride). (bursts, ring, chunk,
// threads) is `demod_plan::plan(B, L, S, gardner)`, or the call is
// refused; a ring that holds less than the row also needs the Gardner
// read span (sps / 2 + 4 samples) inside one chunk.
extern "C" int demod_loop(const float2* x, long long L,
                          const long long* n_samp, int B, int S, float sps,
                          float half, int isps, int gardner, int bursts,
                          int ring, int chunk, int threads, float2* out,
                          unsigned char* valid, float* total,
                          cudaStream_t stream) {
  if (B <= 0) return 0;
  if (L < 4 || L >= (1LL << 31) || S < 0) return (int)cudaErrorInvalidValue;
  const demod_plan::Plan p = demod_plan::plan(B, L, S, gardner != 0);
  if (bursts != p.bursts || ring != p.ring || chunk != p.chunk ||
      threads != p.threads)
    return (int)cudaErrorInvalidValue;
  if (gardner && ring < L && !(half + 8.0f < (float)chunk))
    return (int)cudaErrorInvalidValue;
  Args a{x, n_samp, out, valid, total, (int)L, B, S, isps, p.bursts,
         p.ring, p.chunk, sps, half};
  const int grid = (B + p.bursts - 1) / p.bursts;
  if (gardner)
    demod_kernel<true><<<grid, kThreads, p.smem, stream>>>(a);
  else
    demod_kernel<false><<<grid, kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* demod_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
