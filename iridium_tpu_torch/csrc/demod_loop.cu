// Demodulator symbol loop: the Gardner timing loop with the PLL fused into
// it, or (--no-gardner) strided decimation and then the PLL. One thread per
// burst walks the S symbols with its carry (position, timing integrator,
// last symbol, done flag, PLL phasor, summed corrections) in registers, and
// writes each symbol's PLL output and valid flag, active or not.
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
// are far below either peak. What bounds the kernel is latency:
// each burst is a chain of S dependent steps, and a step's sample reads
// wait on an address computed from the last step's position. The design
// keeps that chain short and parallel: the carry lives in registers, the
// samples come through the read-only L1 path (the position advances ~sps
// samples a step, so most reads hit the line the previous step brought
// in), and blocks of 32 threads spread even the 48-burst batch over SMs.
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

namespace {

constexpr int kThreads = 32;

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

// Catmull-Rom interpolation at `pos` with the reference's clamps
// (dsp/demod.py `_cubic4`): mu keeps the fraction before the clamp; the
// index truncates toward zero (pos is negative early in a burst), is
// clamped to [1, n - 3] (below 1 when n < 4), and the 4-sample read to
// the row.
__device__ __forceinline__ cf cubic4(const float2* __restrict__ row,
                                     long long L, float pos, long long n) {
  const long long idx0 = (long long)pos;
  const float mu = pos - (float)idx0;
  long long idx = idx0 < 1 ? 1 : idx0;
  idx = idx < n - 3 ? idx : n - 3;
  long long base = idx - 1;
  base = base < 0 ? 0 : base;
  base = base > L - 4 ? L - 4 : base;
  const float2 s0 = __ldg(row + base);
  const float2 s1 = __ldg(row + base + 1);
  const float2 s2 = __ldg(row + base + 2);
  const float2 s3 = __ldg(row + base + 3);
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

struct Pll {
  cf phi = {1.0f, 0.0f};
  float total = 0.0f;

  // one PLL step on `sym` (dsp/demod.py `_pll_update`); returns sym * phi
  __device__ __forceinline__ cf step(cf sym, bool v) {
    const cf out = cmul(sym, phi);
    const cf xh_conj = {out.re >= 0.0f ? kSqrt1_2 : -kSqrt1_2,
                        out.im >= 0.0f ? -kSqrt1_2 : kSqrt1_2};
    const cf er = cmul(xh_conj, out);
    const bool skip = hypotf(er.re, er.im) < kSkip;
    const float sc = kAlpha * atan2f(er.im, er.re);
    const cf corr_conj = {cosf(sc), -sinf(sc)};
    cf phi2 = cmul(corr_conj, phi);
    const float pm = hypotf(phi2.re, phi2.im);
    if (pm > 0.0f) phi2 = {phi2.re / pm, phi2.im / pm};
    if (v && !skip) {
      phi = phi2;
      total = total + sc;
    }
    return out;
  }
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;          // NaN passes through, as torch.clamp's
  return v > hi ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
gardner_kernel(const float2* __restrict__ x, long long L,
               const long long* __restrict__ n_samp, int B, int S,
               float sps, float half, float2* __restrict__ out,
               unsigned char* __restrict__ valid,
               float* __restrict__ total) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float2* row = x + (long long)b * L;
  const long long n = n_samp[b];
  const float lim = (float)n - 3.0f;
  float pos = 0.0f, tmo = 0.0f;
  cf prev = {0.0f, 0.0f};
  bool done = false;
  Pll pll;
  float2* o = out + (long long)b * S;
  unsigned char* vo = valid + (long long)b * S;
  for (int t = 0; t < S; ++t) {
    const bool active = !done && pos < lim;
    done = done || !active;
    const cf on = cubic4(row, L, pos, n);
    const float midpos = pos - half;
    const cf mid = cubic4(row, L, midpos, n);
    const bool do_mid = t > 0 && midpos >= 1.0f;
    // real part of (prev - on) * conj(mid)
    const cf d = {prev.re - on.re, prev.im - on.im};
    const float err = clampf(cmul(d, {mid.re, -mid.im}).re, -1.0f, 1.0f);
    const float tmo2 = do_mid ? tmo + kKi * err : tmo;
    const float adjust = clampf(kKp * err + tmo2, -0.5f, 0.5f);
    const float pos2 = do_mid ? pos + adjust : pos;
    const cf y = pll.step(on, active);
    if (active) {
      pos = pos2 + sps;
      tmo = tmo2;
      prev = on;
    }
    o[t] = make_float2(y.re, y.im);
    vo[t] = active;
  }
  total[b] = pll.total;
}

__global__ void __launch_bounds__(kThreads)
simple_kernel(const float2* __restrict__ x, long long L,
              const long long* __restrict__ n_samp, int B, int S, int isps,
              float2* __restrict__ out, unsigned char* __restrict__ valid,
              float* __restrict__ total) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float2* row = x + (long long)b * L;
  const long long n = n_samp[b];
  Pll pll;
  float2* o = out + (long long)b * S;
  unsigned char* vo = valid + (long long)b * S;
  for (int t = 0; t < S; ++t) {
    const long long i = (long long)t * isps;
    const bool v = i < n;
    const long long j = i < 0 ? 0 : (i > L - 1 ? L - 1 : i);
    const float2 s = __ldg(row + j);
    const cf y = pll.step({s.x, s.y}, v);
    o[t] = make_float2(y.re, y.im);
    vo[t] = v;
  }
  total[b] = pll.total;
}

}  // namespace

// x (B, L) c64 as float2, n_samp (B,) i64; out (B, S) c64 as float2,
// valid (B, S) u8, total (B,) f32. `half` is sps * 0.5 rounded to f32 and
// `isps` round(sps) (--no-gardner's stride).
extern "C" int demod_loop(const float2* x, long long L,
                          const long long* n_samp, int B, int S, float sps,
                          float half, int isps, int gardner, float2* out,
                          unsigned char* valid, float* total,
                          cudaStream_t stream) {
  if (B <= 0) return 0;
  if (L < 4 || S < 0) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  if (gardner)
    gardner_kernel<<<grid, kThreads, 0, stream>>>(x, L, n_samp, B, S, sps,
                                                  half, out, valid, total);
  else
    simple_kernel<<<grid, kThreads, 0, stream>>>(x, L, n_samp, B, S, isps,
                                                 out, valid, total);
  return (int)cudaGetLastError();
}

extern "C" const char* demod_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
