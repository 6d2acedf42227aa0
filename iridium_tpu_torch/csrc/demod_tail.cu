// Demod tail: the demodulator's decisions after its symbol loop, and the
// packing of a class batch's output rows, in two launches a class batch
// (dsp/demod.py `Demod.decide`, runtime/pipeline.py `pack_outputs`; the
// loop itself is csrc/demod_loop.cu).
//   stage 0 (decide, a warp a burst, kWarps bursts a block): from the loop
//     kernel's outputs out (B, S, 2) f32 and valid (B, S) u8, and the
//     bursts' direction (B,) i32: n_sym, the running max of the valid
//     magnitudes, the first triple of symbols below it by MAGNITUDE_DROP
//     (the end-of-frame trim) and from it `actual`; the symbols whose phase
//     lies within CONFIDENCE_ANGLE of a quadrant's centre (confidence) and
//     the mean magnitude (level) over the first `actual`; the hard and soft
//     unique-word checks over the first kUW symbols for DL and UL, and from
//     them ok and direction; the DQPSK differential decode into bits (B, 2S)
//     i32 and the LLRs (B, 2S) f32 with their scale, zero from 2 actual on.
//   stage 1 (pack, a warp a row): from the bits and LLRs and the downmix's
//     and demodulator's per-burst fields, the (B, W) i32 row of
//     runtime/pipeline.py's layout: the bit words, with want_llr the LLR
//     scale (the row's largest LLR) and the u16 quanta two to a word, then
//     4 float words and 7 int words; the bits and quanta zero-padded to
//     s2_pad.
//
// Replaces: no pl.pallas_call. iridium_tpu/dsp/demod.py `demod` after its
// scans (:258-347) and iridium_tpu/runtime/pipeline.py `pack_outputs`
// (:81-117), which XLA compiles into the jitted group program; the plain
// versions are dsp/demod.py `Demod.decide_plain` and runtime/pipeline.py
// `pack_plain` (~170 and ~30 tensor operations).
//
// Bound on the H100, as iridium_tpu_torch/tools/exp_demod_tail.py `bound`
// counts what its rows need at the 10 MHz small-normal batch (1,024 bursts
// x 205 symbols): bytes, each input read once where the trim reads it (the
// valid flags, the symbols up to the trim or the unique word) and each
// output written once (the bits and LLRs, the rows), ~5 MB for both, ~1.5
// us at 3.35 TB/s; the operations (atan2f, hypotf and fmodf a symbol) are
// far below. So the launches are bound by their launch: the design keeps
// each burst in one warp, with no shared memory and no block barrier.
//
// Design: decide walks a burst's symbols 32 at a time, a lane a symbol, in
// three passes over its row (the second and third from L1): the trim
// (ballots of the valid and low flags, a shuffle scan for the running
// max), the decisions with their sums (shuffles), the LLRs once their
// scale is known. pack builds each bit word with one warp add
// (`__reduce_add_sync`), the LLR scale with a shuffle max, and writes a
// row's quanta a word a lane.
//
// Arithmetic: the twins', in their order, so that each launch is bit-equal
// to its twin on the card (built with --fmad=false, as the twins' separate
// tensor operations round each product and sum). |x| is PyTorch's complex
// abs on the card, hypotf; atan2f and fmodf are torch.atan2 and torch.fmod;
// a Python scalar in an operation with an f32 tensor is taken in f32, a
// division by one is the product with its f32 reciprocal, `c / t` for a
// Python scalar c is `t.reciprocal() * c`; torch.round is rintf; the two f32
// sums (the magnitudes, the soft UW error) take the twin's order
// (`demod.warp_sum`: a lane's column summed chunk by chunk, then a
// butterfly); the running max and the LLR scale take NaN as torch.cummax
// and amax do. The bit words and quanta are sums of disjoint bits mod 2^32,
// so their order does not matter. A row's LLR scale may differ from the
// twin's in the sign of a zero where the row's largest LLR is +0 and -0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // bursts (decide) or rows (pack)
constexpr int kThreads = 32 * kWarps;     //   a block
constexpr unsigned kAll = 0xffffffffu;
constexpr int kUW = 12;                   // iridium.UW_LENGTH
constexpr int kLowRun = 3;                // demod.MAX_LOW_COUNT
constexpr int kMaxPtrs = 16;
constexpr int kMaxInts = 4;
constexpr int kMaxFloats = 4;

// the Python constants of dsp/demod.py, each as the f32 PyTorch takes it
constexpr double kPiD = 3.141592653589793;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2 * kPiD);
constexpr float kDegrees = static_cast<float>(180.0 / kPiD);
constexpr float kQuarterPi = static_cast<float>(kPiD * 0.25);
constexpr float kHalfPi = static_cast<float>(kPiD * 0.5);
constexpr float kTwoOverPi = static_cast<float>(2.0 / kPiD);
constexpr float kSqrt1_2 = static_cast<float>(0.70710678118654752);

// max with a NaN kept (torch.cummax, amax)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// the hard decision: the quadrant of (re, im), 0 at re >= 0 and im >= 0
// (so also at -0)
__device__ __forceinline__ int quadrant(float2 s) {
  if (s.x >= 0.f && s.y >= 0.f) return 0;
  if (s.x < 0.f && s.y >= 0.f) return 1;
  return s.x < 0.f ? 2 : 3;
}

// `warp_sum`'s butterfly over a warp: every lane gets the sum
__device__ __forceinline__ float butterfly(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// a soft UW check's |angle - expected| for symbol quadrant u
__device__ __forceinline__ float soft_distance(float ang, long long u) {
  const float expected = static_cast<float>(u) * kHalfPi + kQuarterPi;
  float d = ang - expected;
  d = d > kPi ? d - kTwoPi : d;
  d = d < -kPi ? d + kTwoPi : d;
  return fabsf(d);
}

// a hard UW check's distance between symbol h and u (3 counts as 1)
__device__ __forceinline__ int hard_distance(int h, long long u) {
  const long long d = llabs(static_cast<long long>(h) - u);
  return d == 3 ? 1 : static_cast<int>(d);
}

struct DecideArgs {
  const float2* out;
  const unsigned char* valid;
  const int* direction;
  const long long* uw_dl;
  const long long* uw_ul;
  const long long* dqpsk_map;
  bool* ok;
  int* direction_out;
  int* n_symbols;
  int* confidence;
  float* level;
  int2* bits;       // (B, S) pairs of the (B, 2S) bits
  float2* llr;      // (B, S) pairs of the (B, 2S) LLRs
  int B;
  int S;
  int max_errors;   // UW_MAX_ERRORS
  float drop_inv;   // 1 / MAGNITUDE_DROP
  float conf_angle;
  float soft_threshold;
};

__global__ void __launch_bounds__(kThreads) decide_kernel(DecideArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= a.B) return;                   // the whole warp
  const int S = a.S;
  const float2* row = a.out + static_cast<long long>(b) * S;
  const unsigned char* vrow = a.valid + static_cast<long long>(b) * S;

  // pass 1: n_sym and the first triple of low symbols (the trim)
  int n_sym = 0, trip = -1;
  float carry = -INFINITY;
  unsigned prev_low = 0;
  for (int t0 = 0; t0 < S; t0 += 32) {
    const int t = t0 + lane;
    const bool v = t < S && vrow[t] != 0;
    float mag = 0.f;
    if (t < S) {
      const float2 s = row[t];
      mag = hypotf(s.x, s.y);
    }
    // the running max of where(valid, mags, -inf): an inclusive scan
    float c = v ? mag : -INFINITY;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kAll, c, o);
      if (lane >= o) c = max_nan(y, c);
    }
    c = max_nan(carry, c);
    carry = __shfl_sync(kAll, c, 31);
    const unsigned low = __ballot_sync(kAll, v && mag < c * a.drop_inv);
    n_sym += __popc(__ballot_sync(kAll, v));
    // bit i + 2: symbol t0 + i low; bits 0 and 1: t0 - 2 and t0 - 1
    const unsigned long long e =
        (static_cast<unsigned long long>(low) << 2) | (prev_low >> 30);
    const unsigned trips = static_cast<unsigned>(e >> 2) &
                           static_cast<unsigned>(e >> 1) &
                           static_cast<unsigned>(e);
    if (trips) {
      trip = t0 + __ffs(trips) - 1;
      break;
    }
    prev_low = low;
  }
  const int actual = trip >= 0 ? trip + 1 - kLowRun : n_sym;

  // pass 2: confidence, the magnitudes' sum, the UW checks, the bits
  int n_ok = 0, prev_hard = 0, hard_dl = 0, hard_ul = 0;
  float acc = 0.f, soft_dl = 0.f, soft_ul = 0.f;
  int2* brow = a.bits + static_cast<long long>(b) * S;
  for (int t0 = 0; t0 < S; t0 += 32) {
    const int t = t0 + lane;
    const bool m = t < actual;
    const float2 s = t < S ? row[t] : make_float2(0.f, 0.f);
    const int h = quadrant(s);
    int p = __shfl_up_sync(kAll, h, 1);
    if (lane == 0) p = prev_hard;
    prev_hard = __shfl_sync(kAll, h, 31);
    acc += m ? hypotf(s.x, s.y) : 0.f;
    const float ang = atan2f(s.y, s.x);
    const float phase = (ang + kPi) * kDegrees;
    const float offset = 45.0f - fmodf(phase, 90.0f);
    n_ok += __popc(__ballot_sync(kAll, m && fabsf(offset) <= a.conf_angle));
    if (t < S) {
      const int dec = static_cast<int>(a.dqpsk_map[(h - p) & 3]);
      brow[t] = m ? make_int2((dec >> 1) & 1, dec & 1) : make_int2(0, 0);
    }
    if (t0 == 0) {
      float sd = 0.f, su = 0.f;
      int hd = 0, hu = 0;
      if (lane < kUW) {
        const float a2 = ang < 0.f ? ang + kTwoPi : ang;
        sd = soft_distance(a2, a.uw_dl[lane]);
        su = soft_distance(a2, a.uw_ul[lane]);
        hd = hard_distance(h, a.uw_dl[lane]);
        hu = hard_distance(h, a.uw_ul[lane]);
      }
      soft_dl = butterfly(sd);
      soft_ul = butterfly(su);
      hard_dl = __reduce_add_sync(kAll, hd);
      hard_ul = __reduce_add_sync(kAll, hu);
    }
  }
  const float sum_mag = butterfly(acc);

  const bool long_enough = actual >= kUW;
  const bool dl_ok = long_enough && hard_dl <= a.max_errors;
  const bool ul_ok = long_enough && hard_ul <= a.max_errors;
  const bool both_fail = !dl_ok && !ul_ok;
  const float dl_err = long_enough ? soft_dl * kTwoOverPi : 999.0f;
  const float ul_err = long_enough ? soft_ul * kTwoOverPi : 999.0f;
  // torch.minimum keeps a NaN
  const float min_err =
      (isnan(dl_err) || isnan(ul_err)) ? NAN : fminf(dl_err, ul_err);
  const int safe_n = actual > 1 ? actual : 1;
  const float mean = sum_mag / static_cast<float>(safe_n);
  const float scale =
      (actual > 0 && sum_mag > 0.f) ? (1.0f / mean) * kSqrt1_2 : 1.0f;
  if (lane == 0) {
    a.ok[b] = !both_fail || min_err <= a.soft_threshold;
    int dir;
    if (both_fail)
      dir = ul_err < dl_err ? 1 : 0;
    else if (ul_ok && !dl_ok)
      dir = 1;
    else if (dl_ok && !ul_ok)
      dir = 0;
    else
      dir = a.direction[b];
    a.direction_out[b] = dir;
    a.n_symbols[b] = actual;
    a.confidence[b] =
        actual > 0 ? static_cast<int>((100LL * n_ok) / safe_n) : 0;
    a.level[b] = actual > 0 ? mean : 0.f;
  }

  // pass 3: the LLRs
  float2* lrow = a.llr + static_cast<long long>(b) * S;
  for (int t = lane; t < S; t += 32) {
    const float2 s = row[t];
    lrow[t] = t < actual ? make_float2(fabsf(s.x) * scale, fabsf(s.y) * scale)
                         : make_float2(0.f, 0.f);
  }
}

struct PackArgs {
  const int* bits;    // (B, S2)
  const float* llr;   // (B, S2)
  const float* floats[4];          // fine_offset, level, total_phase,
                                   // uw_corr
  const unsigned char* oks[2];     // dm.ok, dd.ok
  const int* ints[5];              // n_symbols, confidence, direction,
                                   // start_dec, n_samples
  int* rows;          // (B, W)
  int B;
  int S2;
  int s2_pad;
  int want_llr;
  int W;
};

// an LLR's u16 quantum: clamp(round(llr k), 0, 65535), k = 65535 / scale
// (a NaN gives 0, as its int64 cast's low 16 bits do in the twin)
__device__ __forceinline__ unsigned quantum(float x, float k) {
  return static_cast<unsigned>(fminf(fmaxf(rintf(x * k), 0.f), 65535.f));
}

__global__ void __launch_bounds__(kThreads) pack_kernel(PackArgs a) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= a.B) return;                   // the whole warp
  const int S2 = a.S2;
  const int* bits = a.bits + static_cast<long long>(r) * S2;
  int* out = a.rows + static_cast<long long>(r) * a.W;
  // the bit words: bit j of word w is bit 32 w + j
  const int NW = (a.s2_pad + 31) / 32;
  for (int w = 0; w < NW; ++w) {
    const int j = 32 * w + lane;
    const unsigned v = j < S2 ? static_cast<unsigned>(bits[j]) << lane : 0u;
    const unsigned word = __reduce_add_sync(kAll, v);
    if (lane == 0) out[w] = static_cast<int>(word);
  }
  int off = NW;
  if (a.want_llr) {
    const float* llr = a.llr + static_cast<long long>(r) * S2;
    float top = -INFINITY;
    for (int j = lane; j < S2; j += 32) top = max_nan(top, llr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      top = max_nan(top, __shfl_xor_sync(kAll, top, o));
    const float denom = top > 0.f ? top : 1.0f;
    const float k = (1.0f / denom) * 65535.0f;
    if (lane == 0) out[off] = __float_as_int(top);
    const int NL = (a.s2_pad + 1) / 2;
    for (int i = lane; i < NL; i += 32) {
      const int j = 2 * i;
      const unsigned lo = j < S2 ? quantum(llr[j], k) : 0u;
      const unsigned hi = j + 1 < S2 ? quantum(llr[j + 1], k) : 0u;
      out[off + 1 + i] = static_cast<int>(lo | (hi << 16));
    }
    off += 1 + NL;
  }
  if (lane < 4) {
    out[off + lane] = __float_as_int(a.floats[lane][r]);
  } else if (lane < 6) {
    out[off + lane] = a.oks[lane - 4][r] != 0;
  } else if (lane < 11) {
    out[off + lane] = a.ints[lane - 6][r];
  }
}

}  // namespace

// stage 0 (decide): ptrs out, valid, direction, uw_dl, uw_ul, dqpsk_map,
//   ok, direction_out, n_symbols, confidence, level, bits, llr; ints
//   UW_MAX_ERRORS; floats MAGNITUDE_DROP, CONFIDENCE_ANGLE,
//   UW_SOFT_THRESHOLD; n = S (at least kUW)
// stage 1 (pack): ptrs bits, llr, fine_offset, uw_corr, dm.ok, start_dec,
//   n_samples, level, total_phase, dd.ok, n_symbols, confidence,
//   direction, rows; ints s2_pad, want_llr, W; n = S2 (bits a row)
// A count other than the stage's, or a shape the kernel does not take, is
// refused (cudaErrorInvalidValue) before anything is launched.
extern "C" int demod_tail(int stage, int B, long long n,
                          void* const* ptrs, int n_ptrs,
                          const long long* ints, int n_ints,
                          const float* floats, int n_floats,
                          cudaStream_t stream) {
  static const int kCounts[2][3] = {{13, 1, 3}, {14, 3, 0}};
  if (stage < 0 || stage > 1 || n_ptrs != kCounts[stage][0] ||
      n_ints != kCounts[stage][1] || n_floats != kCounts[stage][2] ||
      n_ptrs > kMaxPtrs || n_ints > kMaxInts || n_floats > kMaxFloats)
    return (int)cudaErrorInvalidValue;
  if (B < 0 || n < 1 || n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  void* const* p = ptrs;
  if (stage == 0) {
    if (n < kUW || floats[0] == 0.f) return (int)cudaErrorInvalidValue;
    DecideArgs a{(const float2*)p[0],      (const unsigned char*)p[1],
                 (const int*)p[2],         (const long long*)p[3],
                 (const long long*)p[4],   (const long long*)p[5],
                 (bool*)p[6],              (int*)p[7],
                 (int*)p[8],               (int*)p[9],
                 (float*)p[10],            (int2*)p[11],
                 (float2*)p[12],           B,
                 (int)n,                   (int)ints[0],
                 // PyTorch's division by the Python scalar: the product
                 // with its f32 reciprocal
                 1.0f / floats[0],         floats[1],
                 floats[2]};
    decide_kernel<<<blocks, kThreads, 0, stream>>>(a);
  } else {
    const long long s2_pad = ints[0], want_llr = ints[1], W = ints[2];
    const long long nw = (s2_pad + 31) / 32;
    const long long nl = want_llr ? 1 + (s2_pad + 1) / 2 : 0;
    if (s2_pad < n || s2_pad >= (1LL << 30) || (want_llr != 0 &&
        want_llr != 1) || W != nw + nl + 11)
      return (int)cudaErrorInvalidValue;
    PackArgs a{};
    a.bits = (const int*)p[0];
    a.llr = (const float*)p[1];
    a.floats[0] = (const float*)p[2];     // fine_offset
    a.floats[1] = (const float*)p[7];     // level
    a.floats[2] = (const float*)p[8];     // total_phase
    a.floats[3] = (const float*)p[3];     // uw_corr
    a.oks[0] = (const unsigned char*)p[4];
    a.oks[1] = (const unsigned char*)p[9];
    a.ints[0] = (const int*)p[10];        // n_symbols
    a.ints[1] = (const int*)p[11];        // confidence
    a.ints[2] = (const int*)p[12];        // direction
    a.ints[3] = (const int*)p[5];         // start_dec
    a.ints[4] = (const int*)p[6];         // n_samples
    a.rows = (int*)p[13];
    a.B = B;
    a.S2 = (int)n;
    a.s2_pad = (int)s2_pad;
    a.want_llr = (int)want_llr;
    a.W = (int)W;
    pack_kernel<<<blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* demod_tail_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
