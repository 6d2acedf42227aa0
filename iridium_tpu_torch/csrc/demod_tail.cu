// Demod tail: the demodulator's decisions after its symbol loop and the
// packing of a class batch's output rows, in one launch (runtime/pipeline.py
// `decide_pack`; the loop itself is csrc/demod_loop.cu). From the loop
// kernel's outputs out (B, S, 2) f32 and valid (B, S) u8, and the
// downmix's per-burst fields: n_sym, the running max of the valid
// magnitudes, the first triple of symbols below it by MAGNITUDE_DROP (the
// end-of-frame trim) and from it `actual`; the symbols whose phase lies
// within CONFIDENCE_ANGLE of a quadrant's centre (confidence) and the mean
// magnitude (level) over the first `actual`; the hard and soft unique-word
// checks over the first kUW symbols for DL and UL, and from them ok and
// direction; the DQPSK differential decode into bits and the LLRs with
// their scale, zero from 2 actual on; then the (B, W) i32 row of
// runtime/pipeline.py's layout: the bit words, with want_llr the LLR scale
// (the row's largest LLR) and the u16 quanta two to a word, then 4 float
// words and 7 int words; the bits and quanta zero-padded to s2_pad. The
// bits and LLRs never reach device memory.
//
// Replaces: no pl.pallas_call. iridium_tpu/dsp/demod.py `demod` after its
// scans (:258-347) and iridium_tpu/runtime/pipeline.py `pack_outputs`
// (:81-117), which XLA compiles into the jitted group program; the plain
// version is runtime/pipeline.py `decide_pack_plain`, the composition of
// dsp/demod.py `Demod.decide_plain` and runtime/pipeline.py `pack_plain`
// (~200 tensor operations).
//
// Bound on the H100, as iridium_tpu_torch/tools/exp_demod_tail.py
// `fused_bound` counts what its rows need at the 10 MHz small-normal batch
// (1,024 bursts x 205 symbols): bytes, each input read once where the trim
// reads it (the valid flags, the symbols up to the trim or the unique
// word) and the rows written once, ~2 MB, under 1 us at 3.35 TB/s; the
// operations (atan2f, hypotf and fmodf a symbol) are far below. So the
// launch is bound by its latency: a launch, a read of the row, the
// dependent steps of the trim, the sums and the LLR scale, a write.
//
// Design: a burst to `wpb` warps (runtime/pipeline.py `tail_plan`), each a
// run of at most kMaxChunks chunks of 32 symbols, read once into registers
// at the start: the running max is each warp's shuffle scan over its
// chunks after the earlier warps' maxima (shared memory), the low flags go
// to shared memory as a word a chunk, and every warp finds the first
// triple there; each warp then writes its chunks' bit words (two half-warp
// ORs a chunk) and stages its lanes' magnitudes, which one warp sums in
// `warp_sum`'s order (a lane's column chunk by chunk, then the butterfly)
// to the level and the LLR scale; then the LLRs' largest over the warps,
// and each warp writes its chunks' quanta, a word a lane. Five barriers a
// burst (warp barriers where a burst is one warp).
//
// Arithmetic: the twins', in their order, so that the launch is bit-equal
// to its twin on the card (built with --fmad=false, as the twins' separate
// tensor operations round each product and sum). |x| is PyTorch's complex
// abs on the card, hypotf; atan2f and fmodf are torch.atan2 and torch.fmod;
// a Python scalar in an operation with an f32 tensor is taken in f32, a
// division by one is the product with its f32 reciprocal, `c / t` for a
// Python scalar c is `t.reciprocal() * c`; torch.round is rintf; the two f32
// sums (the magnitudes, the soft UW error) take the twin's order
// (`demod.warp_sum`: a lane's column summed chunk by chunk, then a
// butterfly); the running max and the LLR scale take NaN as torch.cummax
// and amax do. The bit words and quanta are ORs of disjoint bits, so their
// order does not matter. A row's LLR scale may differ from the twin's in
// the sign of a zero where the row's largest LLR is +0 and -0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kUW = 12;                   // iridium.UW_LENGTH
constexpr int kLowRun = 3;                // demod.MAX_LOW_COUNT
constexpr int kPtrs = 13;
constexpr int kInts = 6;
constexpr int kFloats = 3;
constexpr int kMaxChunks = 8;             // chunks of 32 symbols a warp holds
constexpr int kMaxTailWarps = 16;         // warps a block

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

// an LLR's u16 quantum: clamp(round(llr k), 0, 65535), k = 65535 / scale
// (a NaN gives 0, as its int64 cast's low 16 bits do in the twin)
__device__ __forceinline__ unsigned quantum(float x, float k) {
  return static_cast<unsigned>(fminf(fmaxf(rintf(x * k), 0.f), 65535.f));
}

struct DecidePackArgs {
  const float2* out;                // (B, S) the loop's output
  const unsigned char* valid;       // (B, S)
  const int* direction;             // the downmix's
  const long long* uw_dl;
  const long long* uw_ul;
  const long long* dqpsk_map;
  const float* total_phase;
  const float* fine_offset;
  const float* uw_corr;
  const unsigned char* dm_ok;
  const int* start_dec;
  const int* n_samples;
  int* rows;                        // (B, W)
  int B, S, C;                      // C = ceil(S / 32) chunks
  int wpb, bpb, cpw;                // warps a burst, bursts a block, chunks
                                    //   a warp
  int max_errors, want_llr, W, NW, NL;
  float drop_inv, conf_angle, soft_threshold;
};

// A burst's words of shared memory: the warps' maxima, valid
// counts, last hard decisions, confident counts and largest LLRs (5 wpb),
// the LLR scale (1), the chunks' low flags (C) and the lanes' magnitudes
// (32 C); runtime/pipeline.py `tail_plan` counts the same
__host__ __device__ __forceinline__ int slot_words(int wpb, int C) {
  return 5 * wpb + 1 + 33 * C;
}

// The bursts of one block meet at a block barrier; a burst of one warp at
// a warp barrier
__device__ __forceinline__ void burst_sync(int wpb) {
  if (wpb > 1)
    __syncthreads();
  else
    __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxTailWarps) decide_pack_kernel(
    const DecidePackArgs a) {
  extern __shared__ unsigned sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = a.wpb, C = a.C, S = a.S;
  const int w = warp % wpb;
  const int b = blockIdx.x * a.bpb + warp / wpb;
  // a burst past B runs every barrier and touches no device memory
  const bool live = b < a.B;
  unsigned* const base = sh + (warp / wpb) * slot_words(wpb, C);
  float* const wmax = reinterpret_cast<float*>(base);
  int* const wvalid = reinterpret_cast<int*>(base + wpb);
  int* const whard = reinterpret_cast<int*>(base + 2 * wpb);
  int* const wok = reinterpret_cast<int*>(base + 3 * wpb);
  float* const wtop = reinterpret_cast<float*>(base + 4 * wpb);
  float* const s_scale = reinterpret_cast<float*>(base + 5 * wpb);
  unsigned* const low = base + 5 * wpb + 1;
  float* const mags = reinterpret_cast<float*>(low + C);
  const long long bb = live ? b : 0;
  const float2* row = a.out + bb * S;
  const unsigned char* vrow = a.valid + bb * S;
  int* const out = a.rows + bb * a.W;
  // this warp's chunks [c0, c0 + nc)
  const int c0 = w * a.cpw;
  const int nc = max(0, min(a.cpw, C - c0));

  // the chunks, read once (every load issued before any is used)
  float2 s[kMaxChunks];
  float mag[kMaxChunks];
  bool v[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int t = (c0 + j) * 32 + lane;
    const bool in = live && j < nc && t < S;
    s[j] = in ? row[t] : make_float2(0.f, 0.f);
    v[j] = in && vrow[t] != 0;
  }
  // the running max of where(valid, mags, -inf) over the warp's chunks
  float cl[kMaxChunks];
  float carry = -INFINITY;
  int nv = 0, hard_last = 0;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (j < nc) {
      mag[j] = hypotf(s[j].x, s[j].y);
      float c = v[j] ? mag[j] : -INFINITY;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kAll, c, o);
        if (lane >= o) c = max_nan(y, c);
      }
      c = max_nan(carry, c);
      carry = __shfl_sync(kAll, c, 31);
      cl[j] = c;
      nv += __popc(__ballot_sync(kAll, v[j]));
      if (j == nc - 1) hard_last = __shfl_sync(kAll, quadrant(s[j]), 31);
    }
  }
  if (lane == 0) {
    wmax[w] = carry;
    wvalid[w] = nv;
    whard[w] = hard_last;
  }
  burst_sync(wpb);
  // the earlier warps' running max; the burst's valid count
  float cin = -INFINITY;
  int n_sym = 0;
  for (int q = 0; q < wpb; ++q) {
    if (q < w) cin = max_nan(cin, wmax[q]);
    n_sym += wvalid[q];
  }
  const int hard_in = w > 0 ? whard[w - 1] : 0;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
    if (j < nc) {
      const float c = max_nan(cin, cl[j]);
      const unsigned lw = __ballot_sync(kAll, v[j] && mag[j] < c * a.drop_inv);
      if (lane == 0) low[c0 + j] = lw;
    }
  burst_sync(wpb);
  // the first triple of low symbols (the trim), every warp alike: bit i of
  // `trips` is symbol 32 k + i low with the two before it
  int trip = -1;
  for (int k0 = 0; k0 < C; k0 += 32) {
    const int k = k0 + lane;
    unsigned trips = 0;
    if (k < C) {
      const unsigned prev = k > 0 ? low[k - 1] : 0u;
      const unsigned long long e =
          (static_cast<unsigned long long>(low[k]) << 2) | (prev >> 30);
      trips = static_cast<unsigned>(e >> 2) & static_cast<unsigned>(e >> 1) &
              static_cast<unsigned>(e);
    }
    const unsigned has = __ballot_sync(kAll, trips != 0);
    if (has) {
      const int first = __ffs(has) - 1;
      trip = (k0 + first) * 32 + __ffs(__shfl_sync(kAll, trips, first)) - 1;
      break;
    }
  }
  const int actual = trip >= 0 ? trip + 1 - kLowRun : n_sym;

  // the decisions over the warp's chunks: confidence, the magnitudes (to
  // shared memory), the UW checks (chunk 0), the bit words
  unsigned packed_map = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    packed_map |= (static_cast<unsigned>(a.dqpsk_map[q]) & 3u) << (2 * q);
  int n_ok = 0, hard_dl = 0, hard_ul = 0, p_prev = hard_in;
  float soft_dl = 0.f, soft_ul = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
    if (j < nc) {
      const int c = c0 + j;
      const int t = c * 32 + lane;
      const bool m = t < actual;
      const int h = quadrant(s[j]);
      int p = __shfl_up_sync(kAll, h, 1);
      if (lane == 0) p = p_prev;
      p_prev = __shfl_sync(kAll, h, 31);
      mags[c * 32 + lane] = m ? mag[j] : 0.f;
      const float ang = atan2f(s[j].y, s[j].x);
      const float phase = (ang + kPi) * kDegrees;
      const float offset = 45.0f - fmodf(phase, 90.0f);
      n_ok += __popc(__ballot_sync(kAll, m && fabsf(offset) <= a.conf_angle));
      // bits 2t, 2t + 1: positions 2 (lane % 16) and one up of word 2c
      // (lanes 0-15) or 2c + 1
      const unsigned dec = (packed_map >> (2 * ((h - p) & 3))) & 3u;
      const unsigned bits2 = m ? ((dec >> 1) & 1u) | ((dec & 1u) << 1) : 0u;
      const unsigned v2 = bits2 << (2 * (lane & 15));
      const unsigned wlo = __reduce_or_sync(kAll, lane < 16 ? v2 : 0u);
      const unsigned whi = __reduce_or_sync(kAll, lane < 16 ? 0u : v2);
      if (live && lane < 2 && 2 * c + lane < a.NW)
        out[2 * c + lane] = static_cast<int>(lane ? whi : wlo);
      if (c == 0) {
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
  if (lane == 0) wok[w] = n_ok;
  burst_sync(wpb);

  const int W0 = a.NW + (a.want_llr ? 1 + a.NL : 0);   // the field words
  if (w == 0) {
    // the magnitudes' sum in `warp_sum`'s order, every lane alike
    float acc = mags[lane];
    for (int c = 1; c < C; ++c) acc += mags[c * 32 + lane];
    const float sum_mag = butterfly(acc);
    int ok_all = 0;
    for (int q = 0; q < wpb; ++q) ok_all += wok[q];
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
    if (lane == 0)
      *s_scale = (actual > 0 && sum_mag > 0.f) ? (1.0f / mean) * kSqrt1_2
                                               : 1.0f;
    if (live && lane < 11) {
      // the rows' fields: fine_offset, level, total_phase, uw_corr, then
      // dm.ok, dd.ok, n_symbols, confidence, direction, start_dec,
      // n_samples
      int word;
      if (lane == 0) {
        word = __float_as_int(a.fine_offset[b]);
      } else if (lane == 1) {
        word = __float_as_int(actual > 0 ? mean : 0.f);
      } else if (lane == 2) {
        word = __float_as_int(a.total_phase[b]);
      } else if (lane == 3) {
        word = __float_as_int(a.uw_corr[b]);
      } else if (lane == 4) {
        word = a.dm_ok[b] != 0;
      } else if (lane == 5) {
        word = !both_fail || min_err <= a.soft_threshold;
      } else if (lane == 6) {
        word = actual;
      } else if (lane == 7) {
        word = actual > 0 ? static_cast<int>((100LL * ok_all) / safe_n) : 0;
      } else if (lane == 8) {
        if (both_fail)
          word = ul_err < dl_err ? 1 : 0;
        else if (ul_ok && !dl_ok)
          word = 1;
        else if (dl_ok && !ul_ok)
          word = 0;
        else
          word = a.direction[b];
      } else if (lane == 9) {
        word = a.start_dec[b];
      } else {
        word = a.n_samples[b];
      }
      out[W0 + lane] = word;
    }
    // bit words past the chunks' (s2_pad past 64 C), zero
    if (live)
      for (int i = 2 * C + lane; i < a.NW; i += 32) out[i] = 0;
  }
  if (!a.want_llr) return;   // uniform over the launch: no barrier skipped
  burst_sync(wpb);

  // the LLRs, their largest over the burst, and the quanta
  const float scale = *s_scale;
  float l0[kMaxChunks], l1[kMaxChunks];
  float top = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
    if (j < nc) {
      const bool m = (c0 + j) * 32 + lane < actual;
      l0[j] = m ? fabsf(s[j].x) * scale : 0.f;
      l1[j] = m ? fabsf(s[j].y) * scale : 0.f;
      top = max_nan(top, l0[j]);
      top = max_nan(top, l1[j]);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    top = max_nan(top, __shfl_xor_sync(kAll, top, o));
  if (lane == 0) wtop[w] = top;
  burst_sync(wpb);
  top = wtop[0];
  for (int q = 1; q < wpb; ++q) top = max_nan(top, wtop[q]);
  if (!live) return;
  const float denom = top > 0.f ? top : 1.0f;
  const float k = (1.0f / denom) * 65535.0f;
  if (w == 0 && lane == 0) out[a.NW] = __float_as_int(top);
  int* const quanta = out + a.NW + 1;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
    if (j < nc) {
      const int t = (c0 + j) * 32 + lane;
      if (t < a.NL)
        quanta[t] = t < S ? static_cast<int>(quantum(l0[j], k) |
                                             (quantum(l1[j], k) << 16))
                          : 0;
    }
  // quanta words past the chunks' (s2_pad past 64 C), zero
  if (w == 0)
    for (int i = 32 * C + lane; i < a.NL; i += 32) quanta[i] = 0;
}

}  // namespace

// One launch over B bursts of n = S symbols (at least kUW): ptrs out,
// valid, the downmix's direction, uw_dl, uw_ul, dqpsk_map, total_phase,
// fine_offset, uw_corr, dm.ok, start_dec, n_samples, rows; ints
// UW_MAX_ERRORS, s2_pad, want_llr, W, then the layout (runtime/pipeline.py
// `tail_plan`): warps a burst, bursts a block; floats MAGNITUDE_DROP,
// CONFIDENCE_ANGLE, UW_SOFT_THRESHOLD. Other counts, or a shape or layout
// the kernel does not take, are refused (cudaErrorInvalidValue) before
// anything is launched.
extern "C" int demod_tail(int B, long long n, void* const* ptrs, int n_ptrs,
                          const long long* ints, int n_ints,
                          const float* floats, int n_floats,
                          cudaStream_t stream) {
  if (n_ptrs != kPtrs || n_ints != kInts || n_floats != kFloats)
    return (int)cudaErrorInvalidValue;
  if (B < 0 || n < kUW || n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long s2_pad = ints[1], want_llr = ints[2], W = ints[3];
  const long long wpb = ints[4], bpb = ints[5];
  const long long C = (n + 31) / 32;
  const long long cpw = wpb > 0 ? (C + wpb - 1) / wpb : 0;
  const long long nw = (s2_pad + 31) / 32;
  const long long nl = (s2_pad + 1) / 2;
  const long long smem = 4LL * bpb * slot_words((int)wpb, (int)C);
  if (floats[0] == 0.f || s2_pad < 2 * n || s2_pad >= (1LL << 30) ||
      (want_llr != 0 && want_llr != 1) ||
      W != nw + (want_llr ? 1 + nl : 0) + 11 || wpb < 1 || bpb < 1 ||
      wpb * bpb > kMaxTailWarps || cpw > kMaxChunks || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  void* const* p = ptrs;
  DecidePackArgs a{};
  a.out = (const float2*)p[0];
  a.valid = (const unsigned char*)p[1];
  a.direction = (const int*)p[2];
  a.uw_dl = (const long long*)p[3];
  a.uw_ul = (const long long*)p[4];
  a.dqpsk_map = (const long long*)p[5];
  a.total_phase = (const float*)p[6];
  a.fine_offset = (const float*)p[7];
  a.uw_corr = (const float*)p[8];
  a.dm_ok = (const unsigned char*)p[9];
  a.start_dec = (const int*)p[10];
  a.n_samples = (const int*)p[11];
  a.rows = (int*)p[12];
  a.B = B;
  a.S = (int)n;
  a.C = (int)C;
  a.wpb = (int)wpb;
  a.bpb = (int)bpb;
  a.cpw = (int)cpw;
  a.max_errors = (int)ints[0];
  a.want_llr = (int)want_llr;
  a.W = (int)W;
  a.NW = (int)nw;
  a.NL = (int)nl;
  // PyTorch's division by the Python scalar: the product with its f32
  // reciprocal
  a.drop_inv = 1.0f / floats[0];
  a.conf_angle = floats[1];
  a.soft_threshold = floats[2];
  const unsigned blocks = (unsigned)((B + bpb - 1) / bpb);
  decide_pack_kernel<<<blocks, (unsigned)(32 * wpb * bpb), (size_t)smem,
                       stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* demod_tail_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
