// Downmix FIRs: the downmix chain's three small real-tap FIRs with their
// masks, in two launches a class batch.
//   stage 0 (noise + box): from the decimated rows x (B, L) c64, dec_len
//     and shift_dec (B,) i64, the noise LPF taps (nn) and the box taps
//     (nb): keep = shift_dec <= i < dec_len; the nn-tap centred ("same")
//     FIR over the kept samples, zero-padded; that or the kept samples
//     (where dec_len - nn + 1 <= 0: a very short burst skips the LPF);
//     re-zeroed by keep, which gives xd (B, L) c64; |xd|^2; the nb-tap
//     valid FIR over |xd|^2 padded with nb - 1 zeros, which gives filt
//     (B, L) f32. It writes xd and filt; |xd|^2 stays in shared memory.
//   stage 1 (RRC): from the rotated frames x (B, L) c64 and frame_len
//     (B,) i64: the samples below frame_len, through the nt-tap centred
//     FIR, which gives xr (B, L) c64.
//
// Replaces: no pl.pallas_call. iridium_tpu/dsp/downmix.py:132-164
// (`_fir_valid_small`, `_fir_same_c`: shifted f32 adds in tap order) as
// `downmix_from_dec` runs them at :403-412 (noise LPF, re-zeroing, |x|^2,
// box filter) and :459-460 (RRC), which XLA fuses into a few elementwise
// kernels of the jitted group program. The plain version is
// dsp/downmix.py `noise_box_plain` and `rrc_plain`: a multiply and an add
// launch a tap, ~190 passes over the batch's rows.
//
// Bound on the H100, at the 10 MHz small-normal batch (1,024 x 8,172): by
// bytes, each kept input sample read once (8 bytes) and each output
// written once (stage 0: 8 + 4 bytes a sample, stage 1: 8), ~0.09 ms at
// 3.35 TB/s; by FP32 issue, ~340 products and sums a sample (25 x 4 + 20
// x 2 + 51 x 4, none fused) at 128 lanes x 132 SMs x ~1.98 GHz, ~0.086
// ms. The two are close: the kernel is bound by both. A sum in tap order
// is one dependent chain of f32 adds, so no tensor core takes it.
//
// Design: a block of kThreads threads owns a tile of kTile outputs of one
// row (blockIdx.x = row * tiles + tile). It stages the tile's inputs and
// their halo in shared memory with coalesced 8-byte loads (a row of odd L
// is not 16-byte aligned), each sample read once from device memory (the
// halo, nn - 1 + nb - 1 or nt - 1 samples, is read by both neighbouring
// blocks), masked as it is loaded.
// A thread computes kPer outputs kThreads apart, so that a tap read from
// shared memory (a broadcast) serves kPer independent sums, and
// neighbouring threads read neighbouring samples (no bank conflict). Stage
// 0 computes xd and |xd|^2 for the tile and the box filter's nb - 1
// positions past it, keeps |xd|^2 in shared memory, and then runs the box
// filter from there. A tile whose outputs the masks force to zero (a
// batch's unused rows, the tails of short bursts) writes zeros and reads
// nothing. The taps come from device memory (the wrapper's tensors), at
// most kMaxTaps of each FIR.
//
// As built, shared memory's bandwidth bounds it (PERF.md): for each tap a
// warp's kPer 8-byte reads take 2 cycles each of the SM's 128 bytes a
// cycle and the tap's broadcast 1, 9 cycles for 4 x 32 sums, against 4
// cycles of FP32 issue for their 16 products and sums. At 1,024 x 8,172
// that gives ~0.115 ms for the RRC and ~0.08 for stage 0, near what the
// H100 measures (0.107 and 0.094). Tiles of 256 outputs for the wideband
// decodes' 24-32-row batches (four times the blocks) measured no
// different. A window of consecutive outputs in registers (on split real
// and imaginary planes, an odd run a thread, so without bank conflicts)
// would read each sample once a tap for all of them and leave FP32 issue
// the limit; not tried.
//
// Arithmetic: the plain version's, in its order, so that the kernel is
// bit-equal to it on the card. Each sum starts at c[0] * x[0] and adds
// c[k] * x[k] for k = 1, 2, ...; real and imaginary parts separately;
// every product and sum rounded on its own (built with --fmad=false, as
// the plain version's separate launches round them). |xd|^2 is PyTorch's
// `xd.abs() ** 2` on the card: hypotf (thrust's complex abs), then one
// product. Outputs the masks force to zero may differ from the plain
// version in the sign of that zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                     // outputs a thread
constexpr int kTile = kThreads * kPer;      // outputs a block
constexpr int kMaxTaps = 64;                // the JAX package's _SMALL_FIR_MAX

__device__ __forceinline__ float2 scale(float c, float2 v) {
  return make_float2(c * v.x, c * v.y);
}
__device__ __forceinline__ float scale(float c, float v) { return c * v; }
__device__ __forceinline__ float2 plus(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }

// R outputs of a correlation FIR, output r from s[r * kThreads]:
// acc[r] = sum over k < n, in order, of c[k] * s[r * kThreads + k].
template <int R, typename T>
__device__ __forceinline__ void fir(const T* s, const float* c, int n,
                                    T (&acc)[R]) {
  const float c0 = c[0];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = scale(c0, s[r * kThreads]);
  for (int k = 1; k < n; ++k) {
    const float ck = c[k];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = plus(acc[r], scale(ck, s[r * kThreads + k]));
  }
}

struct NoiseBoxArgs {
  const float2* x;
  const long long* dec_len;
  const long long* shift_dec;
  const float* noise;
  const float* box;
  float2* xd;
  float* filt;
  int L, tiles, nn, nb;
};

// Stage 0, one tile. Shared: the inputs from tile start - hn (kTile + nn -
// 1 + nb - 1 samples), |xd|^2 from the tile start (kTile + nb - 1), taps.
__global__ void __launch_bounds__(kThreads)
    noise_box_kernel(const NoiseBoxArgs a) {
  __shared__ float2 sx[kTile + 2 * kMaxTaps];
  __shared__ float sm[kTile + kMaxTaps];
  __shared__ float sc[2 * kMaxTaps];
  const int b = blockIdx.x / a.tiles;
  const int i0 = (blockIdx.x - b * a.tiles) * kTile;
  const int L = a.L, nn = a.nn, nb = a.nb, hn = (nn - 1) / 2;
  // kept: [lo, hi), inside the row
  const long long dl = a.dec_len[b], sd = a.shift_dec[b];
  const long long lo = sd > 0 ? sd : 0;
  const long long hi = dl < L ? dl : L;
  const size_t row = (size_t)b * (size_t)L;
  const int tid = threadIdx.x;
  const int n_out = min(kTile, L - i0);
  // every xd of the tile and every |xd|^2 its box sums read lie outside
  // [lo, hi): zeros
  if (hi <= lo || hi <= i0 || lo >= (long long)i0 + kTile + nb - 1) {
    for (int i = tid; i < n_out; i += kThreads) {
      a.xd[row + i0 + i] = make_float2(0.f, 0.f);
      a.filt[row + i0 + i] = 0.f;
    }
    return;
  }
  for (int i = tid; i < nn; i += kThreads) sc[i] = a.noise[i];
  for (int i = tid; i < nb; i += kThreads) sc[kMaxTaps + i] = a.box[i];
  const int n_in = kTile + nn - 1 + nb - 1;
  for (int i = tid; i < n_in; i += kThreads) {
    const long long p = (long long)i0 - hn + i;
    sx[i] = (p >= lo && p < hi) ? a.x[row + p] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const bool lpf = dl - nn + 1 > 0;
  // xd and |xd|^2 at tile positions j = tid + r kThreads (r < kPer), then
  // the nb - 1 past the tile
  {
    float2 v[kPer];
    if (lpf) {
      fir<kPer>(sx + tid, sc, nn, v);
    } else {
#pragma unroll
      for (int r = 0; r < kPer; ++r) v[r] = sx[tid + r * kThreads + hn];
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = tid + r * kThreads;
      const long long q = (long long)i0 + j;
      const float2 w = (q >= lo && q < hi) ? v[r] : make_float2(0.f, 0.f);
      if (j < n_out) a.xd[row + q] = w;
      const float m = hypotf(w.x, w.y);
      sm[j] = m * m;
    }
  }
  if (tid < nb - 1) {
    const int j = kTile + tid;
    const long long q = (long long)i0 + j;
    float2 v[1];
    if (lpf)
      fir<1>(sx + j, sc, nn, v);
    else
      v[0] = sx[j + hn];
    const float2 w = (q >= lo && q < hi) ? v[0] : make_float2(0.f, 0.f);
    const float m = hypotf(w.x, w.y);
    sm[j] = m * m;
  }
  __syncthreads();
  float f[kPer];
  fir<kPer>(sm + tid, sc + kMaxTaps, nb, f);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = tid + r * kThreads;
    if (j < n_out) a.filt[row + i0 + j] = f[r];
  }
}

struct RrcArgs {
  const float2* x;
  const long long* frame_len;
  const float* taps;
  float2* xr;
  int L, tiles, nt;
};

// Stage 1, one tile. Shared: the inputs from tile start - h (kTile + nt -
// 1 samples), taps.
__global__ void __launch_bounds__(kThreads) rrc_kernel(const RrcArgs a) {
  __shared__ float2 sx[kTile + kMaxTaps];
  __shared__ float sc[kMaxTaps];
  const int b = blockIdx.x / a.tiles;
  const int i0 = (blockIdx.x - b * a.tiles) * kTile;
  const int L = a.L, nt = a.nt, h = (nt - 1) / 2;
  const long long fl = a.frame_len[b];
  const long long hi = fl < L ? fl : L;       // kept: [0, hi)
  const size_t row = (size_t)b * (size_t)L;
  const int tid = threadIdx.x;
  const int n_out = min(kTile, L - i0);
  // every sum of the tile reads inputs at or past hi: zeros
  if (hi <= 0 || (long long)i0 - h >= hi) {
    for (int i = tid; i < n_out; i += kThreads)
      a.xr[row + i0 + i] = make_float2(0.f, 0.f);
    return;
  }
  for (int i = tid; i < nt; i += kThreads) sc[i] = a.taps[i];
  const int n_in = kTile + nt - 1;
  for (int i = tid; i < n_in; i += kThreads) {
    const long long p = (long long)i0 - h + i;
    sx[i] = (p >= 0 && p < hi) ? a.x[row + p] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  float2 v[kPer];
  fir<kPer>(sx + tid, sc, nt, v);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = tid + r * kThreads;
    if (j < n_out) a.xr[row + i0 + j] = v[r];
  }
}

}  // namespace

// stage 0: x (B, L) c64 as float2, len_a dec_len and len_b shift_dec (B,)
// i64, taps_a the noise taps (n_a), taps_b the box taps (n_b); out_c xd
// (B, L) c64, out_f filt (B, L) f32.
// stage 1: x (B, L), len_a frame_len (B,) i64, taps_a the RRC taps (n_a);
// out_c xr (B, L) c64; len_b, taps_b, n_b and out_f unused.
// Each FIR takes 1 to 64 taps; B x ceil(L / 1024) blocks must fit an int.
extern "C" int downmix_fir(int stage, const float2* x, int B, long long L,
                           const long long* len_a, const long long* len_b,
                           const float* taps_a, int n_a,
                           const float* taps_b, int n_b, float2* out_c,
                           float* out_f, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L >= (1LL << 31) - kTile || n_a < 1 || n_a > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (L + kTile - 1) / kTile;
  if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(B * tiles);
  if (stage == 0) {
    if (n_b < 1 || n_b > kMaxTaps) return (int)cudaErrorInvalidValue;
    const NoiseBoxArgs a{x,     len_a, len_b,      taps_a, taps_b, out_c,
                         out_f, (int)L, (int)tiles, n_a,    n_b};
    noise_box_kernel<<<grid, kThreads, 0, stream>>>(a);
  } else if (stage == 1) {
    const RrcArgs a{x, len_a, taps_a, out_c, (int)L, (int)tiles, n_a};
    rrc_kernel<<<grid, kThreads, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* downmix_fir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
