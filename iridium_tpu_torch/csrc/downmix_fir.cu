// Downmix FIRs: the downmix chain's three small real-tap FIRs with their
// masks, and the frame gather and fine rotation before the RRC, in two
// launches a class batch.
//   stage 0 (noise + box): from the decimated rows x (B, L) c64, dec_len
//     and shift_dec (B,) i64, the noise LPF taps (nn) and the box taps
//     (nb): keep = shift_dec <= i < dec_len; the nn-tap centred ("same")
//     FIR over the kept samples, zero-padded; that or the kept samples
//     (where dec_len - nn + 1 <= 0: a very short burst skips the LPF);
//     re-zeroed by keep, which gives xd (B, L) c64; |xd|^2; the nb-tap
//     valid FIR over |xd|^2 padded with nb - 1 zeros, which gives filt
//     (B, L) f32. It writes xd and filt; |xd|^2 stays in shared memory.
//   stage 1 (frame + RRC): from xd, start, frame_len and u (B,) i64, corr
//     (B,) f32 and 2 cfo_total (a power of two): the frame xf[i] =
//     xd[start + i] (0 past the row; a negative index reads xd[0], as
//     `shift_take` clamps it), kept below frame_len, turned by the fine
//     CFO angle -2 pi ((u i mod 2 cfo_total) / (2 cfo_total) + corr i /
//     (2 cfo_total)), through the nt-tap centred RRC, which gives xr (B,
//     L) c64; given a sync buffer (B, corr_n) c64, also the sync-word
//     search's input, xr[i] for i < min(frame_len, search_cap), zero up to
//     corr_n, which the forward FFT of the correlation takes as it is.
//
// Replaces: no pl.pallas_call. iridium_tpu/dsp/downmix.py:132-164
// (`_fir_valid_small`, `_fir_same_c`: shifted f32 adds in tap order) as
// `downmix_from_dec` runs them at :403-412 (noise LPF, re-zeroing, |x|^2,
// box filter) and, with the frame gather (:431-435) and the fine rotation
// (:451-456) before it, at :458-460 (RRC), and the sync search's masked
// input (:463-464), which XLA fuses into a few elementwise kernels of the
// jitted group program. The plain version is dsp/downmix.py
// `noise_box_plain` and `frame_rrc_plain` (with `sync_input_plain`): a
// multiply and an add launch a tap, ~240 launches over the batch's rows.
//
// Bound on the H100, as tools/exp_downmix.py `bound` counts what its rows
// need at the 10 MHz small-normal batch (1,024 x 8,172): by bytes, each
// kept input sample read once (8 bytes; stage 1 reads xd from start), the
// per-row lengths and scalars, and each output written once (stage 0: 8 +
// 4 bytes a sample, stage 1: 8), ~0.069 ms at 3.35 TB/s; by FP32 issue,
// the FIRs' products and sums (none fused: 4 nn - 2, 2 nb - 1, 4 nt - 2
// an output) only where the masks leave an output to compute, the
// squares of |xd|^2 and the rotation (11 a kept frame sample, sin and cos
// one each), at 128 lanes x 132 SMs x the top SM clock, about half of
// that. Bytes bound it: the design aims to leave FP32 issue under the
// memory time, not over it. A sum in tap order is one dependent chain of
// f32 adds, so no tensor core takes it.
//
// Design: a block of kThreads threads owns a span of kSpan = kThreads x
// kRun positions of one row (blockIdx.x = row * tiles + tile). It stages
// the span's inputs and their halo in shared memory, on split real and
// imaginary planes, with coalesced 8-byte loads (a row of odd L is not
// 16-byte aligned), all of a thread's loads issued before its first
// store, each sample read once from device memory (the halo, nn - 1 or nt
// - 1 samples, is read by both neighbouring blocks), masked as it is
// loaded; stage 1 reads from start and each thread turns the samples it
// staged. A thread computes a run of kRun consecutive outputs (`fir_run`):
// its kRun sums stay in registers and the window of kRun samples they
// read slides through registers tap by tap, so a tap costs one
// shared-memory read a plane (and the tap's broadcast) for kRun sums; kRun
// is odd, so a warp's 32 reads (stride kRun) fall in 32 banks. Outputs go
// back through the planes and out coalesced. Stage 0 computes xd and
// |xd|^2 over the whole span and writes the first kSpan - (nb - 1)
// outputs (the box filter's window reads nb - 1 past them; tiles step by
// that), so the box filter runs from shared memory as well. A tile whose
// outputs the masks force to zero (a batch's unused rows, the tails of
// short bursts) writes zeros and reads nothing. The taps come from device
// memory (the wrapper's tensors), at most kMaxTaps of each FIR.
//
// Sizes: kRun = 11 keeps 4 x 11 floats of sums and window (the RRC's two
// planes) in registers; with a tap's 2 plane reads and its broadcast
// against 44 FP32 instructions, FP32 issue and not shared memory limits a
// warp's FIR. kThreads = 128 gives kSpan = 1,408, 6 tiles for an
// 8,172-sample row (3% past its end) and 20 for 28,140; ~18 KB of shared
// memory a block. A warp whose outputs the masks force to zero skips its
// FIR, and a block issues its taps' loads with its samples'.
//
// As built (ptxas -v, which tools/exp_downmix.py prints: 55 registers in
// stage 0, 61 in stage 1, no spill; stage 1's 32-byte stack frame is
// sincosf's slow path, which these angles never take), both launches take
// ~0.12 ms as a CUDA graph at 1,024 x 8,172, ~55% of the bytes bound, and
// ~0.10 ms with every FIR cut to its first tap (the tool's `no_taps`
// probe): the loads and stores, near the rate of PyTorch's own fill_ of
// the outputs' bytes (the tool's `fill_ms`), take most of the time, and
// the FIRs' FP32 issue overlaps them only in part (PERF.md). Runs of 7 or
// 15, blocks of 64 or 256 threads, stores straight from registers, and
// blocks that walk several tiles with the next one's samples copied in
// (cp.async) while they compute measured no faster on the H100.
//
// Arithmetic: the plain version's, in its order, so that the kernel is
// bit-equal to it on the card. Each sum starts at c[0] * x[0] and adds
// c[k] * x[k] for k = 1, 2, ...; real and imaginary parts separately;
// every product and sum rounded on its own (built with --fmad=false, as
// the plain version's separate launches round them). |xd|^2 is PyTorch's
// `xd.abs() ** 2` on the card: hypotf (thrust's complex abs), then one
// product. The rotation is `Downmix.forward`'s tensor operations: u i mod
// 2 cfo_total exact (a mask, 2 cfo_total being a power of two), converted
// to f32; each division by 2 cfo_total a product with its f32
// reciprocal (PyTorch's CUDA division by a Python scalar); the angle's
// f32 product with -2 pi rounded to f32; cosf and sinf (sincosf's values
// are theirs) without fast math; the complex product PyTorch's (`cmul`,
// two fused multiply-adds). Outputs the masks force to zero may differ
// from the plain version in the sign of that zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 11;                    // consecutive outputs a thread
constexpr int kSpan = kThreads * kRun;      // positions a block computes
constexpr int kMaxTaps = 64;                // the JAX package's _SMALL_FIR_MAX
constexpr int kPlane = kSpan + kMaxTaps;    // staged samples, at most
constexpr int kStageIters = (kPlane + kThreads - 1) / kThreads;
static_assert(kRun % 2 == 1, "an odd run: a warp's reads in 32 banks");
static_assert(kThreads >= kMaxTaps, "a tap a thread");

// -2 pi as the Python constant float(np.float32(-2 pi)) the angle takes
constexpr float kMinusTwoPi = static_cast<float>(-6.283185307179586);

// (a + bi)(c + di) as PyTorch's CUDA complex product computes it: its
// c10::complex operator*= is (a c - b d) + (a d + b c) i, and PyTorch's
// build contracts each part into one fused multiply-add whose addend is
// the second product, rounded
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(__fmaf_rn(x.x, y.x, -(x.y * y.y)),
                     __fmaf_rn(x.x, y.y, x.y * y.x));
}

// s[i] = src[max(p0 + i + shift, 0)] where p0 + i lies in [lo, hi), else
// 0, for i < n, on the planes sre and sim; a thread loads all of its
// samples before it stores the first
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      long long p0, int n, long long lo,
                                      long long hi, long long shift,
                                      float* sre, float* sim) {
  float2 v[kStageIters];
#pragma unroll
  for (int m = 0; m < kStageIters; ++m) {
    const int i = threadIdx.x + m * kThreads;
    const long long p = p0 + i;
    const long long q = p + shift;
    v[m] = (i < n && p >= lo && p < hi) ? src[q > 0 ? q : 0]
                                        : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int m = 0; m < kStageIters; ++m) {
    const int i = threadIdx.x + m * kThreads;
    if (i < n) {
      sre[i] = v[m].x;
      sim[i] = v[m].y;
    }
  }
}

// The samples this thread staged (i = threadIdx.x + m kThreads < n, at
// frame positions p = p0 + i), where 0 <= p < hi, turned by the fine CFO
// angle of `Downmix.forward`; tt = 2 cfo_total, a power of two
__device__ __forceinline__ void turn(float* sre, float* sim, int n,
                                     long long p0, long long hi,
                                     long long u, float corr, long long tt) {
  const float inv = 1.0f / (float)tt;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long p = p0 + i;
    if (p < 0 || p >= hi) continue;
    // (u * p) % tt as torch's remainder (floor) of int64: a mask
    const float mfine = (float)((u * p) & (tt - 1));
    const float frac = (corr * (float)p) * inv;
    const float ang = kMinusTwoPi * (mfine * inv + frac);
    float sn, cs;
    sincosf(ang, &sn, &cs);
    const float2 y = cmul(make_float2(sre[i], sim[i]), make_float2(cs, sn));
    sre[i] = y.x;
    sim[i] = y.y;
  }
}

// acc[q][r] = sum over k < n, in tap order, of c[k] * s_q[r + k], for the
// P planes s_q and r < kRun. The window w holds sample t of the run in
// w[t % kRun]: tap k reads one new sample a plane, s_q[k + kRun - 1], into
// the slot sample k - 1 leaves. Taps go in chunks of kRun from k = 1, so
// that (k + r) % kRun is a constant in the unrolled chunk.
template <int P>
__device__ __forceinline__ void fir_run(const float* s0, const float* s1,
                                        const float* c, int n,
                                        float (&acc)[P][kRun]) {
  const float* s[2] = {s0, s1};
  float w[P][kRun];
  const float c0 = c[0];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      w[q][r] = s[q][r];
      acc[q][r] = c0 * w[q][r];
    }
  }
  for (int k0 = 1; k0 < n; k0 += kRun) {
#pragma unroll
    for (int kk = 0; kk < kRun; ++kk) {
      const int k = k0 + kk;
      if (k < n) {
        const float ck = c[k];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          w[q][kk] = s[q][k + kRun - 1];
#pragma unroll
          for (int r = 0; r < kRun; ++r)
            acc[q][r] = acc[q][r] + ck * w[q][(kk + 1 + r) % kRun];
        }
      }
    }
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

// Stage 0, one tile: kSpan - (nb - 1) outputs from i0. Shared: the inputs
// from i0 - hn (kSpan + nn - 1 samples), then xd; |xd|^2 from i0 (kSpan,
// and zeros past it that only the discarded runs read); the taps.
__global__ void __launch_bounds__(kThreads)
    noise_box_kernel(const NoiseBoxArgs a) {
  __shared__ float sre[kPlane];
  __shared__ float sim[kPlane];
  __shared__ float sm[kPlane];
  __shared__ float sc[2 * kMaxTaps];
  const int L = a.L, nn = a.nn, nb = a.nb, hn = (nn - 1) / 2;
  const int b = blockIdx.x / a.tiles;
  const int n_tile = kSpan - (nb - 1);
  const int i0 = (blockIdx.x - b * a.tiles) * n_tile;
  // kept: [lo, hi), inside the row
  const long long dl = a.dec_len[b], sd = a.shift_dec[b];
  const long long lo = sd > 0 ? sd : 0;
  const long long hi = dl < L ? dl : L;
  const size_t row = (size_t)b * (size_t)L;
  const int tid = threadIdx.x;
  const int n_out = min(n_tile, L - i0);
  // every xd of the tile and every |xd|^2 its box sums read lie outside
  // [lo, hi): zeros
  if (hi <= lo || hi <= i0 || lo >= (long long)i0 + kSpan) {
    for (int i = tid; i < n_out; i += kThreads) {
      a.xd[row + i0 + i] = make_float2(0.f, 0.f);
      a.filt[row + i0 + i] = 0.f;
    }
    return;
  }
  // the taps' loads go out with the samples', not a round trip before
  const float tn = tid < nn ? a.noise[tid] : 0.f;
  const float tb = tid < nb ? a.box[tid] : 0.f;
  stage(a.x + row, (long long)i0 - hn, kSpan + nn - 1, lo, hi, 0, sre, sim);
  if (tid < nn) sc[tid] = tn;
  if (tid < nb) sc[kMaxTaps + tid] = tb;
  if (tid < kMaxTaps) sm[kSpan + tid] = 0.f;
  __syncthreads();
  const int j0 = tid * kRun;
  // the warp's positions [q0, q1): where none is kept, its xd are zeros,
  // and where no box window meets a kept one, its filt too
  const long long q0 = (long long)i0 + (tid & ~31) * kRun;
  const long long q1 = q0 + 32 * kRun;
  float v[2][kRun];
  if (q0 >= hi || q1 <= lo) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) v[0][r] = v[1][r] = 0.f;
  } else if (dl - nn + 1 > 0) {
    fir_run<2>(sre + j0, sim + j0, sc, nn, v);
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      v[0][r] = sre[j0 + r + hn];
      v[1][r] = sim[j0 + r + hn];
    }
  }
  __syncthreads();
  // xd re-zeroed by keep, into the planes; |xd|^2
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const long long q = (long long)i0 + j0 + r;
    const bool keep = q >= lo && q < hi;
    const float wr = keep ? v[0][r] : 0.f, wi = keep ? v[1][r] : 0.f;
    sre[j0 + r] = wr;
    sim[j0 + r] = wi;
    const float m = hypotf(wr, wi);
    sm[j0 + r] = m * m;
  }
  __syncthreads();
  float f[1][kRun];
  if (q0 >= hi || q1 + nb - 1 <= lo) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) f[0][r] = 0.f;
  } else {
    fir_run<1>(sm + j0, nullptr, sc + kMaxTaps, nb, f);
  }
  for (int i = tid; i < n_out; i += kThreads)
    a.xd[row + i0 + i] = make_float2(sre[i], sim[i]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRun; ++r) sre[j0 + r] = f[0][r];
  __syncthreads();
  for (int i = tid; i < n_out; i += kThreads) a.filt[row + i0 + i] = sre[i];
}

struct FrameRrcArgs {
  const float2* xd;
  const long long* start;
  const long long* frame_len;
  const long long* u;
  const float* corr;
  const float* taps;
  float2* xr;
  float2* sync;     // the sync search's input, or null
  long long two_total;
  int L, tiles, nt, search_cap, corr_n;
};

// With a sync buffer, this tile's positions of it (the last tile's
// also those past the row, up to corr_n): sync[p] = xr[p] (the tile's
// outputs on the planes from i0; null planes: zeros) for p below
// min(frame_len, search_cap), else 0
__device__ __forceinline__ void write_sync(const FrameRrcArgs& a, int b,
                                           int i0, int n_out, long long fl,
                                           const float* sre,
                                           const float* sim) {
  if (a.sync == nullptr) return;
  const long long ns = fl < a.search_cap ? fl : a.search_cap;
  float2* s = a.sync + (size_t)b * (size_t)a.corr_n;
  const int end = i0 + n_out >= a.L ? a.corr_n : min(i0 + n_out, a.corr_n);
  for (int p = i0 + (int)threadIdx.x; p < end; p += kThreads)
    s[p] = (sre != nullptr && p < ns && p < i0 + n_out)
               ? make_float2(sre[p - i0], sim[p - i0])
               : make_float2(0.f, 0.f);
}

// Stage 1, one tile: kSpan outputs from i0. Shared: the frame's samples
// from i0 - h (kSpan + nt - 1), turned, then xr; the taps.
__global__ void __launch_bounds__(kThreads)
    frame_rrc_kernel(const FrameRrcArgs a) {
  __shared__ float sre[kPlane];
  __shared__ float sim[kPlane];
  __shared__ float sc[kMaxTaps];
  const int L = a.L, nt = a.nt, h = (nt - 1) / 2;
  const int b = blockIdx.x / a.tiles;
  const int i0 = (blockIdx.x - b * a.tiles) * kSpan;
  // kept frame positions: [0, hi), below frame_len, inside the row, and
  // from start inside xd's row
  const long long st = a.start[b], fl = a.frame_len[b];
  long long hi = fl < L ? fl : L;
  if (L - st < hi) hi = L - st;
  const size_t row = (size_t)b * (size_t)L;
  const int tid = threadIdx.x;
  const int n_out = min(kSpan, L - i0);
  // every sum of the tile reads positions at or past hi: zeros
  if (hi <= 0 || (long long)i0 - h >= hi) {
    for (int i = tid; i < n_out; i += kThreads)
      a.xr[row + i0 + i] = make_float2(0.f, 0.f);
    write_sync(a, b, i0, n_out, fl, nullptr, nullptr);
    return;
  }
  const long long u = a.u[b];
  const float corr = a.corr[b];
  const float tap = tid < nt ? a.taps[tid] : 0.f;
  const int n_in = kSpan + nt - 1;
  const long long p0 = (long long)i0 - h;
  stage(a.xd + row, p0, n_in, 0, hi, st, sre, sim);
  if (tid < nt) sc[tid] = tap;
  turn(sre, sim, n_in, p0, hi, u, corr, a.two_total);
  __syncthreads();
  const int j0 = tid * kRun;
  // the warp's outputs [q0, q1): where no window meets [0, hi), zeros
  const long long q0 = (long long)i0 + (tid & ~31) * kRun;
  const long long q1 = q0 + 32 * kRun;
  float v[2][kRun];
  if (q0 - h >= hi || q1 + h <= 0) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) v[0][r] = v[1][r] = 0.f;
  } else {
    fir_run<2>(sre + j0, sim + j0, sc, nt, v);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    sre[j0 + r] = v[0][r];
    sim[j0 + r] = v[1][r];
  }
  __syncthreads();
  for (int i = tid; i < n_out; i += kThreads)
    a.xr[row + i0 + i] = make_float2(sre[i], sim[i]);
  write_sync(a, b, i0, n_out, fl, sre, sim);
}

}  // namespace

// stage 0: x (B, L) c64 as float2, len_a dec_len and len_b shift_dec (B,)
// i64, taps_a the noise taps (n_a), taps_b the box taps (n_b); out_c xd
// (B, L) c64, out_f filt (B, L) f32; u, corr, two_total and sync unused.
// stage 1: x xd (B, L), len_a frame_len and len_b start (B,) i64, u (B,)
// i64, corr (B,) f32, two_total = 2 cfo_total (a power of two, at most
// 2^24), taps_a the RRC taps (n_a); out_c xr (B, L) c64; sync the sync
// search's input (B, corr_n) c64 or null, with search_cap <= L and <=
// corr_n; taps_b, n_b and out_f unused.
// Each FIR takes 1 to 64 taps; B x tiles blocks must fit an int.
extern "C" int downmix_fir(int stage, const float2* x, int B, long long L,
                           const long long* len_a, const long long* len_b,
                           const long long* u, const float* corr,
                           long long two_total, const float* taps_a,
                           int n_a, const float* taps_b, int n_b,
                           float2* out_c, float* out_f, float2* sync,
                           int search_cap, int corr_n, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L >= (1LL << 31) - kPlane || n_a < 1 || n_a > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if (stage == 0) {
    if (n_b < 1 || n_b > kMaxTaps) return (int)cudaErrorInvalidValue;
    const long long span = kSpan - (n_b - 1);
    const long long tiles = (L + span - 1) / span;
    if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const NoiseBoxArgs a{x,     len_a, len_b,      taps_a, taps_b, out_c,
                         out_f, (int)L, (int)tiles, n_a,    n_b};
    noise_box_kernel<<<(unsigned)(B * tiles), kThreads, 0, stream>>>(a);
  } else if (stage == 1) {
    if (two_total < 1 || two_total > (1LL << 24) ||
        (two_total & (two_total - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    if (sync != nullptr &&
        (search_cap < 0 || search_cap > L || corr_n < search_cap))
      return (int)cudaErrorInvalidValue;
    const long long tiles = (L + kSpan - 1) / kSpan;
    if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const FrameRrcArgs a{x,         len_b,   len_a,      u,          corr,
                         taps_a,    out_c,   sync,       two_total,  (int)L,
                         (int)tiles, n_a,    search_cap, corr_n};
    frame_rrc_kernel<<<(unsigned)(B * tiles), kThreads, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* downmix_fir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
