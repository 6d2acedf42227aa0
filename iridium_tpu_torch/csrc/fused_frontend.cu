// Fused burst front-end: window gather + coarse-CFO rotate + decimating
// FIR in one pass over the stream. For burst b with window start
// w0 = tile_b * align + r_b and FFT-bin offset k_b:
//   y[n]   = x[w0 + n] * exp(-2*pi*i * ((k_b * n) mod F) / F)
//   out[m] = sum_u taps[u] * y[m * decim + u],   m < l_win / decim
// Outputs near the window end read stream samples past the window; the
// caller masks them (they lie past dec_len).
//
// Replaces: iridium_tpu/ops/fused_frontend.py, make_fused_frontend (the
// Pallas kernel at :130-214, launched by `fused` :216-276), whose ramp
// table is make_ramp_table :65-79.
//
// Bound on the H100: per burst it reads the l_win complex samples of its
// window (8 bytes each; the windows of a dense block overlap) and does
// 2 * ntaps multiply-adds per output for l_win / decim outputs. At the
// production 801 taps / decim 40 and a 256-burst batch of 327,680-sample
// windows that is 0.05 ms of memory traffic, 0.10 ms of FP32 FMA work, or
// 0.04 ms of f32-grade products on the tensor cores (3 TF32 products per
// tap product at 495 TFLOP/s). What holds the kernel back is neither: it
// moves each loaded sample (x and its ramp value, 16 bytes) from L2 into
// shared memory once per 128-output run and runs the products with
// mma.sync; PERF.md has the breakdown.
//
// Design: the FIR runs on the tensor cores. Outputs are grouped by 8:
//   out[8s + c] = sum_k Y[s][k] * T[k][c],
//   Y[s][k] = y[8 * decim * s + k],   T[k][c] = taps[k - decim * c],
// with k < K = 7 * decim + ntaps rounded up to 8 (T is 0 outside the
// taps). Y is a Hankel matrix over the rotated span: its row s starts
// 8 * decim samples after row s - 1, so the span is stored once in rows of
// 8 * decim samples (padded by 4 words, which puts the 8 rows of an
// ldmatrix phase on distinct banks) and one ldmatrix.x4 reads a 16 x 8 A
// fragment. T is Toeplitz: a lane's B values are taps[k0 + t - decim * g]
// (+4), read from a zero-padded tap array whose index i sits at
// i + 4 * (i / decim), which puts the 32 lanes on 32 banks. T is never
// materialised. The real and imaginary planes are two m16 tiles against
// the same B fragment.
//
// f32-grade products from TF32 (mma.sync.m16n8k8): every operand x is
// split as hi = x with its low 13 mantissa bits cleared (so x - hi is
// exact) and lo = cvt.rna.tf32(x - hi); each k-step does hi*hi, hi*lo and
// lo*hi into three f32 accumulators (lo*lo, ~2^-21 relative, is dropped).
// The taps are split once, when stored; the span is stored in f32 and
// split per A fragment (8 ALU operations per 3 products): half the shared
// memory of storing both parts, so three blocks fit an SM instead of two,
// which measured faster.
//
// Rotate-on-load in 32-bit arithmetic: a first kernel writes each burst's
// ramp in sample order, rot[b][.][m] = ramp[.][(k_b * m) mod F] for
// m < F (exact integer phase, the (2, F) cos/sin table of
// ops/fused_frontend.py ramp_table; k_b * m < F^2 < 2^32), so that the
// main kernel reads it at n mod F, coalesced like the samples, instead of
// gathering the table at a stride of k_b per lane (32 cache lines a warp
// load). Each thread steps n mod F by 256 from one base: no 64-bit or
// per-sample modulo. The rotation rounds each product as the plain
// version does.
//
// Launch: one block of 256 threads per (burst, run of 128 outputs). It
// loads and rotates the run's span (15 * 8 * decim + K samples: 5,888 at
// decim 40) into shared memory, splits the 136 k-steps among its 8 warps
// and sums the warps' tiles; a ragged last run is masked. About 61 KB of
// shared memory at decim 40, so three blocks share an SM and one's loads
// overlap the others' products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 16;              // groups of 8 outputs: one m16 tile
constexpr int kOut = 8 * kGroups;        // outputs per block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r)
      : "f"(__fsub_rn(x, __uint_as_float(hi))));
  return r;
}

// split an A fragment held as f32 into its TF32 hi and lo parts
__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = __uint_as_float(hi[i]);
    hi[i] = tf32_hi(x);
    lo[i] = tf32_lo(x, hi[i]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rot[b][0][m], rot[b][1][m] = cos, sin of ramp phase (k_b * m) mod F
__global__ void burst_ramp_kernel(const int* __restrict__ ks,
                                  const float* __restrict__ ramp,
                                  int fft_size, float* __restrict__ rot) {
  const unsigned F = (unsigned)fft_size;
  const int b = blockIdx.y;
  const unsigned kk = (unsigned)(((ks[b] % fft_size) + fft_size) % fft_size);
  float* r = rot + (size_t)b * 2 * F;
  for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < F;
       m += gridDim.x * blockDim.x) {
    const unsigned ph = (kk * m) % F;
    r[m] = __ldg(ramp + ph);
    r[F + m] = __ldg(ramp + F + ph);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3) fused_frontend_kernel(
    const float* __restrict__ planes, long long n,
    const int* __restrict__ starts2, const float* __restrict__ rot,
    const float* __restrict__ taps, int n_out, int fft_size, int ntaps,
    int kpad, int rows, int tap_words, int align,
    float* __restrict__ out_re, float* __restrict__ out_im) {
  constexpr int kSeg = 8 * D;            // samples per Hankel row
  constexpr int kStride = kSeg + 4;      // words per stored row
  constexpr int kTapOff = 7 * D;         // tap index i' = u + 7 * decim
  extern __shared__ __align__(16) float smem[];
  const int plane_words = rows * kStride;
  float* y_re = smem;
  float* y_im = y_re + plane_words;
  float* t_hi = y_im + plane_words;
  float* t_lo = t_hi + tap_words;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kOut;
  const long long s0 =
      (long long)starts2[2 * b] * align + starts2[2 * b + 1] + (long long)m0 * D;
  const unsigned F = (unsigned)fft_size;
  const float* rot_c = rot + (size_t)b * 2 * F;
  const float* rot_s = rot_c + F;

  // phase: begin
  for (int i = tid; i < kpad + kTapOff; i += kThreads) {
    const int u = i - kTapOff;
    const float h = (u >= 0 && u < ntaps) ? taps[u] : 0.0f;
    const uint32_t hi = tf32_hi(h);
    t_hi[i + 4 * (i / D)] = __uint_as_float(hi);
    t_lo[i + 4 * (i / D)] = __uint_as_float(tf32_lo(h, hi));
  }

  // phase: load
  // y[n] for the window-relative n = m0 * D + j: rows of kSeg samples
  const int n_ld = (kGroups - 1) * kSeg + kpad;
  unsigned ph = (unsigned)(m0 * D + tid) % F;      // n mod F
  const unsigned dph = (unsigned)kThreads % F;
  // samples j in [j_lo, j_hi) lie inside the stream
  const int j_lo = (int)max(0LL, min((long long)n_ld, -s0));
  const int j_hi = (int)max(0LL, min((long long)n_ld, n - s0));
  const float* re = planes + s0;
  const float* im = planes + n + s0;
#pragma unroll 4
  for (int j = tid; j < n_ld; j += kThreads) {
    const bool in = (unsigned)(j - j_lo) < (unsigned)(j_hi - j_lo);
    const float xr = in ? __ldcg(re + j) : 0.0f;
    const float xi = in ? __ldcg(im + j) : 0.0f;
    const float c = __ldg(rot_c + ph);
    const float sn = __ldg(rot_s + ph);
    const int pos = (j / kSeg) * kStride + j % kSeg;
    y_re[pos] = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, sn));
    y_im[pos] = __fadd_rn(__fmul_rn(xr, sn), __fmul_rn(xi, c));
    ph += dph;
    if (ph >= F) ph -= F;
  }
  __syncthreads();

  // phase: fir
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // ldmatrix.x4: lane supplies row (lane & 7) + 8 * (matrix & 1) of
  // matrix lane / 8, at column 4 * (matrix >> 1) of the k-step
  const int mq = lane >> 3;
  const int a_lane = ((lane & 7) + 8 * (mq & 1)) * kStride + 4 * (mq >> 1);
  const auto a_re = (uint32_t)__cvta_generic_to_shared(y_re + a_lane);
  const auto a_im = (uint32_t)__cvta_generic_to_shared(y_im + a_lane);
  const int b_lane = t + (D + 4) * (7 - g);
  const uint32_t* th = reinterpret_cast<const uint32_t*>(t_hi);
  const uint32_t* tl = reinterpret_cast<const uint32_t*>(t_lo);

  float hh[2][4] = {}, hl[2][4] = {}, lh[2][4] = {};
  const int n_ks = kpad / 8;
  for (int kstep = warp; kstep < n_ks; kstep += kWarps) {
    const int k0 = 8 * kstep;
    const uint32_t a_off = 4u * ((k0 / kSeg) * kStride + k0 % kSeg);
    const int b_off = k0 + 4 * (k0 / D) + b_lane;
    const uint32_t bh0 = th[b_off], bh1 = th[b_off + 4];
    const uint32_t bl0 = tl[b_off], bl1 = tl[b_off + 4];
    uint32_t ah[4], al[4];
    ldsm_x4(ah, a_re + a_off);
    split4(ah, al);
    mma_tf32(hh[0], ah, bh0, bh1);
    mma_tf32(hl[0], ah, bl0, bl1);
    mma_tf32(lh[0], al, bh0, bh1);
    ldsm_x4(ah, a_im + a_off);
    split4(ah, al);
    mma_tf32(hh[1], ah, bh0, bh1);
    mma_tf32(hl[1], ah, bl0, bl1);
    mma_tf32(lh[1], al, bh0, bh1);
  }

  // phase: reduce
  __syncthreads();                       // the span is read; reuse it
  float* red = smem;                     // [kWarps][2][kOut]: the host
                                         // makes smem hold it
  for (int pl = 0; pl < 2; ++pl) {
    float* rw = red + (warp * 2 + pl) * kOut;
    // C fragment: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
    const int o = 8 * g + 2 * t;
    rw[o] = hh[pl][0] + (hl[pl][0] + lh[pl][0]);
    rw[o + 1] = hh[pl][1] + (hl[pl][1] + lh[pl][1]);
    rw[o + 64] = hh[pl][2] + (hl[pl][2] + lh[pl][2]);
    rw[o + 65] = hh[pl][3] + (hl[pl][3] + lh[pl][3]);
  }
  __syncthreads();
  const int pl = tid / kOut;
  const int o = tid % kOut;
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc += red[(w * 2 + pl) * kOut + o];
  if (m0 + o < n_out)
    (pl ? out_im : out_re)[(long long)b * n_out + m0 + o] = acc;
  // phase: end
}

template <int D>
int launch(const float* planes, long long n, const int* starts2,
           const int* ks, const float* taps, const float* ramp, int B,
           int n_out, int fft_size, int ntaps, int align, float* out_re,
           float* out_im, float* rot, cudaStream_t stream) {
  const int kpad = (7 * D + ntaps + 7) / 8 * 8;
  const int rows = kGroups - 1 + (kpad + 8 * D - 1) / (8 * D);
  const int tap_idx = kpad + 7 * D;
  const int tap_words = tap_idx + 4 * ((tap_idx + D - 1) / D);
  size_t smem =
      sizeof(float) * (2 * (size_t)rows * (8 * D + 4) + 2 * (size_t)tap_words);
  if (smem < sizeof(float) * 2 * kWarps * kOut)   // the warps' partial sums
    smem = sizeof(float) * 2 * kWarps * kOut;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_frontend_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  burst_ramp_kernel<<<dim3((fft_size + 255) / 256, B), 256, 0, stream>>>(
      ks, ramp, fft_size, rot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + kOut - 1) / kOut, B);
  fused_frontend_kernel<D><<<grid, kThreads, smem, stream>>>(
      planes, n, starts2, rot, taps, n_out, fft_size, ntaps, kpad, rows,
      tap_words, align, out_re, out_im);
  return (int)cudaGetLastError();
}

}  // namespace

// rot: (B, 2, F) f32 scratch for the burst ramps.
extern "C" int fused_frontend(const float* planes, long long n,
                              const int* starts2, const int* ks,
                              const float* taps, const float* ramp, int B,
                              int l_win, int fft_size, int decim, int ntaps,
                              int align, float* out_re, float* out_im,
                              float* rot, cudaStream_t stream) {
  if (fft_size <= 0 || fft_size >= 65536 || B <= 0 || B > 65535 ||
      ntaps <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_out = l_win / decim;
#define FF_CASE(D)                                                       \
  case D:                                                                \
    return launch<D>(planes, n, starts2, ks, taps, ramp, B, n_out,       \
                     fft_size, ntaps, align, out_re, out_im, rot, stream);
  switch (decim) {
    FF_CASE(8)
    FF_CASE(16)
    FF_CASE(32)
    FF_CASE(40)
    FF_CASE(80)
    FF_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FF_CASE
}

extern "C" const char* fused_frontend_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
