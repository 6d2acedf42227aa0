// Downmix chain: the downmix's steps around its FIRs and FFTs, in four
// launches a class batch (dsp/downmix.py `Downmix.forward`; the FIRs are
// csrc/downmix_fir.cu, the FFTs cuFFT through torch.fft).
//   stage 0 (burst start, a row a cluster): from filt (B, L) f32 (the box
//     filter over |xd|^2), the row's ext_len, dec_len and shift_dec (B,)
//     i64: the largest filt below flen = max(dec_len - nb + 1, 0), the
//     threshold START_THRESHOLD times it, the first position below flen
//     at or over it (flen where none is), the start with its shift_dec
//     clamps, frame_len = dec_len - start and ok (the window and the
//     decimated row long enough behind the lead, the start early enough);
//     then the fine CFO estimate's input z[i] = xd[start + i]^2 cfo_win[i]
//     for i < min(frame_len, cfo_n) (0 past the row), zero up to
//     cfo_total, which the FFT takes as it is.
//   stage 1 (CFO peak, a row a cluster): from spec (B, cfo_total) c64, the
//     first argmax of |spec|^2, the signed bin u, the quadratic
//     interpolation corr of the peak and its neighbours (0 at the ends)
//     and fine_offset = (u + corr) / cfo_total / 2.
//   stage 2 (sync products): from fwd (B, corr_n) c64 and the two
//     templates' spectra (corr_n,) c64, (2, B, corr_n) c64 = [fwd dl, fwd
//     ul], so that one inverse FFT serves both.
//   stage 3 (sync peaks and extraction, a row a cluster): from cc (2, B,
//     corr_n) c64 (the two correlations) and xr (B, L) c64: each
//     correlation's first argmax of |cc|^2 below search_len = min(
//     frame_len, search_cap), DL where its peak is at least UL's, the
//     quadratic interpolation uw_corr, uw_start, the phase correction pc =
//     conj(c / |c|) of the chosen peak c (1 where |c| is 0), the absolute
//     frequency and its simplex/normal frame lengths, n_samples, and the
//     burst's samples out[i] = xr[uw_start + i] pc for i < n_samples, zero
//     up to max_frame_cap; with ok, direction, start_dec and uw_corr.
//
// Replaces: no pl.pallas_call. iridium_tpu/dsp/downmix.py
// `downmix_from_dec` steps 3, 4 and 7-9 (:410-429, :436-449, :462-531),
// which XLA compiles into the jitted group program; the plain versions are
// dsp/downmix.py `burst_start_plain`, `cfo_peak_plain`,
// `sync_products_plain` and `sync_extract_plain` (with `sync_input_plain`,
// which csrc/downmix_fir.cu's stage 1 writes): ~190 tensor operations.
//
// Bound on the H100, as tools/exp_downmix_chain.py `bound` counts what its
// rows need at the 10 MHz small-normal batch (1,024 x 8,172): bytes, each
// input read once where the masks keep it (filt below flen, the CFO
// samples, spec, fwd and the templates, cc below search_len, the
// extracted xr) and each output written once (z, the products, the
// samples, the per-row fields), ~0.05 ms at 3.35 TB/s; the operations
// (|x|^2, complex products) are far below. At the smaller batches (24 to
// 96 rows) the bound is a few microseconds, and what holds a launch back
// is how few SMs its rows reach and how long each row's walk is.
//
// Design: stages 0, 1 and 3 give a row to a cluster of C blocks (C = 1,
// 2, 4 or 8, dsp/downmix.py `plan`: so many that B C blocks fill the 132
// SMs); block r of a row's cluster reduces its part of the row (16-byte
// loads of two c64 or four f32), its threads' candidates meet by warp
// shuffles and one shared-memory slot a warp (`block_reduce`), and the C
// blocks' results meet through distributed shared memory: each block's
// thread 0 writes its result into its slot of every block of the cluster
// (`mapa`), then one cluster barrier, then each block reduces the C slots
// in rank order (`exchange`). Stage 0 copies its part of filt below flen
// into shared memory as it takes the max (filt is read once from device
// memory), then seeks the first hit there; every block of the cluster
// then knows the row's start and writes its part of z in 16-byte stores.
// Stage 3's scalar section (the peak's neighbours, the phase correction,
// the lengths) is one warp's: three lanes load the neighbours at once;
// the frequency and the frame kind, which do not depend on the peak, are
// computed before the search; each block then extracts its part of the
// samples in 16-byte stores. Stage 2 is elementwise, a thread a pair of
// positions of both products in 16-byte loads and stores. A row's
// reduction takes no sums, and max, argmax (NaN first, then the larger
// value, then the lower index) and first hit do not depend on the order of
// the reduction, so any cluster size gives the same bits.
//
// Arithmetic: the plain versions', in their order, so that each launch is
// bit-equal to its twin on the card (built with --fmad=false, as the
// twins' separate tensor operations round each product and sum). |x| is
// PyTorch's complex abs on the card, hypotf, and |x|^2 one product more
// (`x.abs() ** 2`); argmax takes PyTorch's order (a NaN first, then the
// larger value, then the lower index); the complex product is PyTorch's
// (`cmul`, two fused multiply-adds), also where a real tensor is promoted
// to complex (the window: imaginary part 0); a division by a Python scalar
// is a product with the f32 reciprocal, a comparison with one is made in
// f32; c / |c| is c10::complex division by the promoted real (`cdiv`).
// Outputs may differ from the plain versions in the sign of a zero.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxShared = 232448;      // a block's shared memory on the H100
// stage 0's dynamic shared memory at most: the rest for its static slots
constexpr int kMaxStaged = kMaxShared - 1024;
constexpr int kMaxPtrs = 16;
constexpr int kMaxInts = 16;
constexpr int kMaxFloats = 8;

// `_quad_interp`'s denominator guard, the Python constant 1e-10 in f32
constexpr float kGuard = static_cast<float>(1e-10);

// (a + bi)(c + di) as PyTorch's CUDA complex product computes it (see
// csrc/downmix_fir.cu)
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(__fmaf_rn(x.x, y.x, -(x.y * y.y)),
                     __fmaf_rn(x.x, y.y, x.y * y.x));
}

// c / d for a real d > 0 promoted to complex (imaginary part 0), as
// c10::complex<float>'s division computes it (|d| >= |0|: rat = 0 / d, scl
// = 1 / (d + 0 rat))
__device__ __forceinline__ float2 cdiv(float2 c, float d) {
  const float rat = 0.f / d;
  const float scl = 1.0f / (d + 0.f * rat);
  return make_float2((c.x + c.y * rat) * scl, (c.y - c.x * rat) * scl);
}

// `x.abs() ** 2` on the card
__device__ __forceinline__ float abs2(float2 x) {
  const float m = hypotf(x.x, x.y);
  return m * m;
}

__device__ __forceinline__ float2 lo2(float4 v) {
  return make_float2(v.x, v.y);
}

__device__ __forceinline__ float2 hi2(float4 v) {
  return make_float2(v.z, v.w);
}

__device__ __forceinline__ float4 pair(float2 a, float2 b) {
  return make_float4(a.x, a.y, b.x, b.y);
}

// PyTorch's argmax order: does (a, ia) come before (b, ib)?
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

// `_quad_interp`: 0.5 (alpha - gamma) / denom where |denom| > 1e-10
__device__ __forceinline__ float quad_interp(float alpha, float beta,
                                             float gamma) {
  const float denom = (alpha - 2.0f * beta) + gamma;
  return fabsf(denom) > kGuard ? (0.5f * (alpha - gamma)) / denom : 0.f;
}

// A candidate of an argmax (value, index), or of a max or a min
struct Best {
  float v;
  int i;
};

enum class Op { kArgmax, kMax, kMin };

template <Op op>
__device__ __forceinline__ Best pick(Best a, Best b) {
  if (op == Op::kArgmax) return beats(b.v, b.i, a.v, a.i) ? b : a;
  if (op == Op::kMax) return (isnan(b.v) || b.v > a.v) ? b : a;
  return b.i < a.i ? b : a;
}

// The block's reduction of every thread's candidate; every thread gets it.
// `slots` holds kWarps candidates; the call ends with a barrier.
template <Op op>
__device__ Best block_reduce(Best x, Best* slots) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const Best o{__shfl_xor_sync(0xffffffffu, x.v, s),
                 __shfl_xor_sync(0xffffffffu, x.i, s)};
    x = pick<op>(x, o);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) slots[warp] = x;
  __syncthreads();
  Best r = slots[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = pick<op>(r, slots[w]);
  __syncthreads();
  return r;
}

// Every thread of every block of the cluster: what any of them wrote
// before it (shared or device memory) is seen by any of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// *p in the shared memory of cluster block `rank` (a generic address)
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(a)
               : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(a);
}

// The cluster's reduction of its C blocks' results (`block_reduce`'s, the
// same in every thread of a block), N at once: thread 0 of each block
// writes its results into slot `rank` of `box` (N rows of kMaxCluster) in
// every block of the cluster, then one cluster barrier, then every thread
// reduces the C slots of each row in rank order. After the barrier no
// block touches another's shared memory, so a block may return at once.
template <Op op, int N>
__device__ __forceinline__ void exchange(Best (&x)[N],
                                         Best (*box)[kMaxCluster], int C,
                                         int rank) {
  if (C == 1) return;
  if (threadIdx.x == 0)
    for (int q = 0; q < C; ++q)
#pragma unroll
      for (int k = 0; k < N; ++k) *peer(&box[k][rank], q) = x[k];
  cluster_sync();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Best r = box[k][0];
    for (int q = 1; q < C; ++q) r = pick<op>(r, box[k][q]);
    x[k] = r;
  }
}

// [lo, hi) of [0, n): the part of block `rank` of C, parts of `part`
// positions
__device__ __forceinline__ int2 part_of(int n, int part, int rank) {
  const long long lo = (long long)rank * part;
  const int a = lo < n ? (int)lo : n;
  const int b = n - a < part ? n : a + part;
  return make_int2(a, b);
}

// ceil(n / C) rounded up to even: the parts of pairs
__host__ __device__ __forceinline__ int even_part(int n, int C) {
  const int p = (n + C - 1) / C;
  return p + (p & 1);
}

struct StartArgs {
  const float2* xd;
  const float* filt;
  const long long* ext_len;
  const long long* dec_len;
  const long long* shift_dec;
  const float* win;
  long long* start;
  long long* frame_len;
  bool* ok;
  float2* z;
  long long decim, pre_start;
  int L, nb, cfo_n, cfo_total;
  int C, part;     // the cluster, and the filt positions a block stages
  int vec;         // z is 16-byte aligned and cfo_total even
  float thr_scale;
};

// Stage 0, block r of row b's cluster
__global__ void __launch_bounds__(kThreads) burst_start_kernel(
    const StartArgs a) {
  extern __shared__ float4 staged4[];
  __shared__ Best slots[kWarps];
  __shared__ Best box_max[1][kMaxCluster], box_first[1][kMaxCluster];
  const int C = a.C, b = blockIdx.x / C, rank = blockIdx.x % C;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * (size_t)a.L;
  const long long dl = a.dec_len[b], sd = a.shift_dec[b];
  const long long fl = dl - a.nb + 1 > 0 ? dl - a.nb + 1 : 0;
  const int hi = fl < a.L ? (int)fl : a.L;
  // this block's part of filt below flen, copied into shared memory at
  // the same alignment modulo 16 bytes, so that both sides take float4
  const int2 pr = part_of(hi, a.part, rank);
  const int n = pr.y - pr.x;
  const float* src = a.filt + row + pr.x;
  const int sh = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* const dst = reinterpret_cast<float*>(staged4) + sh;
  const int head = min((4 - sh) & 3, n);
  const int nv = (n - head) >> 2;
  Best m[1] = {{-INFINITY, 0}};
  if (tid < head) {
    const float v = src[tid];
    dst[tid] = v;
    m[0] = pick<Op::kMax>(m[0], {v, 0});
  }
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int q = tid; q < nv; q += kThreads) {
    const float4 v = src4[q];
    dst4[q] = v;
    m[0] = pick<Op::kMax>(m[0], {v.x, 0});
    m[0] = pick<Op::kMax>(m[0], {v.y, 0});
    m[0] = pick<Op::kMax>(m[0], {v.z, 0});
    m[0] = pick<Op::kMax>(m[0], {v.w, 0});
  }
  const int tail = head + 4 * nv + tid;
  if (tail < n) {
    const float v = src[tail];
    dst[tail] = v;
    m[0] = pick<Op::kMax>(m[0], {v, 0});
  }
  m[0] = block_reduce<Op::kMax>(m[0], slots);   // its barrier: dst is full
  exchange<Op::kMax>(m, box_max, C, rank);
  const float thr = m[0].v * a.thr_scale;
  Best first[1] = {{0.f, INT_MAX}};
  for (int i = tid; i < n; i += kThreads)
    if (dst[i] >= thr) {
      first[0].i = pr.x + i;
      break;
    }
  first[0] = block_reduce<Op::kMin>(first[0], slots);
  exchange<Op::kMin>(first, box_first, C, rank);
  const long long f = first[0].i == INT_MAX ? fl : first[0].i;
  long long st = sd;
  if (fl > 0 && f > sd) {
    st = f + (a.nb - 1) / 2 - a.pre_start;
    if (st < sd) st = sd;
  }
  const long long frame_len = dl - st;
  if (rank == 0 && tid == 0) {
    a.start[b] = st;
    a.frame_len[b] = frame_len;
    a.ok[b] = (a.ext_len[b] - sd * a.decim >= 100) && (dl - sd >= 100) &&
              (st < dl - 100);
  }
  const long long ncfo = frame_len < a.cfo_n ? frame_len : a.cfo_n;
  auto zval = [&](int i) {
    float2 v = make_float2(0.f, 0.f);
    if (i < ncfo) {
      const long long q = st + i;
      // `shift_take`: 0 past the row, a negative index clamped to 0
      const float2 x = q < a.L ? a.xd[row + (q > 0 ? q : 0)]
                               : make_float2(0.f, 0.f);
      v = cmul(cmul(x, x), make_float2(a.win[i], 0.f));
    }
    return v;
  };
  float2* z = a.z + (size_t)b * (size_t)a.cfo_total;
  if (a.vec) {
    const int2 zp = part_of(a.cfo_total, even_part(a.cfo_total, C), rank);
    float4* z4 = reinterpret_cast<float4*>(z);
    for (int i = zp.x + 2 * tid; i < zp.y; i += 2 * kThreads)
      z4[i >> 1] = pair(zval(i), zval(i + 1));
  } else {
    const int2 zp = part_of(a.cfo_total, (a.cfo_total + C - 1) / C, rank);
    for (int i = zp.x + tid; i < zp.y; i += kThreads) z[i] = zval(i);
  }
}

struct PeakArgs {
  const float2* spec;
  long long* u;
  float* corr;
  float* fine_offset;
  int n;
  int C;
  int vec;         // spec is 16-byte aligned and n even
};

// Stage 1, block r of row b's cluster
__global__ void __launch_bounds__(kThreads) cfo_peak_kernel(
    const PeakArgs a) {
  __shared__ Best slots[kWarps];
  __shared__ Best box[1][kMaxCluster];
  const int C = a.C, b = blockIdx.x / C, rank = blockIdx.x % C;
  const int tid = threadIdx.x, n = a.n;
  const float2* spec = a.spec + (size_t)b * (size_t)n;
  // below every |spec|^2: a thread past its part loses
  Best m[1] = {{-INFINITY, INT_MAX}};
  if (a.vec) {
    const int2 p = part_of(n, even_part(n, C), rank);
    const float4* s4 = reinterpret_cast<const float4*>(spec);
    for (int i = p.x + 2 * tid; i < p.y; i += 2 * kThreads) {
      const float4 v = s4[i >> 1];
      m[0] = pick<Op::kArgmax>(m[0], {abs2(lo2(v)), i});
      m[0] = pick<Op::kArgmax>(m[0], {abs2(hi2(v)), i + 1});
    }
  } else {
    const int2 p = part_of(n, (n + C - 1) / C, rank);
    for (int i = p.x + tid; i < p.y; i += kThreads)
      m[0] = pick<Op::kArgmax>(m[0], {abs2(spec[i]), i});
  }
  m[0] = block_reduce<Op::kArgmax>(m[0], slots);
  exchange<Op::kArgmax>(m, box, C, rank);
  if (rank != 0 || tid != 0) return;
  const int idx = m[0].i;
  const float pa = abs2(spec[idx > 0 ? idx - 1 : 0]);
  const float pb = abs2(spec[idx]);
  const float pg = abs2(spec[idx < n - 1 ? idx + 1 : n - 1]);
  const bool interior = idx > 0 && idx < n - 1;
  const long long u = idx >= n / 2 ? (long long)idx - n : idx;
  const float corr = interior ? quad_interp(pa, pb, pg) : 0.f;
  a.u[b] = u;
  a.corr[b] = corr;
  // (u.float() + corr) / cfo_total / 2.0
  a.fine_offset[b] =
      (((float)u + corr) * (1.0f / (float)n)) * (1.0f / 2.0f);
}

struct ProductArgs {
  const float2* fwd;
  const float2* dl;
  const float2* ul;
  float2* out;
  long long total;  // B corr_n
  int n;
  int vec;          // every pointer 16-byte aligned and n even
};

// Stage 2: a thread a pair of positions (vec), or a position
__global__ void __launch_bounds__(kThreads) sync_products_kernel(
    const ProductArgs a) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (a.vec) {
    if (2 * p >= a.total) return;
    const float4 f = reinterpret_cast<const float4*>(a.fwd)[p];
    const long long i = (2 * p) % a.n >> 1;
    const float4 d = reinterpret_cast<const float4*>(a.dl)[i];
    const float4 u = reinterpret_cast<const float4*>(a.ul)[i];
    float4* out = reinterpret_cast<float4*>(a.out);
    out[p] = pair(cmul(lo2(f), lo2(d)), cmul(hi2(f), hi2(d)));
    out[(a.total >> 1) + p] = pair(cmul(lo2(f), lo2(u)),
                                   cmul(hi2(f), hi2(u)));
    return;
  }
  if (p >= a.total) return;
  const float2 f = a.fwd[p];
  const int i = (int)(p % a.n);
  a.out[p] = cmul(f, a.dl[i]);
  a.out[a.total + p] = cmul(f, a.ul[i]);
}

struct ExtractArgs {
  const float2* cc;
  const float2* xr;
  const long long* start;
  const long long* frame_len;
  const bool* ok_in;
  const long long* center_bin;
  const float* fine_offset;
  float2* samples;
  int* n_samples;
  bool* ok;
  int* direction;
  int* start_dec;
  float* uw_corr;
  long long B;
  int L, search_cap, corr_n, frame_cap;
  int sync_len[2], pre_off[2], max_len[2], min_len[2];
  int half_fft;
  int C;
  int vec_cc;       // cc 16-byte aligned and corr_n even
  int vec_out;      // samples 16-byte aligned and frame_cap even
  float inv_fft, center_frequency, in_rate, out_rate, simplex_min;
};

// Stage 3, block r of row b's cluster
__global__ void __launch_bounds__(kThreads) sync_extract_kernel(
    const ExtractArgs a) {
  __shared__ Best slots[kWarps];
  __shared__ Best box[2][kMaxCluster];
  __shared__ float2 s_pc;
  __shared__ int s_from, s_n;
  const int C = a.C, b = blockIdx.x / C, rank = blockIdx.x % C;
  const int tid = threadIdx.x, lane = tid & 31, n = a.corr_n;
  const long long fl = a.frame_len[b];
  const long long sl = fl < a.search_cap ? fl : a.search_cap;
  const int hi = sl <= 0 ? 0 : (sl < n ? (int)sl : n);
  const float2* c[2] = {a.cc + (size_t)b * n,
                        a.cc + ((size_t)a.B + b) * (size_t)n};
  // the frame's kind, which does not depend on the peak: center_frequency
  // + k / F * in_rate + fine_offset * out_rate, in f32; 0 simplex, 1
  // normal (warp 0 only)
  int kind = 0;
  if (tid < 32) {
    const float kf = (float)(a.center_bin[b] - a.half_fft);
    const float cf = ((kf * a.inv_fft) * a.in_rate + a.center_frequency) +
                     a.fine_offset[b] * a.out_rate;
    kind = cf > a.simplex_min ? 0 : 1;
  }
  // each correlation's peak below search_len in this block's part (the
  // positions past it hold the fill -1, which every |cc|^2 beats); where
  // none is kept, the first fill
  Best best[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    Best m{-INFINITY, INT_MAX};
    if (a.vec_cc) {
      const int2 p = part_of(hi, even_part(hi, C), rank);
      const float4* c4 = reinterpret_cast<const float4*>(c[d]);
      for (int i = p.x + 2 * tid; i < p.y; i += 2 * kThreads) {
        const float4 v = c4[i >> 1];
        m = pick<Op::kArgmax>(m, {abs2(lo2(v)), i});
        if (i + 1 < p.y) m = pick<Op::kArgmax>(m, {abs2(hi2(v)), i + 1});
      }
    } else {
      const int2 p = part_of(hi, (hi + C - 1) / C, rank);
      for (int i = p.x + tid; i < p.y; i += kThreads)
        m = pick<Op::kArgmax>(m, {abs2(c[d][i]), i});
    }
    best[d] = block_reduce<Op::kArgmax>(m, slots);
  }
  exchange<Op::kArgmax>(best, box, C, rank);
  if (hi == 0) best[0] = best[1] = Best{-1.f, 0};
  // the row's scalars, one warp: lanes 0-2 read the chosen peak and its
  // neighbours at once, lane 0 computes the rest
  if (tid < 32) {
    const bool is_dl = best[0].v >= best[1].v;
    const int d = is_dl ? 0 : 1;
    const int off = best[d].i;
    const float2* cd = is_dl ? c[0] : c[1];
    const int at = lane == 0 ? (off > 0 ? off - 1 : 0)
                             : (lane == 2 ? (off < n - 1 ? off + 1 : n - 1)
                                          : off);
    float2 v = make_float2(0.f, 0.f);
    float p2 = 0.f;
    if (lane < 3) {
      v = cd[at];
      p2 = abs2(v);
    }
    const float pb = __shfl_sync(0xffffffffu, p2, 1);
    const float pg = __shfl_sync(0xffffffffu, p2, 2);
    const float cvx = __shfl_sync(0xffffffffu, v.x, 1);
    const float cvy = __shfl_sync(0xffffffffu, v.y, 1);
    if (lane == 0) {
      const float pa = p2;
      const float2 cv = make_float2(cvx, cvy);
      const bool interior = off > 0 && off < sl - 1;
      const long long uw_start =
          (long long)off - a.sync_len[d] + 1 + a.pre_off[d];
      const float cmag = hypotf(cv.x, cv.y);
      float2 pc = make_float2(1.f, 0.f);
      if (cmag > 0.f) {
        const float2 q = cdiv(cv, cmag);
        pc = make_float2(q.x, -q.y);
      }
      const long long available = fl - uw_start;
      const long long n_s =
          available < a.max_len[kind] ? available : a.max_len[kind];
      if (rank == 0) {
        const bool ok = a.ok_in[b] && uw_start >= 0 && uw_start < fl &&
                        available >= a.min_len[kind];
        a.uw_corr[b] = interior ? quad_interp(pa, pb, pg) : 0.f;
        a.ok[b] = ok;
        a.n_samples[b] = ok ? (int)n_s : 0;
        a.direction[b] = d;
        a.start_dec[b] = (int)a.start[b];
      }
      s_pc = pc;
      s_from = (int)(uw_start < 0 ? 0 : (uw_start > a.L ? a.L : uw_start));
      s_n = (int)(n_s < 0 ? 0 : (n_s < a.frame_cap ? n_s : a.frame_cap));
    }
  }
  __syncthreads();
  const float2 pc = s_pc;
  const int from = s_from, ns = s_n;
  const float2* xr = a.xr + (size_t)b * (size_t)a.L;
  float2* out = a.samples + (size_t)b * (size_t)a.frame_cap;
  auto sample = [&](int i) {
    return i < ns && from + i < a.L ? cmul(xr[from + i], pc)
                                    : make_float2(0.f, 0.f);
  };
  if (a.vec_out) {
    const int2 p = part_of(a.frame_cap, even_part(a.frame_cap, C), rank);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = p.x + 2 * tid; i < p.y; i += 2 * kThreads)
      out4[i >> 1] = pair(sample(i), sample(i + 1));
  } else {
    const int2 p = part_of(a.frame_cap, (a.frame_cap + C - 1) / C, rank);
    for (int i = p.x + tid; i < p.y; i += kThreads) out[i] = sample(i);
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_cluster(long long C, int B) {
  return !(C == 1 || C == 2 || C == 4 || C == kMaxCluster) ||
         (long long)B * C >= (1LL << 31);
}

// `blocks` blocks in clusters of C; `smem` bytes of dynamic shared memory
// a block
template <typename Args>
cudaError_t launch(void (*kern)(Args), const Args& args, long long blocks,
                   int C, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kern, args);
}

}  // namespace

// Sets stage 0's dynamic shared memory limit, once, when the library is
// loaded (before any graph capture).
extern "C" int downmix_chain_init() {
  return (int)cudaFuncSetAttribute(
      burst_start_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxStaged);
}

// One launch of stage `stage` (0: burst start, 1: CFO peak, 2: sync
// products, 3: sync peaks and extraction) over B rows of L (stage 1: of
// cfo_total; stage 2: of corr_n); `ptrs` the stage's device pointers,
// `ints` and `floats` its scalars (host arrays, read before the launch),
// in the orders dsp/downmix.py's wrappers pack them, the layout
// (dsp/downmix.py `plan`) last:
//   0: xd, filt, ext_len, dec_len, shift_dec, cfo_win -> start, frame_len,
//      ok, z; ints decim, box taps, pre_start, cfo_n, cfo_total, the
//      cluster, the filt positions a block stages (a multiple of 4, at
//      least L / cluster; 4 (part + 4) bytes of shared memory, at most
//      kMaxStaged); floats the
//      threshold's factor
//   1: spec -> u, corr, fine_offset; ints the cluster
//   2: fwd, dl, ul -> products
//   3: cc, xr, start, frame_len, ok, center_bin, fine_offset -> samples,
//      n_samples, ok, direction, start_dec, uw_corr; ints search_cap,
//      corr_n, max_frame_cap, F, the DL and UL sync lengths and preamble
//      offsets, the simplex and normal max and min lengths, the cluster;
//      floats the centre frequency, the input and output rates, the
//      simplex minimum.
// A cluster of 1, 2, 4 or 8 blocks. A count other than the stage's, or a
// shape or layout the kernel does not take, is refused
// (cudaErrorInvalidValue) before anything is launched.
extern "C" int downmix_chain(int stage, int B, long long L,
                             void* const* ptrs, int n_ptrs,
                             const long long* ints, int n_ints,
                             const float* floats, int n_floats,
                             cudaStream_t stream) {
  static const int kCounts[4][3] = {{10, 7, 1}, {4, 1, 0}, {4, 0, 0},
                                    {13, 13, 4}};
  if (stage < 0 || stage > 3 || n_ptrs != kCounts[stage][0] ||
      n_ints != kCounts[stage][1] || n_floats != kCounts[stage][2] ||
      n_ptrs > kMaxPtrs || n_ints > kMaxInts || n_floats > kMaxFloats)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (B < 0 || L <= 0 || L >= (1LL << 31) - kThreads)
    return (int)cudaErrorInvalidValue;
  void* const* p = ptrs;
  cudaError_t err = cudaSuccess;
  if (stage == 0) {
    const long long nb = ints[1], cfo_n = ints[3], cfo_total = ints[4];
    const long long C = ints[5], part = ints[6];
    if (nb < 1 || cfo_n < 1 || cfo_total < cfo_n || cfo_total > (1 << 24) ||
        bad_cluster(C, B) || part < 4 || part % 4 != 0 ||
        part * C < L || 4 * (part + 4) > kMaxStaged)
      return (int)cudaErrorInvalidValue;
    StartArgs a{(const float2*)p[0],     (const float*)p[1],
                (const long long*)p[2],  (const long long*)p[3],
                (const long long*)p[4],  (const float*)p[5],
                (long long*)p[6],        (long long*)p[7],
                (bool*)p[8],             (float2*)p[9],
                ints[0],                 ints[2],
                (int)L,                  (int)nb,
                (int)cfo_n,              (int)cfo_total,
                (int)C,                  (int)part,
                aligned(p[9]) && cfo_total % 2 == 0,
                floats[0]};
    err = launch(burst_start_kernel, a, B * C, (int)C,
                 (int)(4 * (part + 4)), stream);
  } else if (stage == 1) {
    const long long C = ints[0];
    if (bad_cluster(C, B)) return (int)cudaErrorInvalidValue;
    PeakArgs a{(const float2*)p[0], (long long*)p[1], (float*)p[2],
               (float*)p[3], (int)L, (int)C, aligned(p[0]) && L % 2 == 0};
    err = launch(cfo_peak_kernel, a, B * C, (int)C, 0, stream);
  } else if (stage == 2) {
    const long long total = (long long)B * L;
    if (total >= (1LL << 31) * kThreads) return (int)cudaErrorInvalidValue;
    const bool vec = L % 2 == 0 && aligned(p[0]) && aligned(p[1]) &&
                     aligned(p[2]) && aligned(p[3]);
    ProductArgs a{(const float2*)p[0], (const float2*)p[1],
                  (const float2*)p[2], (float2*)p[3], total, (int)L, vec};
    const long long each = vec ? 2 : 1;
    const long long blocks =
        (total + each * kThreads - 1) / (each * kThreads);
    err = launch(sync_products_kernel, a, blocks, 1, 0, stream);
  } else {
    const long long search_cap = ints[0], corr_n = ints[1],
                    frame_cap = ints[2], fft = ints[3], C = ints[12];
    if (corr_n < 1 || corr_n >= (1LL << 31) / 2 || frame_cap < 1 ||
        frame_cap >= (1LL << 31) - 2 * kThreads || fft < 1 ||
        bad_cluster(C, B))
      return (int)cudaErrorInvalidValue;
    ExtractArgs a{};
    a.cc = (const float2*)p[0];
    a.xr = (const float2*)p[1];
    a.start = (const long long*)p[2];
    a.frame_len = (const long long*)p[3];
    a.ok_in = (const bool*)p[4];
    a.center_bin = (const long long*)p[5];
    a.fine_offset = (const float*)p[6];
    a.samples = (float2*)p[7];
    a.n_samples = (int*)p[8];
    a.ok = (bool*)p[9];
    a.direction = (int*)p[10];
    a.start_dec = (int*)p[11];
    a.uw_corr = (float*)p[12];
    a.B = B;
    a.L = (int)L;
    a.search_cap = (int)search_cap;
    a.corr_n = (int)corr_n;
    a.frame_cap = (int)frame_cap;
    a.half_fft = (int)(fft / 2);
    for (int d = 0; d < 2; ++d) {
      a.sync_len[d] = (int)ints[4 + d];
      a.pre_off[d] = (int)ints[6 + d];
      a.max_len[d] = (int)ints[8 + d];
      a.min_len[d] = (int)ints[10 + d];
    }
    a.C = (int)C;
    a.vec_cc = aligned(p[0]) && corr_n % 2 == 0;
    a.vec_out = aligned(p[7]) && frame_cap % 2 == 0;
    // PyTorch's division by the Python scalar F: the product with its f32
    // reciprocal, computed on the host
    a.inv_fft = 1.0f / (float)fft;
    a.center_frequency = floats[0];
    a.in_rate = floats[1];
    a.out_rate = floats[2];
    a.simplex_min = floats[3];
    err = launch(sync_extract_kernel, a, B * C, (int)C, 0, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* downmix_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
