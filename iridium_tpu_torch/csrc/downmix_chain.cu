// Downmix chain: the downmix's steps around its FIRs and FFTs, in four
// launches a class batch (dsp/downmix.py `Downmix.forward`; the FIRs are
// csrc/downmix_fir.cu, the FFTs cuFFT through torch.fft).
//   stage 0 (burst start, one block a row): from filt (B, L) f32 (the box
//     filter over |xd|^2), the row's ext_len, dec_len and shift_dec (B,)
//     i64: the largest filt below flen = max(dec_len - nb + 1, 0), the
//     threshold START_THRESHOLD times it, the first position below flen
//     at or over it (flen where none is), the start with its shift_dec
//     clamps, frame_len = dec_len - start and ok (the window and the
//     decimated row long enough behind the lead, the start early enough);
//     then the fine CFO estimate's input z[i] = xd[start + i]^2 cfo_win[i]
//     for i < min(frame_len, cfo_n) (0 past the row), zero up to
//     cfo_total, which the FFT takes as it is.
//   stage 1 (CFO peak, one block a row): from spec (B, cfo_total) c64, the
//     first argmax of |spec|^2, the signed bin u, the quadratic
//     interpolation corr of the peak and its neighbours (0 at the ends)
//     and fine_offset = (u + corr) / cfo_total / 2.
//   stage 2 (sync products): from fwd (B, corr_n) c64 and the two
//     templates' spectra (corr_n,) c64, (2, B, corr_n) c64 = [fwd dl, fwd
//     ul], so that one inverse FFT serves both.
//   stage 3 (sync peaks and extraction, one block a row): from cc (2, B,
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
// (|x|^2, complex products) are far below. Bytes bound every stage: the
// design reads each row once, coalesced, and reduces it in one block.
//
// Design: stages 0, 1 and 3 give a row to a block of kThreads threads;
// each thread walks the row with stride kThreads and keeps its best
// candidate in registers; warp shuffles, then one shared-memory slot a
// warp, reduce the block (`block_reduce`); thread 0 computes the row's
// scalars and the block shares them through shared memory before it
// writes the row's samples. Stage 0 reads filt twice (the max, then the
// first hit; the second pass stops at each thread's first hit, in L1 or
// L2). Stage 2 is elementwise, a thread a position of both products.
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
  float thr_scale;
};

// Stage 0, row blockIdx.x
__global__ void __launch_bounds__(kThreads) burst_start_kernel(
    const StartArgs a) {
  __shared__ Best slots[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row = (size_t)b * (size_t)a.L;
  const long long dl = a.dec_len[b], sd = a.shift_dec[b];
  const long long fl = dl - a.nb + 1 > 0 ? dl - a.nb + 1 : 0;
  const int hi = fl < a.L ? (int)fl : a.L;
  const float* filt = a.filt + row;
  Best m{-INFINITY, 0};
  for (int i = tid; i < hi; i += kThreads)
    m = pick<Op::kMax>(m, {filt[i], i});
  const float thr = block_reduce<Op::kMax>(m, slots).v * a.thr_scale;
  Best first{0.f, INT_MAX};
  for (int i = tid; i < hi; i += kThreads)
    if (filt[i] >= thr) {
      first.i = i;
      break;
    }
  first = block_reduce<Op::kMin>(first, slots);
  const long long f = first.i == INT_MAX ? fl : first.i;
  long long st = sd;
  if (fl > 0 && f > sd) {
    st = f + (a.nb - 1) / 2 - a.pre_start;
    if (st < sd) st = sd;
  }
  const long long frame_len = dl - st;
  if (tid == 0) {
    a.start[b] = st;
    a.frame_len[b] = frame_len;
    a.ok[b] = (a.ext_len[b] - sd * a.decim >= 100) && (dl - sd >= 100) &&
              (st < dl - 100);
  }
  const long long ncfo = frame_len < a.cfo_n ? frame_len : a.cfo_n;
  float2* z = a.z + (size_t)b * (size_t)a.cfo_total;
  for (int i = tid; i < a.cfo_total; i += kThreads) {
    float2 v = make_float2(0.f, 0.f);
    if (i < ncfo) {
      const long long q = st + i;
      // `shift_take`: 0 past the row, a negative index clamped to 0
      const float2 x = q < a.L ? a.xd[row + (q > 0 ? q : 0)]
                               : make_float2(0.f, 0.f);
      v = cmul(cmul(x, x), make_float2(a.win[i], 0.f));
    }
    z[i] = v;
  }
}

struct PeakArgs {
  const float2* spec;
  long long* u;
  float* corr;
  float* fine_offset;
  int n;
};

// Stage 1, row blockIdx.x
__global__ void __launch_bounds__(kThreads) cfo_peak_kernel(
    const PeakArgs a) {
  __shared__ Best slots[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x, n = a.n;
  const float2* spec = a.spec + (size_t)b * (size_t)n;
  // below every |spec|^2: a thread past the row's end loses
  Best m{-INFINITY, INT_MAX};
  for (int i = tid; i < n; i += kThreads)
    m = pick<Op::kArgmax>(m, {abs2(spec[i]), i});
  const int idx = block_reduce<Op::kArgmax>(m, slots).i;
  if (tid != 0) return;
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
};

// Stage 2: a thread a position
__global__ void __launch_bounds__(kThreads) sync_products_kernel(
    const ProductArgs a) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
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
  float inv_fft, center_frequency, in_rate, out_rate, simplex_min;
};

// Stage 3, row blockIdx.x
__global__ void __launch_bounds__(kThreads) sync_extract_kernel(
    const ExtractArgs a) {
  __shared__ Best slots[kWarps];
  __shared__ float2 s_pc;
  __shared__ int s_from, s_n;
  const int b = blockIdx.x, tid = threadIdx.x, n = a.corr_n;
  const long long fl = a.frame_len[b];
  const long long sl = fl < a.search_cap ? fl : a.search_cap;
  const int hi = sl <= 0 ? 0 : (sl < n ? (int)sl : n);
  const float2* c[2] = {a.cc + (size_t)b * n,
                        a.cc + ((size_t)a.B + b) * (size_t)n};
  // each correlation's peak below search_len (the positions past it hold
  // the fill -1, which every |cc|^2 beats); where none is kept, the first
  // fill
  Best best[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    Best m{-INFINITY, INT_MAX};
    for (int i = tid; i < hi; i += kThreads)
      m = pick<Op::kArgmax>(m, {abs2(c[d][i]), i});
    best[d] = hi > 0 ? block_reduce<Op::kArgmax>(m, slots) : Best{-1.f, 0};
  }
  if (tid == 0) {
    const bool is_dl = best[0].v >= best[1].v;
    const int d = is_dl ? 0 : 1;
    const int off = best[d].i;
    const float2* cd = c[d];
    const float2 cv = cd[off];
    const bool interior = off > 0 && off < sl - 1;
    const float pa = abs2(cd[off > 0 ? off - 1 : 0]);
    const float pb = abs2(cv);
    const float pg = abs2(cd[off < n - 1 ? off + 1 : n - 1]);
    a.uw_corr[b] = interior ? quad_interp(pa, pb, pg) : 0.f;
    const long long uw_start =
        (long long)off - a.sync_len[d] + 1 + a.pre_off[d];
    const float cmag = hypotf(cv.x, cv.y);
    float2 pc = make_float2(1.f, 0.f);
    if (cmag > 0.f) {
      const float2 q = cdiv(cv, cmag);
      pc = make_float2(q.x, -q.y);
    }
    // center_frequency + k / F * in_rate + fine_offset * out_rate, in f32
    const float kf = (float)(a.center_bin[b] - a.half_fft);
    const float cf = ((kf * a.inv_fft) * a.in_rate + a.center_frequency) +
                     a.fine_offset[b] * a.out_rate;
    // the lengths' index: 0 simplex, 1 normal
    const int kind = cf > a.simplex_min ? 0 : 1;
    const long long available = fl - uw_start;
    const long long n_s =
        available < a.max_len[kind] ? available : a.max_len[kind];
    const bool ok = a.ok_in[b] && uw_start >= 0 && uw_start < fl &&
                    available >= a.min_len[kind];
    a.ok[b] = ok;
    a.n_samples[b] = ok ? (int)n_s : 0;
    a.direction[b] = d;
    a.start_dec[b] = (int)a.start[b];
    s_pc = pc;
    s_from = (int)(uw_start < 0 ? 0 : (uw_start > a.L ? a.L : uw_start));
    s_n = (int)(n_s < 0 ? 0 : (n_s < a.frame_cap ? n_s : a.frame_cap));
  }
  __syncthreads();
  const float2 pc = s_pc;
  const int from = s_from, ns = s_n;
  const float2* xr = a.xr + (size_t)b * (size_t)a.L;
  float2* out = a.samples + (size_t)b * (size_t)a.frame_cap;
  for (int i = tid; i < a.frame_cap; i += kThreads) {
    float2 v = make_float2(0.f, 0.f);
    if (i < ns && from + i < a.L) v = cmul(xr[from + i], pc);
    out[i] = v;
  }
}

bool bad_rows(int B, long long L) {
  return B <= 0 || L <= 0 || L >= (1LL << 31) - kThreads;
}

}  // namespace

// One launch of stage `stage` (0: burst start, 1: CFO peak, 2: sync
// products, 3: sync peaks and extraction) over B rows of L (stage 1: of
// cfo_total; stage 2: of corr_n); `ptrs` the stage's device pointers,
// `ints` and `floats` its scalars (host arrays, read before the launch),
// in the orders dsp/downmix.py's wrappers pack them:
//   0: xd, filt, ext_len, dec_len, shift_dec, cfo_win -> start, frame_len,
//      ok, z; ints decim, box taps, pre_start, cfo_n, cfo_total; floats the
//      threshold's factor
//   1: spec -> u, corr, fine_offset
//   2: fwd, dl, ul -> products
//   3: cc, xr, start, frame_len, ok, center_bin, fine_offset -> samples,
//      n_samples, ok, direction, start_dec, uw_corr; ints search_cap,
//      corr_n, max_frame_cap, F, the DL and UL sync lengths and preamble
//      offsets, the simplex and normal max and min lengths; floats the
//      centre frequency, the input and output rates, the simplex minimum.
// A count other than the stage's, or a shape the kernel does not take, is
// refused (cudaErrorInvalidValue) before anything is launched.
extern "C" int downmix_chain(int stage, int B, long long L,
                             void* const* ptrs, int n_ptrs,
                             const long long* ints, int n_ints,
                             const float* floats, int n_floats,
                             cudaStream_t stream) {
  static const int kCounts[4][3] = {{10, 5, 1}, {4, 0, 0}, {4, 0, 0},
                                    {13, 12, 4}};
  if (stage < 0 || stage > 3 || n_ptrs != kCounts[stage][0] ||
      n_ints != kCounts[stage][1] || n_floats != kCounts[stage][2] ||
      n_ptrs > kMaxPtrs || n_ints > kMaxInts || n_floats > kMaxFloats)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (bad_rows(B, L)) return (int)cudaErrorInvalidValue;
  void* const* p = ptrs;
  if (stage == 0) {
    const long long nb = ints[1], cfo_n = ints[3], cfo_total = ints[4];
    if (nb < 1 || cfo_n < 1 || cfo_total < cfo_n || cfo_total > (1 << 24))
      return (int)cudaErrorInvalidValue;
    StartArgs a{(const float2*)p[0],     (const float*)p[1],
                (const long long*)p[2],  (const long long*)p[3],
                (const long long*)p[4],  (const float*)p[5],
                (long long*)p[6],        (long long*)p[7],
                (bool*)p[8],             (float2*)p[9],
                ints[0],                 ints[2],
                (int)L,                  (int)nb,
                (int)cfo_n,              (int)cfo_total,
                floats[0]};
    burst_start_kernel<<<B, kThreads, 0, stream>>>(a);
  } else if (stage == 1) {
    PeakArgs a{(const float2*)p[0], (long long*)p[1], (float*)p[2],
               (float*)p[3], (int)L};
    cfo_peak_kernel<<<B, kThreads, 0, stream>>>(a);
  } else if (stage == 2) {
    const long long total = (long long)B * L;
    if (total >= (1LL << 31) * kThreads) return (int)cudaErrorInvalidValue;
    ProductArgs a{(const float2*)p[0], (const float2*)p[1],
                  (const float2*)p[2], (float2*)p[3], total, (int)L};
    const long long blocks = (total + kThreads - 1) / kThreads;
    sync_products_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  } else {
    const long long search_cap = ints[0], corr_n = ints[1],
                    frame_cap = ints[2], fft = ints[3];
    if (corr_n < 1 || corr_n >= (1LL << 31) / 2 || frame_cap < 1 ||
        frame_cap >= (1LL << 31) - kThreads || fft < 1)
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
    // PyTorch's division by the Python scalar F: the product with its f32
    // reciprocal, computed on the host
    a.inv_fft = 1.0f / (float)fft;
    a.center_frequency = floats[0];
    a.in_rate = floats[1];
    a.out_rate = floats[2];
    a.simplex_min = floats[3];
    sync_extract_kernel<<<B, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* downmix_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
