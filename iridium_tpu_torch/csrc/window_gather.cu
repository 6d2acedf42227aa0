// Burst-window gather: B windows of l_win samples from the two f32 planes
// of the device stream, out[b, i] = plane[tile_b * align + r_b + i], and 0
// where that index lies outside [0, n).
//
// Replaces: iridium_tpu/ops/window_gather.py, make_window_gather (the
// Pallas kernel at :55-73, launched by `gather` :75-114).
//
// Bound on the H100: a copy, bound by device memory bytes: each stream
// sample that the windows cover read once, 2 x B x l_win x 4 bytes
// written. The windows overlap (at 25 MHz 1,024 windows of 614,400 samples
// cover ~98% of a 157 M-sample group stream, about four reads a sample),
// so the writes are most of the bound.
//
// Design, against the three limits of a copy that takes one window at a
// time, four samples a thread, in the order the windows come:
// 1. Aligned 16-byte loads at every fine shift. A window start s is cut
//    into an aligned part s - sh and a shift sh = s & 3. The shift is the
//    same for the whole window, so a block runs one of four copies of the
//    body, compiled per shift. Output float4 j of a window is built in
//    registers from the aligned float4s j and j + 1 of its aligned part
//    (the second only when sh != 0; it is the next lane's first, so it
//    comes from L1). The planes hold a multiple of 4 samples, so an
//    aligned float4 lies wholly inside or wholly outside them: the only
//    mask is a whole vector's, and it reads as zeros.
// 2. Bytes in flight: each thread issues the loads of kVec float4s of
//    both planes (and their neighbours) before its first store; a block
//    moves kThreads * kVec float4s of one window. On the H100 kVec = 1, 2,
//    4 and 8 were within 3.5% of each other; 2 needs no spill.
// 3. The stream read once from device memory: a first kernel ranks the
//    windows by start (a stable counting rank, 32 windows a block, into the
//    `order` scratch), and block p of the gather serves the window of rank
//    p / chunks, so windows that share samples are in flight together and
//    the second read of a sample hits L2. The loads carry an L2 evict_last
//    policy and the stores are streaming (st.global.cs, evict-first), so
//    the 1-5 GB of output does not push the stream out of L2. Both are
//    instruction hints, which a captured graph keeps.
// What is left is L2's own traffic: each window still reads its span from
// L2, so where the stream fits in L2 (1 MHz) the gather takes ~1.2x the
// time `fill_` takes to write the same bytes. A source-major form (a block
// loads a stream chunk once and writes it to every window that covers it)
// was 7% faster there, but slower at 5 and 25 MHz and up to 1.5x slower on
// batches whose unused rows all start at sample 0 (a few blocks then
// write nearly all of the output).
// The copy is bit-exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;                    // float4s of each plane a thread
constexpr int kRun = kThreads * kVec;      // float4s of a window a block

struct Args {
  const float4* re;
  const float4* im;
  long long n4;       // float4s in a plane
  const int* starts2;
  const int* order;   // window index by rank of start
  int align;
  int l4;             // float4s in a window
  int chunks;         // blocks a window
  float4* o_re;
  float4* o_im;
};

__device__ __forceinline__ long long start_of(const int* starts2, int b,
                                              int align) {
  return (long long)starts2[2 * b] * align + starts2[2 * b + 1];
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// aligned float4 q of a plane, zeros outside [0, n4)
__device__ __forceinline__ float4 load(const float4* p, long long q,
                                       long long n4, uint64_t pol) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q >= 0 && q < n4)
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p + q), "l"(pol));
  return v;
}

// samples sh..sh+3 of the 8 in (lo, hi)
template <int SH>
__device__ __forceinline__ float4 shifted(float4 lo, float4 hi) {
  if (SH == 0) return lo;
  if (SH == 1) return make_float4(lo.y, lo.z, lo.w, hi.x);
  if (SH == 2) return make_float4(lo.z, lo.w, hi.x, hi.y);
  return make_float4(lo.w, hi.x, hi.y, hi.z);
}

template <int SH>
__device__ __forceinline__ void copy_run(const Args& a, int b, long long q0,
                                         int j0) {
  const uint64_t pol = evict_last_policy();
  float4 lr[kVec], li[kVec], hr[kVec], hi[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int j = j0 + k * kThreads;
    const long long q = j < a.l4 ? q0 + j : -2;  // -2: no load
    lr[k] = load(a.re, q, a.n4, pol);
    li[k] = load(a.im, q, a.n4, pol);
    if (SH != 0) {
      hr[k] = load(a.re, q + 1, a.n4, pol);
      hi[k] = load(a.im, q + 1, a.n4, pol);
    }
  }
  const long long o = (long long)b * a.l4;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int j = j0 + k * kThreads;
    if (j < a.l4) {
      __stcs(a.o_re + o + j, shifted<SH>(lr[k], hr[k]));
      __stcs(a.o_im + o + j, shifted<SH>(li[k], hi[k]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    rank_kernel(const int* __restrict__ starts2, int B, int align,
                int* __restrict__ order) {
  __shared__ long long keys[kThreads];
  __shared__ int ranks[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const long long key = b < B ? start_of(starts2, b, align) : 0;
  if (threadIdx.x < 32) ranks[threadIdx.x] = 0;
  int rank = 0;
  for (int c0 = 0; c0 < B; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    keys[threadIdx.x] = c < B ? start_of(starts2, c, align) : 0;
    __syncthreads();
    const int m = min(kThreads, B - c0);
    for (int k = warp; k < m; k += kThreads / 32) {
      const long long kc = keys[k];
      rank += kc < key || (kc == key && c0 + k < b);
    }
    __syncthreads();
  }
  atomicAdd(&ranks[lane], rank);
  __syncthreads();
  if (threadIdx.x < 32 && b < B) order[ranks[lane]] = b;
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const Args a) {
  const int rank = blockIdx.x / a.chunks;
  const int chunk = blockIdx.x - rank * a.chunks;
  const int b = a.order[rank];
  const long long s = start_of(a.starts2, b, a.align);
  const int sh = (int)(s & 3);
  const long long q0 = (s - sh) / 4;  // exact: s - sh is a multiple of 4
  const int j0 = chunk * kRun + threadIdx.x;
  switch (sh) {
    case 0: copy_run<0>(a, b, q0, j0); break;
    case 1: copy_run<1>(a, b, q0, j0); break;
    case 2: copy_run<2>(a, b, q0, j0); break;
    default: copy_run<3>(a, b, q0, j0); break;
  }
}

}  // namespace

extern "C" int window_gather(const float* planes, long long n,
                             const int* starts2, int* order, int B,
                             int l_win, int align, float* out_re,
                             float* out_im, cudaStream_t stream) {
  if (B <= 0 || l_win <= 0) return 0;
  const int l4 = l_win / 4;
  const int chunks = (l4 + kRun - 1) / kRun;
  const long long grid = (long long)B * chunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rank_kernel<<<(B + 31) / 32, kThreads, 0, stream>>>(
      starts2, B, align, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Args a{reinterpret_cast<const float4*>(planes),
               reinterpret_cast<const float4*>(planes + n),
               n / 4,
               starts2,
               order,
               align,
               l4,
               chunks,
               reinterpret_cast<float4*>(out_re),
               reinterpret_cast<float4*>(out_im)};
  gather_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
