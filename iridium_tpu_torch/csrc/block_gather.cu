// Aligned row-block gather: B windows of nt rows of `width` f32 from two
// (mt, width) planes, o[b, i, :] = s[st[b] * rows + i, :] for i < nt.
//
// Replaces: tools/exp_pallas_gather.py, the Pallas kernel at :55-57 with
// its scalar-prefetch grid spec at :59-74 (launched at :75): grid
// (B, nt / rows), each program DMAs one (rows, 640) block of both planes
// starting at block index st[b] + t.
//
// Bound on the H100: a pure copy. It must read each covered input row once
// and write 2 x B x nt x width x 4 bytes, so it is bound by device memory
// bandwidth; its GB/s is the card's achievable gather rate.
//
// Design: source-major, with Hopper's 1-D bulk copies (TMA without a
// tensor map). The windows overlap (at the sweep tool's shapes 128
// windows of 512 rows cover ~41,000 distinct rows for 65,536 output
// rows), so a copy per output block would read the shared rows again. Here
// the planes are cut into units of U rows, U the largest divisor of
// `rows` whose rows fit kChunkBytes (1 for wider rows, which go in
// chunks); a unit is wholly inside or wholly outside every window. Thread block u owns unit u: warp 0 finds by ballot
// the windows that cover it (none: nothing to do), and lane 0 loads the
// unit's rows of both planes ONCE into shared memory (`cp.async.bulk`
// global -> shared, completing on an mbarrier), then writes them to every
// covering window (`cp.async.bulk` shared -> global, one bulk group).
// Every size and address is a multiple of 16 bytes (width % 4 == 0).
// Output rows outside [0, mt) read as 0: warps 1-3 of block i write those
// of (b, t) block i with 16-byte stores (the two touch disjoint output
// rows). The copy is bit-exact.
// The sizes are the fastest of the variants measured at the sweep shapes
// on an H100 (PERF.md): 2-row units (5 KB a plane at width 640), small
// enough that many blocks share an SM and keep their copies in flight;
// persistent grids of one to three blocks per SM walking the units with a
// ring of 2-8 stages were 1-2% slower chained and up to 13% slower
// single-call.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;          // warp 0 copies; warps 1-3 zero-fill
constexpr unsigned kChunkBytes = 8192;  // per plane: a unit's most bytes
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const char* sre;
  const char* sim;
  char* o_re;
  char* o_im;
  const int* st;
  long long mt, n_items, n_units, row_bytes;
  int B, nt, rows, per_b, unit;
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           unsigned n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(n)
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

// Unit u to every window that covers it (rows [u * unit, ...) start
// window b's row u * unit - st[b] * rows), in chunks of at most
// kChunkBytes a plane (one chunk unless a row is wider). Run by all of
// warp 0; lane 0 issues the copies, loading a chunk at the first window
// that covers the unit.
__device__ void copy_unit(const Args& a, long long u, unsigned char* buf,
                          unsigned long long* bar) {
  const int lane = threadIdx.x;
  const long long r0 = u * a.unit;
  const long long len = (min(r0 + a.unit, a.mt) - r0) * a.row_bytes;
  const uint32_t re = smem(buf), im = smem(buf + kChunkBytes);
  const uint32_t mb = smem(bar);
  if (lane == 0)
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n"
        "fence.mbarrier_init.release.cluster;\n" ::"r"(mb)
        : "memory");
  for (long long off = 0, k = 0; off < len; off += kChunkBytes, ++k) {
    const unsigned n = (unsigned)min((long long)kChunkBytes, len - off);
    const long long src = r0 * a.row_bytes + off;
    bool loaded = false;
    for (int g = 0; g < a.B; g += 32) {
      const int b = g + lane;
      const long long r = b < a.B ? r0 - (long long)a.st[b] * a.rows : -1;
      unsigned hit = __ballot_sync(kFull, r >= 0 && r < a.nt);
      if (lane != 0) continue;
      for (; hit; hit &= hit - 1) {
        if (!loaded) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              ::"r"(mb), "r"(2 * n)
              : "memory");
          bulk_load(re, a.sre + src, n, mb);
          bulk_load(im, a.sim + src, n, mb);
          mbar_wait(mb, (uint32_t)(k & 1));
          loaded = true;
        }
        const int w = g + __ffs(hit) - 1;
        const long long dst =
            ((long long)w * a.nt + r0 - (long long)a.st[w] * a.rows) *
                a.row_bytes + off;
        bulk_store(a.o_re + dst, re, n);
        bulk_store(a.o_im + dst, im, n);
      }
    }
    if (!__shfl_sync(kFull, loaded, 0)) return;  // no window covers u
    // the stores have read the chunk before the next one is loaded
    if (lane == 0)
      asm volatile(
          "cp.async.bulk.commit_group;\n"
          "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    block_gather_kernel(const Args a) {
  __shared__ __align__(128) unsigned char buf[2 * kChunkBytes];
  __shared__ unsigned long long bar;
  const long long item = blockIdx.x;
  if (threadIdx.x < 32) {
    if (item < a.n_units) copy_unit(a, item, buf, &bar);
    return;
  }
  if (item >= a.n_items) return;
  // zeros for the output rows of (b, t) block `item` outside [0, mt)
  const int w4 = (int)(a.row_bytes / 16);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* o_re = reinterpret_cast<float4*>(a.o_re);
  float4* o_im = reinterpret_cast<float4*>(a.o_im);
  const long long b = item / a.per_b, t = item % a.per_b;
  const long long row0 = ((long long)a.st[b] + t) * a.rows;
  const long long lo = min(max(row0, 0LL), a.mt);
  const long long hi = min(max(row0 + a.rows, 0LL), a.mt);
  // rows [0, in0) and [in1, rows) of the block lie outside the planes
  const long long in0 = hi > lo ? lo - row0 : a.rows;
  const long long in1 = hi > lo ? hi - row0 : a.rows;
  const long long base = (b * a.nt + t * a.rows) * w4;
  const long long k0 = (long long)threadIdx.x - 32;
  for (long long k = k0; k < in0 * w4; k += kThreads - 32) {
    o_re[base + k] = zero;
    o_im[base + k] = zero;
  }
  for (long long k = in1 * w4 + k0; k < (long long)a.rows * w4;
       k += kThreads - 32) {
    o_re[base + k] = zero;
    o_im[base + k] = zero;
  }
}

}  // namespace

extern "C" int block_gather(const float* sre, const float* sim,
                            long long mt, int width, const int* st, int B,
                            int nt, int rows, float* o_re, float* o_im,
                            cudaStream_t stream) {
  if (B <= 0 || nt <= 0) return 0;
  const long long row_bytes = (long long)width * 4;
  int unit = 1;  // the largest divisor of rows whose rows fit one chunk
  for (int d = 1; d <= rows; ++d)
    if (rows % d == 0 && d * row_bytes <= (long long)kChunkBytes) unit = d;
  const Args a{reinterpret_cast<const char*>(sre),
               reinterpret_cast<const char*>(sim),
               reinterpret_cast<char*>(o_re),
               reinterpret_cast<char*>(o_im),
               st,
               mt,
               (long long)B * (nt / rows),
               (mt + unit - 1) / unit,
               row_bytes,
               B,
               nt,
               rows,
               nt / rows,
               unit};
  const long long grid = a.n_units > a.n_items ? a.n_units : a.n_items;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_gather_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* block_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
