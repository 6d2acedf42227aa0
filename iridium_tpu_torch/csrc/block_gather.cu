// Aligned row-block gather: B windows of nt rows of `width` f32 from two
// (mt, width) planes, o[b, i, :] = s[st[b] * rows + i, :] for i < nt.
//
// Replaces: tools/exp_pallas_gather.py, the Pallas kernel at :55-57 with
// its scalar-prefetch grid spec at :59-74 (launched at :75): grid
// (B, nt / rows), each program DMAs one (rows, 640) block of both planes
// starting at block index st[b] + t.
//
// Bound on the H100: a pure copy. It reads each covered input row once and
// writes 2 x B x nt x width x 4 bytes, so it is bound by device memory
// bandwidth; its GB/s is the card's achievable gather rate.
//
// Design: one thread block copies one (b, t) block of `rows` rows of both
// planes, as the TPU grid step did, with every load and store a 16-byte
// float4 (a 640-float row is 2,560 bytes, so rows stay 16-byte aligned).
// Rows outside [0, mt) read as 0. The copy is bit-exact. A TMA bulk-copy
// form (cp.async.bulk) is left for a later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void block_gather_kernel(const float4* __restrict__ sre,
                                    const float4* __restrict__ sim,
                                    long long mt, const int* __restrict__ st,
                                    int nt, int rows, int w4,
                                    float4* __restrict__ o_re,
                                    float4* __restrict__ o_im) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const long long row0 = ((long long)st[b] + t) * rows;
  const long long out0 = ((long long)b * nt + (long long)t * rows) * w4;
  const int n = rows * w4;
  if (row0 >= 0 && row0 + rows <= mt) {     // the whole block is inside
    const float4* re = sre + row0 * w4;
    const float4* im = sim + row0 * w4;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      o_re[out0 + k] = __ldg(re + k);
      o_im[out0 + k] = __ldg(im + k);
    }
    return;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const long long row = row0 + k / w4;
    float4 vr = zero, vi = zero;
    if (row >= 0 && row < mt) {
      const long long s = row0 * w4 + k;
      vr = __ldg(sre + s);
      vi = __ldg(sim + s);
    }
    o_re[out0 + k] = vr;
    o_im[out0 + k] = vi;
  }
}

}  // namespace

extern "C" int block_gather(const float* sre, const float* sim,
                            long long mt, int width, const int* st, int B,
                            int nt, int rows, float* o_re, float* o_im,
                            cudaStream_t stream) {
  dim3 grid(nt / rows, B);
  block_gather_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(sre),
      reinterpret_cast<const float4*>(sim), mt, st, nt, rows, width / 4,
      reinterpret_cast<float4*>(o_re), reinterpret_cast<float4*>(o_im));
  return (int)cudaGetLastError();
}

extern "C" const char* block_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
