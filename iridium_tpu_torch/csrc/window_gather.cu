// Burst-window gather: B windows of l_win samples from the two f32 planes
// of the device stream, out[b, i] = plane[tile_b * align + r_b + i].
//
// Replaces: iridium_tpu/ops/window_gather.py, make_window_gather (the
// Pallas kernel at :55-73, launched by `gather` :75-114).
//
// Bound on the H100: a pure copy. It must read and write 2 planes x B x
// l_win x 4 bytes, so it is bound by device memory bandwidth.
//
// Design: the TPU kernel DMAed ALIGN-row tiles and applied the fine shift
// r with lane rolls; here each thread moves four consecutive samples of
// both planes. Stores are 16-byte and aligned (rows are multiples of
// align); loads are 16-byte when the window start is a multiple of four
// samples, else four coalesced 4-byte loads. Reads past the end of the
// planes return 0. The copy is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_gather_kernel(const float* __restrict__ planes,
                                     long long n,
                                     const int* __restrict__ starts2,
                                     int l_win, int align,
                                     float* __restrict__ out_re,
                                     float* __restrict__ out_im) {
  const int b = blockIdx.y;
  const long long i = 4LL * (blockIdx.x * (long long)kThreads + threadIdx.x);
  if (i >= l_win) return;
  const long long s =
      (long long)starts2[2 * b] * align + starts2[2 * b + 1] + i;
  const float* re = planes;
  const float* im = planes + n;
  float4 vr, vi;
  if ((s & 3) == 0 && s + 4 <= n) {
    vr = *reinterpret_cast<const float4*>(re + s);
    vi = *reinterpret_cast<const float4*>(im + s);
  } else {
    float r4[4], i4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = s + k >= 0 && s + k < n;
      r4[k] = in ? re[s + k] : 0.0f;
      i4[k] = in ? im[s + k] : 0.0f;
    }
    vr = make_float4(r4[0], r4[1], r4[2], r4[3]);
    vi = make_float4(i4[0], i4[1], i4[2], i4[3]);
  }
  const long long o = (long long)b * l_win + i;
  *reinterpret_cast<float4*>(out_re + o) = vr;
  *reinterpret_cast<float4*>(out_im + o) = vi;
}

}  // namespace

extern "C" int window_gather(const float* planes, long long n,
                             const int* starts2, int B, int l_win, int align,
                             float* out_re, float* out_im,
                             cudaStream_t stream) {
  const int per_row = (l_win / 4 + kThreads - 1) / kThreads;
  dim3 grid(per_row, B);
  window_gather_kernel<<<grid, kThreads, 0, stream>>>(
      planes, n, starts2, l_win, align, out_re, out_im);
  return (int)cudaGetLastError();
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
