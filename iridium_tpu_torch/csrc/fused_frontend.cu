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
// Bound on the H100: per burst it reads l_win complex samples (8 bytes
// each) and does 2 * ntaps multiply-adds per output for l_win / decim
// outputs, about 10 FLOP per input byte at the production 801 taps /
// decim 40. For a 256-burst batch of 327,680-sample windows that is
// 0.10 ms of FP32 work and, if no two windows overlap, 0.20 ms of memory
// traffic; the windows of a dense block overlap in time (bursts on other
// frequencies), which moves the bound to the arithmetic.
//
// Design: one block per (burst, run of kOut outputs), one thread per
// output. The block loads its input span once, rotates it on load and
// stores it in shared memory in polyphase order (phase p = n mod decim
// in rows), so that thread m reads row p at column m + u / decim and a
// warp reads 32 consecutive words: no bank conflicts in the inner loop.
// The rotation uses a (2, F) cos/sin table indexed by the exact integer
// phase (k * n) mod F, the same values as the TPU kernel's ramp table.
// The FIR is plain f32 FMA (the TPU kernel split into bf16 parts only
// because its matrix unit had no f32 dot). Tensor-core and TMA forms are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kOut = 256;

__global__ void fused_frontend_kernel(
    const float* __restrict__ planes, long long n,
    const int* __restrict__ starts2, const int* __restrict__ ks,
    const float* __restrict__ taps, const float* __restrict__ ramp,
    int n_out, int fft_size, int decim, int ntaps, int taps_pad, int q_len,
    int align, float* __restrict__ out_re, float* __restrict__ out_im) {
  extern __shared__ float smem[];
  float* s_taps = smem;
  float* s_re = s_taps + taps_pad;
  float* s_im = s_re + decim * q_len;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kOut;
  const long long w0 =
      (long long)starts2[2 * b] * align + starts2[2 * b + 1];
  const long long kk = ((ks[b] % fft_size) + fft_size) % fft_size;
  const float* re = planes;
  const float* im = planes + n;

  for (int j = tid; j < ntaps; j += kOut) s_taps[j] = taps[j];
  const int span = decim * q_len;
  for (int j = tid; j < span; j += kOut) {
    const long long w = m0 * decim + j;  // window-relative sample
    const long long s = w0 + w;
    const bool in = s >= 0 && s < n;
    const float xr = in ? re[s] : 0.0f;
    const float xi = in ? im[s] : 0.0f;
    const int mm = (int)((kk * (w % fft_size)) % fft_size);
    const float c = ramp[mm];
    const float sn = ramp[fft_size + mm];
    const int p = j % decim;
    const int q = j / decim;
    s_re[p * q_len + q] = xr * c - xi * sn;
    s_im[p * q_len + q] = xr * sn + xi * c;
  }
  __syncthreads();

  const long long m = m0 + tid;
  if (m >= n_out) return;
  float acc_re = 0.0f, acc_im = 0.0f;
  for (int p = 0; p < decim; ++p) {
    const float* row_re = s_re + p * q_len + tid;
    const float* row_im = s_im + p * q_len + tid;
    for (int u = p, q = 0; u < ntaps; u += decim, ++q) {
      const float t = s_taps[u];
      acc_re = fmaf(t, row_re[q], acc_re);
      acc_im = fmaf(t, row_im[q], acc_im);
    }
  }
  out_re[(long long)b * n_out + m] = acc_re;
  out_im[(long long)b * n_out + m] = acc_im;
}

}  // namespace

extern "C" int fused_frontend(const float* planes, long long n,
                              const int* starts2, const int* ks,
                              const float* taps, const float* ramp, int B,
                              int l_win, int fft_size, int decim, int ntaps,
                              int align, float* out_re, float* out_im,
                              cudaStream_t stream) {
  const int n_out = l_win / decim;
  const int taps_pad = (ntaps + 3) / 4 * 4;
  // the span of kOut outputs: (kOut - 1) * decim + ntaps samples
  const int q_len = kOut - 1 + (ntaps + decim - 1) / decim;
  const size_t smem =
      sizeof(float) * ((size_t)taps_pad + 2 * (size_t)decim * q_len);
  cudaError_t err = cudaFuncSetAttribute(
      fused_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + kOut - 1) / kOut, B);
  fused_frontend_kernel<<<grid, kOut, smem, stream>>>(
      planes, n, starts2, ks, taps, ramp, n_out, fft_size, decim, ntaps,
      taps_pad, q_len, align, out_re, out_im);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_frontend_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
