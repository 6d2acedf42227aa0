// Burst-detector scan: the per-bin detector state machine of
// burst_detect.c:426-699 over one block of fftshifted |X|^2 frames, with
// the greedy argmax creation walk.
//
// Replaces: iridium_tpu/dsp/detect_pallas.py, make_scan_pallas (the Pallas
// kernel at :152-375, launched by `run` :377-482).
//
// Bound on the H100: it must read n_frames x F x 4 bytes of |X|^2 (67 MB
// for a 2048 x 8192 block, about 20 us at 3.35 TB/s) plus at most two
// history rows per frame. The real floor is the chain of frames: frame
// f + 1 depends on the state that frame f leaves, so the frames run one
// after another and the time goes to per-frame latency, not to bytes.
//
// Design: ONE thread block walks the frames in order. Each of its
// T = min(1024, F) threads owns BPT = F / T contiguous bins. The hot
// per-bin state lives on chip: baseline_sum, |X|^2 and the relative
// magnitude in registers, a_last and mask_count in shared memory (each
// thread touches only its own words), a_valid as a bitmask. The cold
// per-bin fields (a_id, a_start, a_mag, a_noise) are read and written in
// device memory only on the rare frames that create, delete or squelch a
// burst, and the noise history ring stays in device memory (it fits in
// L2). A noise-only frame costs one block-wide vote; the frame's |X|^2
// row is loaded one frame ahead. Block-wide sums, prefix sums (emission
// ranks in ascending bin order) and the argmax (max value, lowest bin on
// ties, as one 64-bit key) use warp shuffles and shared memory.
//
// Semantics follow the Pallas kernel exactly: frames past n_valid leave
// the state alone; candidates come from the carried mask; deletions emit
// in ascending bin order, at most kEDel per frame, and release the mask
// of every gone bin; a long-burst deletion forces a noise update before
// creation; squelch emits at most kESq per frame. The history is kept as
// a ring (oldest row at hist_idx); the Pallas kernel returns it linear
// with hist_idx 0, which is the same history.

#include <cuda_runtime.h>

namespace {

constexpr int kEDel = 8;
constexpr int kESq = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int F, n_frames, H, G, n_valid, half_bw, k_create, max_bursts,
      max_burst_len, post_len, pre_len;
  float threshold, hist_f, enbw, f2, bin_width;
};

struct State {
  const float* mag2;
  float* hist;
  float* bsum;
  unsigned char* a_valid;
  int* a_id;
  int* a_start;
  int* a_last;
  float* a_mag;
  float* a_noise;
  int* mask_count;
  int* g_id;
  int* g_start;
  int* g_stop;
  int* g_last;
  int* g_bin;
  float* g_mag;
  float* g_noise;
  int* sc;    // hist_idx, primed, burst_id, squelch_count, n_tagged,
              // burst_dropped, create_waits, g_count
  float* scf;  // peak_signal_db
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Sum over the block; every thread gets it.
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = lane < nw ? red[lane] : 0;
  r = warp_sum(r);
  __syncthreads();
  return r;
}

// Exclusive prefix sum in thread order; *total gets the block sum.
__device__ int block_excl_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  const int ws = lane < nw ? red[lane] : 0;
  const int wi = warp_incl_scan(ws);
  const int warp_off = __shfl_sync(kFull, wi - ws, warp);
  *total = __shfl_sync(kFull, wi, 31);
  __syncthreads();
  return warp_off + incl - v;
}

__device__ unsigned long long block_max64(unsigned long long v,
                                          unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(kFull, v, o);
    v = t > v ? t : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned long long r = lane < nw ? red[lane] : 0ull;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(kFull, r, o);
    r = t > r ? t : r;
  }
  __syncthreads();
  return r;
}

template <int BPT>
__global__ void __launch_bounds__(1024)
    detect_scan_kernel(State st, Params p) {
  extern __shared__ unsigned long long smem_u64[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int F = p.F, H = p.H, hb = p.half_bw, dc = F / 2;
  unsigned long long* s_red64 = smem_u64;             // 32
  int* s_red = reinterpret_cast<int*>(s_red64 + 32);  // 32
  int* s_last = s_red + 32;                           // F, [i * T + tid]
  int* s_mask = s_last + F;                           // F, [i * T + tid]
  float* s_lo = reinterpret_cast<float*>(s_mask + F);  // T
  float* s_hi = s_lo + T;                              // T
  unsigned char* s_flag = reinterpret_cast<unsigned char*>(s_hi + T);  // F
  const int b0 = tid * BPT;
#define SI(i) ((i) * T + tid)

  float bsum[BPT], mag[BPT], nxt[BPT], rel[BPT];
  unsigned valid = 0, elig = 0;
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int g = b0 + i;
    bsum[i] = st.bsum[g];
    if (st.a_valid[g]) valid |= 1u << i;
    s_last[SI(i)] = st.a_last[g];
    s_mask[SI(i)] = st.mask_count[g];
    if (g >= hb && g < F - hb && !(g >= dc - 3 && g <= dc + 3))
      elig |= 1u << i;
    nxt[i] = st.mag2[g];
  }
  int hidx = st.sc[0], prim = st.sc[1], burst_id = st.sc[2];
  int sq_count = st.sc[3], n_tagged = st.sc[4], dropped = st.sc[5];
  int waits = st.sc[6];
  float peak = st.scf[0];
  int emitted = 0;
  int n_act = block_sum(__popc(valid), s_red);

  auto noise_update = [&]() {
    // burst_detect.c:438-454; the order (sum - evicted) + mag is kept
    const bool gate = prim >= H;
    float* row = st.hist + (size_t)hidx * F + b0;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const float ev = row[i];
      bsum[i] = (bsum[i] - (gate ? ev : 0.0f)) + mag[i];
      row[i] = mag[i];
    }
    prim = min(prim + 1, H);
    hidx = hidx + 1 == H ? 0 : hidx + 1;
  };
  auto emit = [&](int pos, int g, int stop, int last) {
    if (pos >= p.G) return;
    st.g_id[pos] = st.a_id[g];
    st.g_start[pos] = st.a_start[g];
    st.g_stop[pos] = stop;
    st.g_last[pos] = last;
    st.g_bin[pos] = g;
    st.g_mag[pos] = st.a_mag[g];
    st.g_noise[pos] = st.a_noise[g];
  };

  for (int f = 0; f < p.n_frames; ++f) {
    const int idx = f * F;
#pragma unroll
    for (int i = 0; i < BPT; ++i) mag[i] = nxt[i];
    if (f + 1 < p.n_frames) {
      const float* row = st.mag2 + (size_t)(f + 1) * F + b0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) nxt[i] = row[i];
    }
    const bool act = idx + F <= p.n_valid;
    const bool primed = prim >= H && act;
#pragma unroll
    for (int i = 0; i < BPT; ++i)
      rel[i] = bsum[i] > 0.0f ? mag[i] / bsum[i] : 0.0f;

    // update_bursts: extend a_last on the +-1-bin threshold dilation
    // (burst_detect.c:458-469), then find the gone bursts (:490-518)
    const bool track = primed && n_act > 0;
    unsigned gone = 0, longb = 0;
    if (track) {
      s_lo[tid] = rel[0];
      s_hi[tid] = rel[BPT - 1];
      __syncthreads();
      const float left = tid > 0 ? s_hi[tid - 1] : 0.0f;
      const float right = tid < T - 1 ? s_lo[tid + 1] : 0.0f;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if (!((valid >> i) & 1u)) continue;
        const float rm = i > 0 ? rel[i - 1] : left;
        const float rp = i < BPT - 1 ? rel[i + 1] : right;
        int last = s_last[SI(i)];
        if (fmaxf(rel[i], fmaxf(rp, rm)) > p.threshold) {
          last = idx;
          s_last[SI(i)] = idx;
        }
        const bool lb = (last - st.a_start[b0 + i]) > p.max_burst_len;
        if (lb) longb |= 1u << i;
        if (last + p.post_len <= idx || lb) gone |= 1u << i;
      }
    }

    // candidate pool from the carried (frame-start) mask; rel becomes
    // the candidate array (burst_detect.c:679-699)
    bool any_cand = false;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const float rm =
          (s_mask[SI(i)] == 0 && ((elig >> i) & 1u)) ? rel[i] : 0.0f;
      rel[i] = rm > p.threshold ? rm : 0.0f;
      any_cand |= rel[i] > 0.0f;
    }

    if (track) {
      int n_del;
      const int off = block_excl_scan(__popc(gone), s_red, &n_del);
      if (n_del > 0) {
        const bool any_long = __syncthreads_or(longb != 0u) != 0;
        n_tagged += n_del;
        dropped += max(n_del - kEDel, 0);
        int e = off;
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          if (!((gone >> i) & 1u)) continue;
          if (e < kEDel) emit(emitted + e, b0 + i, idx, s_last[SI(i)]);
          ++e;
        }
        emitted += min(n_del, kEDel);
        // release the +-half_bw mask of every gone bin, emitted or not
#pragma unroll
        for (int i = 0; i < BPT; ++i) s_flag[b0 + i] = (gone >> i) & 1u;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          const int g = b0 + i;
          const int lo = max(g - hb, 0), hi = min(g + hb, F - 1);
          int c = 0;
          for (int j = lo; j <= hi; ++j) c += s_flag[j];
          s_mask[SI(i)] -= c;
        }
        __syncthreads();
        valid &= ~gone;
        n_act -= n_del;
        // forced noise update on long-burst deletion (burst_detect.c:516)
        if (any_long) noise_update();
      }
    }

    // create_new_bursts: greedy argmax-and-mask (burst_detect.c:556-632)
    unsigned crt = 0;
    int n_acc = 0;
    bool live = __syncthreads_or(any_cand) != 0 && primed;
    for (int j = 0; j < p.k_create && live; ++j) {
      unsigned long long key = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const unsigned long long k =
            ((unsigned long long)__float_as_uint(rel[i]) << 32) |
            (kFull - (unsigned)(b0 + i));
        key = k > key ? k : key;
      }
      key = block_max64(key, s_red64);
      const float m = __uint_as_float((unsigned)(key >> 32));
      if (!(m > p.threshold)) {
        live = false;
        break;
      }
      const int b = (int)(kFull - (unsigned)(key & kFull));
      const float mag_db =
          10.0f * log10f(fmaxf(m * p.hist_f * p.enbw, 1e-30f));
      if (b / BPT == tid) {
        const int li = b - b0;
        float base_at = 0.0f;
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (i == li) base_at = bsum[i];
        const float noise_db = 10.0f * log10f(fmaxf(
            base_at / p.hist_f / p.f2 / p.enbw / p.bin_width, 1e-30f));
        st.a_id[b] = burst_id;
        st.a_start[b] = idx - p.pre_len;
        st.a_mag[b] = mag_db;
        st.a_noise[b] = noise_db;
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (i == li) s_last[SI(i)] = idx - p.pre_len;
        valid |= 1u << li;
        crt |= 1u << li;
      }
      burst_id += 10;
      ++n_acc;
      ++n_act;
      peak = fmaxf(peak, mag_db);
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if (abs(b0 + i - b) <= hb) {
          s_mask[SI(i)] += 1;
          rel[i] = 0.0f;
        }
      }
    }
    if (n_acc == p.k_create) {
      bool more = false;
#pragma unroll
      for (int i = 0; i < BPT; ++i) more |= rel[i] > p.threshold;
      if (__syncthreads_or(more)) ++waits;
    }

    // squelch (burst_detect.c:594-631)
    const bool squelch = p.max_bursts > 0 && primed && n_act > p.max_bursts;
    if (squelch) {
      const unsigned sq = valid & ~crt;
      int n_sq;
      const int off = block_excl_scan(__popc(sq), s_red, &n_sq);
      n_tagged += n_sq;
      dropped += max(n_sq - kESq, 0);
      int e = off;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if (!((sq >> i) & 1u)) continue;
        if (e < kESq) emit(emitted + e, b0 + i, idx, s_last[SI(i)]);
        ++e;
      }
      emitted += min(n_sq, kESq);
      valid = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) s_mask[SI(i)] = 0;
      n_act = 0;
      sq_count += 3;
    } else if (act) {
      sq_count = max(sq_count - 1, 0);
    }
    // noise-estimate reset after repeated squelch
    if (act && sq_count >= 10) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) bsum[i] = 0.0f;
      prim = 0;
      sq_count = 0;
    }
    // final noise update if no burst is active (burst_detect.c:698)
    if (act && n_act == 0) noise_update();
  }

#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int g = b0 + i;
    st.bsum[g] = bsum[i];
    st.a_valid[g] = (valid >> i) & 1u;
    st.a_last[g] = s_last[SI(i)];
    st.mask_count[g] = s_mask[SI(i)];
  }
  if (tid == 0) {
    st.sc[0] = hidx;
    st.sc[1] = prim;
    st.sc[2] = burst_id;
    st.sc[3] = sq_count;
    st.sc[4] = n_tagged;
    st.sc[5] = dropped;
    st.sc[6] = waits;
    st.sc[7] = min(emitted, p.G);
    st.scf[0] = peak;
  }
#undef SI
}

template <int BPT>
cudaError_t launch(const State& st, const Params& p, int T,
                   cudaStream_t stream) {
  const size_t smem = 32 * sizeof(unsigned long long) + 32 * sizeof(int) +
                      2 * (size_t)p.F * sizeof(int) +
                      2 * (size_t)T * sizeof(float) + (size_t)p.F;
  cudaError_t err = cudaFuncSetAttribute(
      detect_scan_kernel<BPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  detect_scan_kernel<BPT><<<1, T, smem, stream>>>(st, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int detect_scan(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf, int F,
    int n_frames, int H, int G, int n_valid, int half_bw, int k_create,
    int max_bursts, int max_burst_len, int post_len, int pre_len,
    float threshold, float hist_f, float enbw, float f2, float bin_width,
    cudaStream_t stream) {
  const State st{mag2,  hist,   bsum,    a_valid, a_id,   a_start, a_last,
                 a_mag, a_noise, mask_count, g_id, g_start, g_stop, g_last,
                 g_bin, g_mag,  g_noise, sc,      scf};
  const Params p{F,          n_frames, H,        G,        n_valid,
                 half_bw,    k_create, max_bursts, max_burst_len, post_len,
                 pre_len,    threshold, hist_f,  enbw,     f2,
                 bin_width};
  const int T = F < 1024 ? F : 1024;
  if (T % 32 != 0 || F % T != 0) return (int)cudaErrorInvalidValue;
  switch (F / T) {
    case 1: return (int)launch<1>(st, p, T, stream);
    case 2: return (int)launch<2>(st, p, T, stream);
    case 4: return (int)launch<4>(st, p, T, stream);
    case 8: return (int)launch<8>(st, p, T, stream);
    case 16: return (int)launch<16>(st, p, T, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* detect_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
