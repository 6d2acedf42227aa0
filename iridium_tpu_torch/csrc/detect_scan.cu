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
// Design, up to F = 16384: ONE thread block walks the frames in order.
// Each of its T = min(1024, F) threads owns BPT = F / T contiguous bins
// (fewer, fatter threads were slower: a frame's instructions are spread
// over fewer warps and hide less latency). The kernel is bound by one
// SM's instruction issue, so what a frame waits on is kept off the chain
// and the common path is kept short:
//   - the |X|^2 rows stream through a ring of kStages frames in shared
//     memory, one 1-D TMA bulk copy a row (`cp.async.bulk`, completing on
//     the stage's mbarrier), issued by thread 0 in the middle of the
//     frame two before it;
//   - the noise history stays a ring in device memory (16 MB at H = 512,
//     in L2), and no thread loads or stores it: a noise update writes the
//     frame's |X|^2 row from its ring stage to the history row with ONE
//     bulk copy (shared -> global), and the row that the next update
//     evicts is bulk-copied into shared memory at the first barrier after
//     the update before;
//   - a_last and a_start live in shared memory (each thread touches only
//     its own words), baseline_sum in registers, a_valid and "mask is
//     zero" as bitmasks; mask_count, a_id, a_mag and a_noise are touched in
//     device memory only when a burst is created, released or emitted;
//   - the relative magnitude |X|^2 / baseline_sum is divided out only
//     where it can exceed the threshold: mag <= threshold * sum, with the
//     product rounded down, proves mag / sum <= threshold, so the common
//     bin costs one multiply and a compare, without a branch (the
//     division stays IEEE, --fmad=false);
//   - each thread also carries the baseline_sum of the two bins beside its
//     range (updated with the same arithmetic, so bit-equal to the
//     owner's), so the +-1-bin dilation needs no exchange between threads;
//   - a frame makes ONE block-wide reduction: the creation argmax key
//     (max value, lowest bin on ties, as one 64-bit key), the count and
//     ascending-bin prefix of the gone bins (emission ranks) and the
//     long-burst flag, in one barrier on alternating buffers. A deletion,
//     each further creation round and a squelch add one barrier each; a
//     mask release walks the list of gone bins, not a window per bin.
// Up to BPT = 8 the rings fit in the 227 KB of shared memory; at BPT = 16
// (F = 16384) each thread reads its |X|^2 words from device memory and
// reads and writes its history words as 16-byte vectors, with the evicted
// words (its own and the two halo words) loaded into registers one update
// ahead; a barrier separates any two updates, so no thread writes a row
// that another has still to read.
//
// Above 16384 bins (F = 32768 and 65536) one SM cannot hold the state, so
// a thread-block cluster of C = F / 16384 blocks walks the frames
// together, each block owning 16384 contiguous bins as the F = 16384 path
// does (1024 threads, 16 bins a thread, words from device memory). The
// blocks meet where bins of one touch another's:
//   - the frame's reduction: each block's warp partials go to shared
//     memory, a cluster barrier (arrive.release / wait.acquire) publishes
//     them, and every warp reads all C blocks' partials through
//     distributed shared memory (`mapa`): the key is the max, the count's
//     prefix adds the counts of the lower ranks (emission order is
//     ascending bin, which is rank order), the flag is the OR. Every
//     branch around a barrier depends only on such cluster-wide values;
//   - the mask release: a block lists its own gone bins; a thread whose
//     +-half_bw window reaches past its block's edge also walks the end of
//     the neighbour's list, read through distributed shared memory after a
//     cluster barrier;
//   - the halo words: the edge threads read the neighbour's |X|^2 and
//     evicted history words from device memory (past L1), and the barrier
//     after the forced noise update is a cluster barrier, so no block
//     writes a history row its neighbour has still to read;
//   - the scalars evolve identically in every block; rank 0 writes them,
//     and a last cluster barrier keeps every block's shared memory alive
//     until the others have read it.
// The DC notch (F / 2) lies on the edge between ranks C / 2 - 1 and C / 2.
//
// Semantics follow the Pallas kernel exactly: frames past n_valid leave
// the state alone; candidates come from the carried mask and the
// frame-start relative magnitude; deletions emit in ascending bin order,
// at most kEDel per frame, and release the mask of every gone bin; a
// long-burst deletion forces a noise update before creation (here it runs
// just after the creation walk, which reads only the created bin's
// updated sum and computes it the same way); squelch emits at most kESq
// per frame. The history is kept as a ring (oldest row at hist_idx); the
// Pallas kernel returns it linear with hist_idx 0, which is the same
// history.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kEDel = 8;
constexpr int kESq = 16;
constexpr int kStages = 3;
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

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_max64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(kFull, v, o);
    v = t > v ? t : v;
  }
  return v;
}

// This block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of every block of the cluster: what any of them wrote
// before it (shared or device memory) is seen by any of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The barrier between the phases: the block's, or the cluster's
template <int C>
__device__ __forceinline__ void phase_sync() {
  if constexpr (C == 1)
    __syncthreads();
  else
    cluster_sync();
}

// *p in the shared memory of cluster block `rank` (a generic address)
template <typename T>
__device__ __forceinline__ const T* peer(const T* p, int rank) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(a)
               : "l"(p), "r"(rank));
  return reinterpret_cast<const T*>(a);
}

// One reduction over the block (C = 1) or the cluster, in one barrier:
// the max of `key`, the exclusive prefix sum of `cnt` in bin order with
// its total, and the OR of `flag`; with the counts of the blocks of lower
// rank (`lo`) and of this block (`own`). Callers alternate between two
// buffers, so a buffer is written again only after another call's
// barrier. On the common frame all three are zero everywhere, and a vote
// on each side of the barrier skips the rest (the votes skip shuffles
// only, never a barrier).
struct Red {
  struct Warp {
    unsigned long long key;
    int cnt, flag;
  } w[32];
};
struct Reduced {
  unsigned long long key;
  int excl, total, lo, own;
  bool any;
};

template <int C>
__device__ Reduced block_reduce(unsigned long long key, int cnt, bool flag,
                                Red* r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = 0;
  unsigned long long wk = 0ull;
  bool wf = false;
  if (__any_sync(kFull, cnt != 0 || key != 0ull || flag)) {
    incl = warp_incl_scan(cnt);
    wk = warp_max64(key);
    wf = __any_sync(kFull, flag);
  }
  if (lane == 31) r->w[warp].cnt = incl;
  if (lane == 0) {
    r->w[warp].key = wk;
    r->w[warp].flag = wf;
  }
  phase_sync<C>();
  Reduced o{0ull, 0, 0, 0, 0, false};
  if constexpr (C == 1) {
    const Red::Warp e = lane < nw ? r->w[lane] : Red::Warp{0ull, 0, 0};
    if (__any_sync(kFull, e.cnt != 0 || e.key != 0ull || e.flag)) {
      o.key = warp_max64(e.key);
      o.any = __any_sync(kFull, e.flag);
      const int wi = warp_incl_scan(e.cnt);
      o.excl = __shfl_sync(kFull, wi - e.cnt, warp) + incl - cnt;
      o.total = __shfl_sync(kFull, wi, 31);
      o.own = o.total;
    }
  } else {
    // lane l reads warp l's partial of every block of the cluster
    const int me = cluster_rank();
    unsigned long long k = 0ull;
    int lo = 0, own = 0, all = 0;
    bool fl = false;
    if (lane < nw) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const Red::Warp e = peer(r, q)->w[lane];
        k = e.key > k ? e.key : k;
        fl |= e.flag != 0;
        all += e.cnt;
        if (q < me) lo += e.cnt;
        if (q == me) own = e.cnt;
      }
    }
    if (__any_sync(kFull, all != 0 || k != 0ull || fl)) {
      o.key = warp_max64(k);
      o.any = __any_sync(kFull, fl);
      const int wi = warp_incl_scan(own);
      o.lo = warp_sum(lo);
      o.own = __shfl_sync(kFull, wi, 31);
      o.total = warp_sum(all);
      o.excl = o.lo + __shfl_sync(kFull, wi - own, warp) + incl - cnt;
    }
  }
  return o;
}

// The relative magnitude rel = sum > 0 ? mag / sum : 0, and whether it
// exceeds thr. For thr >= 0, mag <= RD(thr * sum) proves rel <= thr: if
// sum > 0, mag / sum <= thr and so RN(mag / sum) <= thr; otherwise rel is
// 0. So most bins need no division (a negative thr, which no
// configuration gives, takes the exact test everywhere).
__device__ __forceinline__ float rel_of(float mag, float sum) {
  return sum > 0.0f ? mag / sum : 0.0f;
}
__device__ __forceinline__ bool maybe_above(float mag, float sum,
                                            float thr) {
  return mag > __fmul_rd(thr, sum);
}
__device__ __forceinline__ bool above(float mag, float sum, float thr) {
  return (thr < 0.0f || maybe_above(mag, sum, thr)) &&
         rel_of(mag, sum) > thr;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// BPT contiguous floats between p and v, as 16-byte vectors where BPT
// allows (p is then 16-byte aligned: b0 is a multiple of BPT)
template <int BPT>
__device__ __forceinline__ void load_bins(float (&v)[BPT], const float* p) {
  if constexpr (BPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BPT; ++i) v[i] = p[i];
  }
}

template <int BPT>
__device__ __forceinline__ void store_bins(float* p, const float (&v)[BPT]) {
  if constexpr (BPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < BPT; ++i) p[i] = v[i];
  }
}

// C blocks of a cluster (C = 1: one block) walk the frames together;
// block `rank` owns bins [rank * FB, (rank + 1) * FB), FB = F / C. Bins
// (b0, a key's bin, mask windows, the DC notch) are global; shared-memory
// indices (SI) are the block's own.
template <int BPT, int C>
__global__ void __launch_bounds__(1024)
    detect_scan_kernel(State st, Params p) {
  static_assert(C == 1 || BPT == 16, "a cluster runs the 16-bin path");
  constexpr bool kRing = BPT <= 8;  // the rings fit in shared memory
  constexpr unsigned kAll = (1u << BPT) - 1u;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int F = p.F, H = p.H, hb = p.half_bw, dc = F / 2;
  const int FB = F / C;
  const int rank = C == 1 ? 0 : cluster_rank();
  const float thr = p.threshold;
  float* s_ring = reinterpret_cast<float*>(smem_raw);  // kStages x F
  float* s_ev = s_ring + (kRing ? kStages * F : 0);    // F if kRing
  int* s_last = reinterpret_cast<int*>(s_ev + (kRing ? F : 0));
  int* s_start = s_last + FB;  // s_last, s_start: [i * T + tid]
  // the block's gone bins of the frame, ascending (global bins: F <= 65536
  // fits; store local bins and the rank if larger clusters are allowed)
  unsigned short* s_gone = reinterpret_cast<unsigned short*>(s_start + FB);
  Red* s_red = reinterpret_cast<Red*>(s_gone + FB);  // 2
  // kStages row barriers, then the evicted-row barrier
  unsigned long long* s_bar =
      reinterpret_cast<unsigned long long*>(s_red + 2);
  int* s_ngone = reinterpret_cast<int*>(s_bar + kStages + 1);  // s_gone's
  const int lo_bin = rank * FB;
  const int b0 = lo_bin + tid * BPT;
  const bool has_l = b0 > 0, has_r = b0 + BPT < F;
#define SI(i) ((i) * T + tid)

  // one F-float row from device memory into shared memory (thread 0)
  auto load = [&](float* dst, const float* src, unsigned long long* bar) {
    const unsigned n = (unsigned)F * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem(bar)), "r"(n)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
        "l"(src), "r"(n), "r"(smem(bar))
        : "memory");
  };
  auto load_row = [&](int frame) {
    const int s = frame % kStages;
    load(s_ring + (size_t)s * F, st.mag2 + (size_t)frame * F, s_bar + s);
  };

  float bsum[BPT], ev[BPT];
  unsigned valid = 0, elig = 0, unmasked = 0;
  load_bins(bsum, st.bsum + b0);
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int g = b0 + i;
    if (st.a_valid[g]) valid |= 1u << i;
    s_last[SI(i)] = st.a_last[g];
    s_start[SI(i)] = st.a_start[g];
    if (st.mask_count[g] == 0) unmasked |= 1u << i;
    if (g >= hb && g < F - hb && !(g >= dc - 3 && g <= dc + 3))
      elig |= 1u << i;
  }
  float bsum_l = has_l ? st.bsum[b0 - 1] : 0.0f;
  float bsum_r = has_r ? st.bsum[b0 + BPT] : 0.0f;
  float ev_l = 0.0f, ev_r = 0.0f;
  int hidx = st.sc[0], prim = st.sc[1], burst_id = st.sc[2];
  int sq_count = st.sc[3], n_tagged = st.sc[4], dropped = st.sc[5];
  int waits = st.sc[6];
  float peak = st.scf[0];
  int emitted = 0, nred = 0;
  int n_upd = 0, ev_loaded = 0;  // noise updates done, evicted rows loaded

  // the history row that the next noise update evicts: bulk-copied into
  // s_ev once every thread is past the update before (thread 0; the
  // history row was last written H updates ago, so all but the newest
  // bulk store group are complete)
  auto load_evicted = [&]() {
    if constexpr (kRing) {
      if (ev_loaded == n_upd) {
        if (tid == 0) {
          asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
          load(s_ev, st.hist + (size_t)hidx * F, s_bar + kStages);
        }
        ++ev_loaded;
      }
    } else {
      const float* row = st.hist + (size_t)hidx * F;
      load_bins(ev, row + b0);
      // in a cluster a halo word may be another block's: read it past L1
      if (has_l) ev_l = C > 1 ? __ldcg(row + b0 - 1) : row[b0 - 1];
      if (has_r) ev_r = C > 1 ? __ldcg(row + b0 + BPT) : row[b0 + BPT];
    }
  };
  if constexpr (kRing) {
    if (tid == 0) {
      for (int s = 0; s <= kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem(s_bar + s))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int f = 0; f < kStages && f < p.n_frames; ++f) load_row(f);
    }
  }
  load_evicted();
  int n_act =
      block_reduce<C>(0ull, __popc(valid), false, s_red + (nred++ & 1)).total;
  // phase: begin

  auto noise_update = [&](const float* row) {
    // burst_detect.c:438-454; the order (sum - evicted) + mag is kept
    const bool gate = prim >= H;
    float m[BPT];
    load_bins(m, row + b0);
    if constexpr (kRing) {
      mbar_wait(smem(s_bar + kStages), n_upd & 1);
      load_bins(ev, s_ev + b0);
      if (has_l) ev_l = s_ev[b0 - 1];
      if (has_r) ev_r = s_ev[b0 + BPT];
      if (tid == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            "cp.async.bulk.commit_group;\n" ::"l"(st.hist + (size_t)hidx * F),
            "r"(smem(row)), "r"((unsigned)F * (unsigned)sizeof(float))
            : "memory");
      }
    }
    // x - 0.0f is x in IEEE arithmetic, so an ungated update is a plain
    // add (gate is the same in every thread: no divergence)
    if (gate) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) bsum[i] = (bsum[i] - ev[i]) + m[i];
    } else {
#pragma unroll
      for (int i = 0; i < BPT; ++i) bsum[i] = bsum[i] + m[i];
    }
    if constexpr (!kRing) store_bins(st.hist + (size_t)hidx * F + b0, m);
    if (has_l) bsum_l = (bsum_l - (gate ? ev_l : 0.0f)) + row[b0 - 1];
    if (has_r) bsum_r = (bsum_r - (gate ? ev_r : 0.0f)) + row[b0 + BPT];
    prim = min(prim + 1, H);
    hidx = hidx + 1 == H ? 0 : hidx + 1;
    ++n_upd;
    if constexpr (!kRing) load_evicted();
  };
  auto emit = [&](int pos, int g, int stop, int last, int start) {
    if (pos >= p.G) return;
    st.g_id[pos] = st.a_id[g];
    st.g_start[pos] = start;
    st.g_stop[pos] = stop;
    st.g_last[pos] = last;
    st.g_bin[pos] = g;
    st.g_mag[pos] = st.a_mag[g];
    st.g_noise[pos] = st.a_noise[g];
  };

  for (int f = 0; f < p.n_frames; ++f) {
    // phase: load
    const int idx = f * F;
    const float* row = st.mag2 + (size_t)f * F;
    if constexpr (kRing) {
      mbar_wait(smem(s_bar + f % kStages), (f / kStages) & 1);
      row = s_ring + (size_t)(f % kStages) * F;
    }
    const bool act = idx + F <= p.n_valid;
    const bool primed = prim >= H && act;
    // above threshold: a branch-free filter over all bins, then the
    // exact test only for the few bins that pass it
    unsigned ab = 0;
    {
      float m[BPT];
      load_bins(m, row + b0);
      unsigned maybe = thr < 0.0f ? kAll : 0u;
#pragma unroll
      for (int i = 0; i < BPT; ++i)
        maybe |= (unsigned)maybe_above(m[i], bsum[i], thr) << i;
      if (maybe) {
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (((maybe >> i) & 1u) && rel_of(m[i], bsum[i]) > thr)
            ab |= 1u << i;
      }
    }
    // the candidate pool from the carried (frame-start) mask, valued at
    // the frame-start relative magnitude (burst_detect.c:679-699)
    unsigned cand = ab & unmasked & elig;
    auto best_key = [&]() {
      unsigned long long key = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if ((cand >> i) & 1u) {
          const unsigned long long k =
              ((unsigned long long)__float_as_uint(
                   rel_of(row[b0 + i], bsum[i]))
               << 32) |
              (kFull - (unsigned)(b0 + i));
          key = k > key ? k : key;
        }
      }
      return key;
    };
    const unsigned long long key0 = primed && cand ? best_key() : 0ull;

    // phase: track
    // update_bursts: extend a_last on the +-1-bin threshold dilation
    // (burst_detect.c:458-469), then find the gone bursts (:490-518)
    const bool track = primed && n_act > 0;
    unsigned gone = 0;
    bool longb = false;
    if (track && valid) {
      const bool al = has_l && above(row[b0 - 1], bsum_l, thr);
      const bool ar = has_r && above(row[b0 + BPT], bsum_r, thr);
      const unsigned dil = ab | (ab << 1) | (ab >> 1) | (al ? 1u : 0u) |
                           (ar ? 1u << (BPT - 1) : 0u);
      for (unsigned v = valid; v; v &= v - 1) {
        const int i = __ffs(v) - 1;
        int last = s_last[SI(i)];
        if ((dil >> i) & 1u) {
          last = idx;
          s_last[SI(i)] = idx;
        }
        const bool lb = (last - s_start[SI(i)]) > p.max_burst_len;
        longb |= lb;
        if (last + p.post_len <= idx || lb) gone |= 1u << i;
      }
    }

    // phase: reduce
    const Reduced r =
        block_reduce<C>(key0, __popc(gone), longb, s_red + (nred++ & 1));
    // every thread is past the last noise update: load the next evicted
    // row
    if constexpr (kRing) load_evicted();

    // phase: delete
    const int n_del = r.total;
    const bool forced = n_del > 0 && r.any;
    if (n_del > 0) {
      n_tagged += n_del;
      dropped += max(n_del - kEDel, 0);
      int e = r.excl;
      for (unsigned v = gone; v; v &= v - 1, ++e) {
        const int i = __ffs(v) - 1;
        if (e < kEDel)
          emit(emitted + e, b0 + i, idx, s_last[SI(i)], s_start[SI(i)]);
        s_gone[e - r.lo] = (unsigned short)(b0 + i);
      }
      emitted += min(n_del, kEDel);
      if (C > 1 && tid == 0) *s_ngone = r.own;
      phase_sync<C>();
      // release the +-half_bw mask of every gone bin, emitted or not
      int dec[BPT] = {};
      auto release = [&](int gb) {
        if (gb + hb < b0 || gb - hb >= b0 + BPT) return false;
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (abs(b0 + i - gb) <= hb) ++dec[i];
        return true;
      };
      for (int k = 0; k < r.own; ++k) release(s_gone[k]);
      if constexpr (C > 1) {
        // gone bins of the neighbours whose windows reach this thread's
        // bins: the top of the lower block's list, the bottom of the upper
        if (rank > 0 && b0 - hb < lo_bin) {
          const unsigned short* g = peer(s_gone, rank - 1);
          for (int k = *peer(s_ngone, rank - 1) - 1; k >= 0; --k)
            if (!release(g[k])) break;
        }
        if (rank < C - 1 && b0 + BPT + hb > lo_bin + FB) {
          const unsigned short* g = peer(s_gone, rank + 1);
          const int n = *peer(s_ngone, rank + 1);
          for (int k = 0; k < n; ++k)
            if (!release(g[k])) break;
        }
      }
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if (dec[i] == 0) continue;
        const int m = st.mask_count[b0 + i] - dec[i];
        st.mask_count[b0 + i] = m;
        if (m == 0) unmasked |= 1u << i;
      }
      valid &= ~gone;
      n_act -= n_del;
    }

    // phase: create
    // create_new_bursts: greedy argmax-and-mask (burst_detect.c:556-632)
    unsigned crt = 0;
    int n_acc = 0;
    unsigned long long key = r.key;
    for (int j = 0; j < p.k_create; ++j) {
      if (j > 0)
        key = block_reduce<C>(best_key(), 0, false, s_red + (nred++ & 1))
                  .key;
      const float m = __uint_as_float((unsigned)(key >> 32));
      if (!(m > thr)) break;
      const int b = (int)(kFull - (unsigned)(key & kFull));
      const float mag_db =
          10.0f * log10f(fmaxf(m * p.hist_f * p.enbw, 1e-30f));
      if ((unsigned)(b - b0) < (unsigned)BPT) {
        const int li = b - b0;
        float base_at = 0.0f, ev_at = 0.0f;
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (i == li) {
            base_at = bsum[i];
            ev_at = ev[i];
          }
        // the sum after the forced noise update, which runs below
        if (forced) {
          if constexpr (kRing) {
            mbar_wait(smem(s_bar + kStages), n_upd & 1);
            ev_at = s_ev[b];
          }
          base_at = (base_at - (prim >= H ? ev_at : 0.0f)) + row[b];
        }
        const float noise_db = 10.0f * log10f(fmaxf(
            base_at / p.hist_f / p.f2 / p.enbw / p.bin_width, 1e-30f));
        st.a_id[b] = burst_id;
        s_start[SI(li)] = idx - p.pre_len;
        st.a_mag[b] = mag_db;
        st.a_noise[b] = noise_db;
        s_last[SI(li)] = idx - p.pre_len;
        valid |= 1u << li;
        crt |= 1u << li;
      }
      burst_id += 10;
      ++n_acc;
      ++n_act;
      peak = fmaxf(peak, mag_db);
      if (b + hb >= b0 && b - hb < b0 + BPT) {
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          if (abs(b0 + i - b) <= hb) {
            st.mask_count[b0 + i] += 1;
            unmasked &= ~(1u << i);
            cand &= ~(1u << i);
          }
        }
      }
    }
    if (n_acc == p.k_create &&
        block_reduce<C>(0ull, 0, cand != 0u, s_red + (nred++ & 1)).any)
      ++waits;
    if constexpr (kRing) {
      // every thread is past frame f - 1, and its history store (if any)
      // has read the stage: refill the stage with frame f + kStages - 1
      const int nf = f - 1 + kStages;
      if (tid == 0 && f >= 1 && nf < p.n_frames) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load_row(nf);
      }
    }
    // the forced noise update on a long-burst deletion
    // (burst_detect.c:516). The barrier keeps the final update below from
    // writing the history row that this update evicts next before every
    // thread has read it (with BPT = 16 a thread reads its neighbours'
    // halo words of that row; in a cluster, maybe another block's).
    if (forced) {
      noise_update(row);
      phase_sync<C>();
      if constexpr (kRing) load_evicted();
    }

    // phase: squelch
    // squelch (burst_detect.c:594-631)
    const bool squelch = p.max_bursts > 0 && primed && n_act > p.max_bursts;
    if (squelch) {
      const unsigned sq = valid & ~crt;
      const Reduced q =
          block_reduce<C>(0ull, __popc(sq), false, s_red + (nred++ & 1));
      n_tagged += q.total;
      dropped += max(q.total - kESq, 0);
      int e = q.excl;
      for (unsigned v = sq; v; v &= v - 1, ++e) {
        const int i = __ffs(v) - 1;
        if (e < kESq)
          emit(emitted + e, b0 + i, idx, s_last[SI(i)], s_start[SI(i)]);
      }
      emitted += min(q.total, kESq);
      valid = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i)
        if (!((unmasked >> i) & 1u)) st.mask_count[b0 + i] = 0;
      unmasked = kAll;
      n_act = 0;
      sq_count += 3;
    } else if (act) {
      sq_count = max(sq_count - 1, 0);
    }
    // noise-estimate reset after repeated squelch
    if (act && sq_count >= 10) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) bsum[i] = 0.0f;
      bsum_l = 0.0f;
      bsum_r = 0.0f;
      prim = 0;
      sq_count = 0;
    }
    // phase: noise
    // final noise update if no burst is active (burst_detect.c:698)
    if (act && n_act == 0) noise_update(row);
  }
  // phase: end

  if constexpr (kRing) {
    if (tid == 0) {
      // the bulk copies still in flight: the history stores and the
      // evicted row loaded for an update that did not come
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      if (ev_loaded > n_upd) mbar_wait(smem(s_bar + kStages), n_upd & 1);
    }
  }
  store_bins(st.bsum + b0, bsum);
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int g = b0 + i;
    st.a_valid[g] = (valid >> i) & 1u;
    st.a_last[g] = s_last[SI(i)];
    st.a_start[g] = s_start[SI(i)];
  }
  if (tid == 0 && rank == 0) {
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
  // no block leaves while another may still read its shared memory
  if constexpr (C > 1) cluster_sync();
#undef SI
}

template <int BPT, int C>
cudaError_t launch(const State& st, const Params& p, int T,
                   cudaStream_t stream) {
  constexpr bool kRing = BPT <= 8;
  const size_t F = p.F, FB = F / C;
  const size_t smem = (kRing ? (kStages + 1) * F * sizeof(float) : 0) +
                      2 * FB * sizeof(int) + FB * sizeof(unsigned short) +
                      2 * sizeof(Red) +
                      (kStages + 2) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      detect_scan_kernel<BPT, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (C == 1) {
    detect_scan_kernel<BPT, C><<<1, T, smem, stream>>>(st, p);
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, detect_scan_kernel<BPT, C>, st, p);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused launch leaves nothing behind
      return err;
    }
  }
  return cudaGetLastError();
}

}  // namespace

// `clusters` blocks of a cluster share the F bins (1 for F <= 16384; 2 or
// 4 of 16384 bins each above)
extern "C" int detect_scan(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf, int F,
    int n_frames, int H, int G, int n_valid, int half_bw, int k_create,
    int max_bursts, int max_burst_len, int post_len, int pre_len,
    float threshold, float hist_f, float enbw, float f2, float bin_width,
    int clusters, cudaStream_t stream) {
  const State st{mag2,  hist,   bsum,    a_valid, a_id,   a_start, a_last,
                 a_mag, a_noise, mask_count, g_id, g_start, g_stop, g_last,
                 g_bin, g_mag,  g_noise, sc,      scf};
  const Params p{F,          n_frames, H,        G,        n_valid,
                 half_bw,    k_create, max_bursts, max_burst_len, post_len,
                 pre_len,    threshold, hist_f,  enbw,     f2,
                 bin_width};
  if (clusters < 1 || F % clusters != 0) return (int)cudaErrorInvalidValue;
  const int FB = F / clusters;
  const int T = FB < 1024 ? FB : 1024;
  if (T % 32 != 0 || FB % T != 0) return (int)cudaErrorInvalidValue;
  if (clusters > 1) {
    if (FB / T != 16 || F > 65536) return (int)cudaErrorInvalidValue;
    switch (clusters) {
      case 2: return (int)launch<16, 2>(st, p, T, stream);
      case 4: return (int)launch<16, 4>(st, p, T, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (FB / T) {
    case 1: return (int)launch<1, 1>(st, p, T, stream);
    case 2: return (int)launch<2, 1>(st, p, T, stream);
    case 4: return (int)launch<4, 1>(st, p, T, stream);
    case 8: return (int)launch<8, 1>(st, p, T, stream);
    case 16: return (int)launch<16, 1>(st, p, T, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* detect_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
