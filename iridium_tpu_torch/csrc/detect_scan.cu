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
// Layout: the caller hands the kernel (C, FB, T, BPT, N, K)
// (dsp/detect_scan.py `layout`, the one place it is decided): N clusters
// (1, or a grid of several) of C blocks (1, or a cluster of 2, 4, 8 or
// 16), block r (counted across the grid) owning K tiles of FB bins, tile t
// the bins [t FB, min((t + 1) FB, F)), T threads a block of BPT contiguous
// bins of each tile. Every multiple of 128 bins has one; up to
// MAX_RESIDENT (1,835,008) K = 1 and FB is the block's bins:
//   - F <= 8192: one block, BPT = F / 1024 rounded up to a power of two;
//   - F <= 131072: a cluster of the least power of two of blocks of at
//     most 8192 bins, 8 a thread (16,384 bins: 2 blocks; 131,072: 16);
//   - F <= 262144: a cluster of 16 blocks of at most 16384 bins, 16 a
//     thread (the wide path);
//   - F <= 917504: a grid of 3-7 clusters of 16 blocks of at most 8192
//     bins (524,288, 400 MHz: 4 clusters of 16 x 8,192);
//   - up to MAX_RESIDENT: a grid of 4-7 clusters of 16 wide blocks
//     (1,048,576, 800 MHz: 4 clusters of 16 x 16,384);
//   - above: the tiled grid (`detect_scan_tiled`, below), 7 clusters of
//     16 blocks of K >= 2 tiles of at most 16,384 bins, 16 a thread
//     (2,097,152, 1.6 GHz: 2 tiles of 9,376).
// Sizes that no power-of-two BPT splits into whole warps (1152 = 576 x 2
// does; 4224 = 528 x 8 does not) are padded: T is rounded up to whole
// warps and the threads past the block's last bin are idle. Padding keeps
// one instantiation per BPT (instantiating BPT = 3, 6, 11, ... would
// multiply the build and the register budgets) and costs only idle lanes.
// An idle thread holds no bin: it is never valid, eligible, masked or
// gone, reads its |X|^2 words from the block's first bins and stores
// nothing; it takes part in every barrier and warp reduction. The DC notch
// (F / 2) is an eligibility rule on global bins; no code needs it on a
// block edge.
//
// Design of a block: it walks the frames in order, each of its threads
// owning BPT bins (as many threads as 1024 allow: fewer, fatter threads
// were slower, a frame's instructions are spread over fewer warps and hide
// less latency). The kernel is bound by the frame's chain of dependent
// steps on one SM, so what a frame waits on is kept off the chain and the
// common path is kept short:
//   - the block's |X|^2 words of each row stream through a ring of kStages
//     frames in shared memory, one 1-D TMA bulk copy a row
//     (`cp.async.bulk`, completing on the stage's mbarrier), issued by
//     thread 0 a frame or two ahead;
//   - the noise history stays a ring in device memory (16 MB at 8192 bins
//     and H = 512, in L2) that no thread loads or stores: a noise update
//     writes the frame's row from its ring stage to the history row with
//     ONE bulk copy (shared -> global), and the row that the next update
//     evicts is bulk-copied into shared memory by thread 0 once every
//     thread has read the row before;
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
//   - a frame makes ONE reduction: the creation argmax key (max value,
//     lowest bin on ties, as one 64-bit key), the count and ascending-bin
//     prefix of the gone bins (emission ranks) and the long-burst flag, on
//     alternating buffers. A deletion, each further creation round and a
//     squelch add one barrier each; a mask release walks the list of gone
//     bins, not a window per bin.
// Up to 8 bins a thread the ring has 3 stages of FB words. The wide path
// (16 bins a thread) fits 2 stages of 16384 words beside the evicted row
// and the gone list, and keeps a_last and a_start in device memory (read
// only where a burst is active); it loads the evicted row at the frame's
// start, once every thread has arrived on s_ev_free after reading the row
// before (prefetching the row after next into L2 did not pay). It spills
// under the 64 registers of 1024 threads (bsum[16], the halo sums and the
// scalars), and spills reach L2, since 227 KB of shared memory leave ~28
// KB of L1; so the layout gives it only what one cluster of 16 ring
// blocks cannot hold.
// (16384 bins, tools/exp_scan.py's synthetic block on an H100 SXM at
// 700 W: one block on the wide path 7.8 us a frame, a cluster of 2 ring
// blocks 3.9, the earlier design that read each thread's 16 words of
// |X|^2 and history from device memory 10.1.)
//
// A cluster (F > 8192) has more state than one SM holds, so C blocks walk
// the frames together and meet where bins of one touch another's:
//   - the frame's reduction: each block's warp partials go to shared
//     memory, a cluster barrier (arrive.release / wait.acquire) publishes
//     them, warp 0 of each block reads every block's partials through
//     distributed shared memory (`mapa`) and hands the result to its
//     block: the key is the max, the count's prefix adds the counts of the
//     lower ranks (emission order is ascending bin, which is rank order),
//     the flag is the OR. Every branch around a barrier depends only on
//     such cluster-wide values;
//   - the mask release: a block lists its own gone bins (local bins, so
//     that a 16-bit entry holds them at any F); a thread whose +-half_bw
//     window reaches past its block's edge also walks the end of the
//     neighbour's list, read through distributed shared memory after a
//     cluster barrier;
//   - the halo words: the edge threads read the neighbour's |X|^2 words
//     from device memory (|X|^2 is read-only); the halo word of the row a
//     noise update evicts is, for a row stored during the launch, the
//     |X|^2 word the edge thread itself added then (kept in its own ring,
//     `halo`, H words each side), and for an older row the history word,
//     read right after the update before, ahead of the barrier that
//     orders the neighbour's next store of that row (the bulk copies hold
//     only the block's own words); the barrier after the forced noise
//     update is a cluster barrier;
//   - the scalars evolve identically in every block; rank 0 writes them,
//     and a last cluster barrier keeps every block's shared memory alive
//     until the others have read it.
// C = 16 is above the portable cluster size and is launched with
// cudaFuncAttributeNonPortableClusterSizeAllowed.
//
// A grid of clusters (F > 262144: more bins than one cluster of 16 SMs
// holds) keeps all of the above inside each cluster, and meets between
// clusters in device memory (`Grid`, a scratch the wrapper zeroes before
// each launch):
//   - each cluster barrier of a single cluster becomes a grid barrier: the
//     cluster barrier, then thread 0 of the cluster's rank-0 block adds
//     one to an arrival counter (red.release.gpu) and warp 0 of every
//     block spins on it (ld.acquire.gpu) until every cluster has arrived
//     as many times as this block has; the counter only grows, so it
//     needs no reset between barriers. Every branch around one depends
//     only on grid-reduced values, as in a cluster;
//   - the frame's reduction: after the cluster's (DSMEM), the rank-0 block
//     publishes the cluster's key, count and flag in a slot of the
//     barrier's parity before it arrives; warp 0 of every block reads the
//     N slots (lane q: cluster q) and reduces them, the count's prefix
//     adding the counts of the lower clusters (ascending bin is cluster,
//     then block, order). A slot is written again two barriers later,
//     which no cluster reaches before every block has read it;
//   - the mask release: the blocks at a cluster's edges also write their
//     gone lists and counts to device memory, and a thread whose +-half_bw
//     window reaches into the next cluster reads them there after the
//     grid barrier (L2 loads, __ldcg);
//   - the halo words and the history rows already meet in device memory;
//     the barriers that order them become grid barriers;
//   - block 0 of the grid writes the scalars.
// The spin needs every cluster resident at once: a grid of more clusters
// than cudaOccupancyMaxActiveClusters places is refused
// (cudaErrorCooperativeLaunchTooLarge) before anything runs, and a grid
// is a cooperative launch (cudaLaunchAttributeCooperative beside the
// cluster dimension, which CUDA 12.8 on the H100 accepts), which refuses
// a grid of more blocks than the card holds. A wait longer than kSpinCycles traps: the launch fails,
// the card does not hang. A single cluster's instantiations carry none of this code
// (kGrid is a template parameter).
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
constexpr int kMaxBins = 16384;  // the most bins a block holds
constexpr size_t kMaxShared = 227 * 1024;  // a block's most on sm_90
constexpr int kESq = 16;
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;
// a grid barrier's longest wait, ~17 s at the H100's 1.98 GHz: far above
// any frame's, and a fault instead of a hang where a cluster never arrives
constexpr long long kSpinCycles = 1ll << 35;

struct Params {
  int F, n_frames, H, G, n_valid, half_bw, k_create, max_bursts,
      max_burst_len, post_len, pre_len;
  float threshold, hist_f, enbw, f2, bin_width;
  int block_bins;  // FB: the bins of a block (the last block: the rest)
  int n_clusters;  // N: clusters of the grid (1: one cluster or block)
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
  float* halo;  // [blocks][2][H] halo words of the history rows stored
                // during the launch (the edge threads' own)
  unsigned* grid;  // a grid's scratch (`Grid`): zeroed by the wrapper
};

// One cluster's share of a grid reduction
struct Slot {
  unsigned long long key;
  int cnt, flag;
};

// A grid launch's scratch in device memory (dsp/detect_scan.py
// `grid_words`): the arrival counter on a line of its own, two parities
// of one slot a cluster, then each block's gone count and gone list (FB
// local bins); the lists of the blocks at a cluster's edges are read by
// the next cluster.
struct Grid {
  unsigned* count;
  Slot* slots;  // [2][N]
  int* ngone;   // [N C]
  unsigned short* gone;  // [N C][FB]
  unsigned gen;  // grid barriers passed, as warp 0 (the waiters) counts
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
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

// The grid's barrier, after the cluster's: the rank-0 block's thread 0
// arrives for the cluster (its release carries what the cluster barrier
// ordered before it: `slot`, where given, and every thread's stores), and
// warp 0 of each block waits until every cluster has arrived gen + 1
// times; the caller's block barrier hands that on.
__device__ __forceinline__ void grid_arrive_wait(Grid& g, int n_clusters,
                                                 int rank, Slot* slot,
                                                 const Slot& mine) {
  const int tid = threadIdx.x;
  if (rank == 0 && tid == 0) {
    if (slot) *slot = mine;
    red_release(g.count, 1u);
  }
  ++g.gen;
  if (tid < 32) {
    const unsigned want = g.gen * (unsigned)n_clusters;
    const long long t0 = clock64();
    while (ld_acquire(g.count) < want) {
      // a cluster that never arrives fails the launch instead of hanging
      // the card
      if (clock64() - t0 > kSpinCycles) __trap();
    }
  }
}

// Every thread of every block of the launch: the cluster's barrier, and a
// grid's
template <int C, bool kGrid>
__device__ __forceinline__ void all_sync(Grid& g, int n_clusters,
                                         int rank) {
  phase_sync<C>();
  if constexpr (kGrid) {
    grid_arrive_wait(g, n_clusters, rank, nullptr, Slot{});
    __syncthreads();
  }
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

// One reduction over the block (C = 1) or the cluster: the max of `key`,
// the exclusive prefix sum of `cnt` in bin order with its total, and the
// OR of `flag`; with the counts of the blocks of lower rank (`lo`) and of
// this block (`own`). One block: one barrier. A cluster: a cluster barrier
// publishes every block's warp partials, warp 0 of each block reads all of
// them through distributed shared memory (lane l: warp l of each block)
// and leaves the cluster's result in its own shared memory, and a block
// barrier hands it to the other warps (a read by every warp of every
// block, C x 32 remote loads a lane, was most of a frame at C = 8).
// Callers alternate between two buffers, so a buffer is written again only
// after another call's barriers. On the common frame all three are zero
// everywhere, and votes skip the rest (the votes skip shuffles only, never
// a barrier).
struct Red {
  struct Warp {
    unsigned long long key;
    int cnt, flag;
  } w[32];
  unsigned long long cl_key;  // the cluster's result (warp 0's)
  int cl_lo, cl_total, cl_any, cl_pad;
};

// The counters that only the final state reports, kept by thread 0 alone
// (every thread would count the same, in registers the wide path lacks)
struct Tally {
  int n_tagged, dropped, waits;
  float peak;
};

struct Reduced {
  unsigned long long key;
  int excl, total, lo, own;
  bool any;
};

// In a grid (kGrid) the cluster's result then meets the other clusters'
// through device memory (`grid_arrive_wait`): the key is their max, the
// count's prefix adds the lower clusters' totals, the flag is the OR.
template <int C, bool kGrid>
__device__ Reduced block_reduce(unsigned long long key, int cnt, bool flag,
                                Red* r, Grid& g, int n_clusters,
                                int cluster) {
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
  if constexpr (C > 1) {
    if (warp == 0) {
      // lane l reads warp l's partial of every block of the cluster
      const int me = cluster_rank();
      unsigned long long k = 0ull;
      int lo = 0, all = 0;
      bool fl = false;
      if (lane < nw) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const Red::Warp e = peer(r, q)->w[lane];
          k = e.key > k ? e.key : k;
          fl |= e.flag != 0;
          all += e.cnt;
          if (q < me) lo += e.cnt;
        }
      }
      if (__any_sync(kFull, all != 0 || k != 0ull || fl)) {
        k = warp_max64(k);
        fl = __any_sync(kFull, fl);
        lo = warp_sum(lo);
        all = warp_sum(all);
      }
      if constexpr (kGrid) {
        // lane q reads cluster q's slot of this barrier's parity (L2
        // loads: the slot was written on another SM)
        Slot* slots = g.slots + (g.gen & 1u) * n_clusters;
        grid_arrive_wait(g, n_clusters, me, slots + cluster,
                         Slot{k, all, fl ? 1 : 0});
        unsigned long long gk = 0ull;
        int glo = 0, gall = 0;
        bool gfl = false;
        if (lane < n_clusters) {
          const Slot* e = slots + lane;
          gk = __ldcg(&e->key);
          const int c = __ldcg(&e->cnt);
          gfl = __ldcg(&e->flag) != 0;
          gall = c;
          if (lane < cluster) glo = c;
        }
        if (__any_sync(kFull, gall != 0 || gk != 0ull || gfl)) {
          gk = warp_max64(gk);
          gfl = __any_sync(kFull, gfl);
          glo = warp_sum(glo);
          gall = warp_sum(gall);
        }
        k = gk;
        fl = gfl;
        lo += glo;
        all = gall;
      }
      if (lane == 0) {
        r->cl_key = k;
        r->cl_lo = lo;
        r->cl_total = all;
        r->cl_any = fl;
      }
    }
    __syncthreads();
    o.key = r->cl_key;
    o.lo = r->cl_lo;
    o.total = r->cl_total;
    o.any = r->cl_any != 0;
  }
  // this block's warps, in order: the count's prefix and its total
  const Red::Warp e = lane < nw ? r->w[lane] : Red::Warp{0ull, 0, 0};
  if (__any_sync(kFull, e.cnt != 0 || e.key != 0ull || e.flag)) {
    const int wi = warp_incl_scan(e.cnt);
    o.own = __shfl_sync(kFull, wi, 31);
    o.excl = __shfl_sync(kFull, wi - e.cnt, warp) + incl - cnt;
    if constexpr (C == 1) {
      o.key = warp_max64(e.key);
      o.any = __any_sync(kFull, e.flag);
      o.total = o.own;
    }
  }
  o.excl += o.lo;
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
// block `rank` owns bins [lo_bin, hi_bin) (`layout`). Bins (b0, a key's
// bin, mask windows, the DC notch) are global; the shared-memory rows hold
// the block's own words (bin g at [g - lo_bin]).
template <int BPT, int C, bool kGrid>
__global__ void __launch_bounds__(1024)
    detect_scan_kernel(State st, Params p) {
  static_assert(C == 1 || BPT >= 8, "a cluster block holds 8 bins a thread "
                                     "or more");
  static_assert(!kGrid || C == 16, "a grid is of clusters of 16");
  // the wide path (16 bins a thread): two ring stages of kMaxBins words,
  // a_last / a_start in device memory
  constexpr bool kWide = BPT == 16;
  constexpr int kStages = kWide ? 2 : 3;
  constexpr unsigned kAll = (1u << BPT) - 1u;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int F = p.F, H = p.H, hb = p.half_bw, dc = F / 2;
  const int FB = p.block_bins;  // the bins of a block
  // a row's words and the bin slots in shared memory
  const int RW = kWide ? kMaxBins : FB, NB = kWide ? kMaxBins : T * BPT;
  const int rank = C == 1 ? 0 : cluster_rank();
  // the cluster in the grid, and the block across it
  const int cluster = kGrid ? (int)blockIdx.x / C : 0;
  const int gb = cluster * C + rank;
  const int NC = kGrid ? p.n_clusters : 1;
  Grid grid{};
  if constexpr (kGrid) {
    grid.count = st.grid;
    grid.slots = reinterpret_cast<Slot*>(st.grid + 32);
    grid.ngone = reinterpret_cast<int*>(grid.slots + 2 * NC);
    grid.gone = reinterpret_cast<unsigned short*>(grid.ngone + NC * C);
  }
  // a cluster's edge blocks in a grid: their gone lists meet the next
  // cluster's in device memory
  const bool x_lo = kGrid && rank == 0 && cluster > 0;
  const bool x_hi = kGrid && rank == C - 1 && cluster < NC - 1;
  const float thr = p.threshold;
  const int lo_bin = gb * FB, hi_bin = min(lo_bin + FB, F);
  const unsigned row_bytes = (unsigned)(hi_bin - lo_bin) * 4u;
  float* s_ring = reinterpret_cast<float*>(smem_raw);  // kStages x RW
  float* s_ev = s_ring + kStages * RW;                 // RW
  int* s_last = reinterpret_cast<int*>(s_ev + RW);     // NB, unless kWide
  int* s_start = s_last + (kWide ? 0 : NB);            // [i * T + tid]
  // the block's gone bins of the frame, ascending, as local bins
  unsigned short* s_gone =
      reinterpret_cast<unsigned short*>(s_start + (kWide ? 0 : NB));
  Red* s_red = reinterpret_cast<Red*>(s_gone + NB);  // 2
  // kStages row barriers, the evicted row's arrival, and (wide path)
  // its release: every thread has read its words of it
  unsigned long long* s_bar =
      reinterpret_cast<unsigned long long*>(s_red + 2);
  unsigned long long* s_ev_full = s_bar + kStages;
  unsigned long long* s_ev_free = s_bar + kStages + 1;
  int* s_ngone = reinterpret_cast<int*>(s_bar + kStages + 2);  // s_gone's
  Tally* s_tally = reinterpret_cast<Tally*>(s_bar + kStages + 3);
  // in a cluster, the edge threads' halo words of the row the next update
  // evicts (left, right), each kept by its thread
  float* s_ev_halo = reinterpret_cast<float*>(s_bar + kStages + 5);
  const int b0 = lo_bin + tid * BPT;
  // an idle thread (past the block's last bin) holds no bin and reads the
  // block's first words
  const bool live = b0 < hi_bin;
  const int l0 = live ? b0 - lo_bin : 0;  // the first bin's row index
  const bool has_l = live && b0 > 0, has_r = live && b0 + BPT < F;
  // the threads whose halo bin is another block's
  const bool edge_l = C > 1 && has_l && b0 == lo_bin;
  const bool edge_r = C > 1 && has_r && b0 + BPT == hi_bin;
  // a_last and a_start of the thread's bin i
  auto last_of = [&](int i) -> int& {
    if constexpr (kWide)
      return st.a_last[b0 + i];
    else
      return s_last[i * T + tid];
  };
  auto start_of = [&](int i) -> int& {
    if constexpr (kWide)
      return st.a_start[b0 + i];
    else
      return s_start[i * T + tid];
  };

  // n bytes from device memory into shared memory (thread 0)
  auto load = [&](float* dst, const float* src, unsigned n,
                  unsigned long long* bar) {
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
    load(s_ring + (size_t)s * RW, st.mag2 + (size_t)frame * F + lo_bin,
         row_bytes, s_bar + s);
  };

  float bsum[BPT];
  unsigned valid = 0, unmasked = live ? 0u : kAll;
  load_bins(bsum, st.bsum + lo_bin + l0);
  if (live) {
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int g = b0 + i;
      if (st.a_valid[g]) valid |= 1u << i;
      if constexpr (!kWide) {
        last_of(i) = st.a_last[g];
        start_of(i) = st.a_start[g];
      }
      if (st.mask_count[g] == 0) unmasked |= 1u << i;
    }
  }
  // the bins that may start a burst: away from the band edges and the DC
  // notch (computed where a bin is above threshold, not kept)
  auto eligible = [&]() {
    unsigned e = 0;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int g = b0 + i;
      if (live && g >= hb && g < F - hb && !(g >= dc - 3 && g <= dc + 3))
        e |= 1u << i;
    }
    return e;
  };
  float bsum_l = has_l ? st.bsum[b0 - 1] : 0.0f;
  float bsum_r = has_r ? st.bsum[b0 + BPT] : 0.0f;
  int hidx = st.sc[0], prim = st.sc[1], burst_id = st.sc[2];
  int sq_count = st.sc[3];
  int emitted = 0;
  int n_upd = 0;  // noise updates done
  // the evicted row of the next update is loaded; the reduction buffer
  bool ev_ahead = false, red_odd = false;
  auto red_buf = [&]() {
    red_odd = !red_odd;
    return s_red + (red_odd ? 1 : 0);
  };

  // the halo |X|^2 words of frame f (the edge threads': another block's,
  // from device memory)
  auto word_l = [&](const float* row, int f) {
    return edge_l ? __ldg(st.mag2 + (size_t)f * F + b0 - 1) : row[l0 - 1];
  };
  auto word_r = [&](const float* row, int f) {
    return edge_r ? __ldg(st.mag2 + (size_t)f * F + b0 + BPT)
                  : row[l0 + BPT];
  };
  // the history row that the next noise update evicts, bulk-copied into
  // s_ev by thread 0 once every thread has read the row before: up to 8
  // bins a thread at the first barrier after the update; at 16 at the next
  // frame's start, after the update's arrivals on s_ev_free. The row was
  // stored H >= 2 updates ago, so all but the newest bulk store group are
  // complete.
  auto load_evicted = [&]() {
    if (!ev_ahead) {
      if (tid == 0) {
        if constexpr (kWide)
          if (n_upd > 0) mbar_wait(smem(s_ev_free), (n_upd - 1) & 1);
        asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
        load(s_ev, st.hist + (size_t)hidx * F + lo_bin, row_bytes,
             s_ev_full);
      }
      ev_ahead = true;
    }
  };
  // in a cluster, the edge threads' halo words of that row, one update
  // ahead: a row stored during this launch is in the thread's own ring of
  // the halo words it added (st.halo; the neighbour stored the same
  // words), an older one is read from the history right after an update,
  // before the barrier that orders the neighbour's next store of the row
  auto load_halo = [&]() {
    if constexpr (C > 1) {
      const float* ring = st.halo + (size_t)gb * 2 * H;
      const float* row = st.hist + (size_t)hidx * F;
      if (edge_l)
        s_ev_halo[0] = n_upd >= H ? ring[hidx] : __ldcg(row + b0 - 1);
      if (edge_r)
        s_ev_halo[1] = n_upd >= H ? ring[H + hidx] : __ldcg(row + b0 + BPT);
    }
  };
  if (tid == 0) {
    *s_tally = Tally{st.sc[4], st.sc[5], st.sc[6], st.scf[0]};
    for (int s = 0; s <= kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem(s_bar + s))
                   : "memory");
    if constexpr (kWide)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem(s_ev_free)),
                   "r"(T)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int f = 0; f < kStages && f < p.n_frames; ++f) load_row(f);
  }
  load_evicted();
  load_halo();
  int n_act = block_reduce<C, kGrid>(0ull, __popc(valid), false, red_buf(),
                                     grid, NC, cluster)
                  .total;
  // phase: begin

  auto noise_update = [&](const float* row, int f) {
    // burst_detect.c:438-454; the order (sum - evicted) + mag is kept
    const bool gate = prim >= H;
    float m[BPT], ev[BPT];
    load_bins(m, row + l0);
    mbar_wait(smem(s_ev_full), n_upd & 1);
    load_bins(ev, s_ev + l0);
    float e_l = 0.0f, e_r = 0.0f;
    if (has_l) e_l = edge_l ? s_ev_halo[0] : s_ev[l0 - 1];
    if (has_r) e_r = edge_r ? s_ev_halo[1] : s_ev[l0 + BPT];
    if constexpr (kWide)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem(s_ev_free))
                   : "memory");
    if (tid == 0) {
      // the frame's row is the history row: one bulk store
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(st.hist + (size_t)hidx * F +
                                                 lo_bin),
          "r"(smem(row)), "r"(row_bytes)
          : "memory");
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
    float* ring = st.halo + (size_t)gb * 2 * H;
    if (has_l) {
      const float x = word_l(row, f);
      bsum_l = (bsum_l - (gate ? e_l : 0.0f)) + x;
      if (edge_l) ring[hidx] = x;
    }
    if (has_r) {
      const float x = word_r(row, f);
      bsum_r = (bsum_r - (gate ? e_r : 0.0f)) + x;
      if (edge_r) ring[H + hidx] = x;
    }
    prim = min(prim + 1, H);
    hidx = hidx + 1 == H ? 0 : hidx + 1;
    ++n_upd;
    ev_ahead = false;
    load_halo();
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
    mbar_wait(smem(s_bar + f % kStages), (f / kStages) & 1);
    const float* row = s_ring + (size_t)(f % kStages) * RW;
    if constexpr (kWide) load_evicted();
    const bool act = idx + F <= p.n_valid;
    const bool primed = prim >= H && act;
    // above threshold: a branch-free filter over all bins, then the
    // exact test only for the few bins that pass it
    unsigned ab = 0;
    {
      float m[BPT];
      load_bins(m, row + l0);
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
    unsigned cand = ab & unmasked;
    if (cand) cand &= eligible();
    auto best_key = [&]() {
      unsigned long long key = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if ((cand >> i) & 1u) {
          const unsigned long long k =
              ((unsigned long long)__float_as_uint(
                   rel_of(row[l0 + i], bsum[i]))
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
      const bool al = has_l && above(word_l(row, f), bsum_l, thr);
      const bool ar = has_r && above(word_r(row, f), bsum_r, thr);
      const unsigned dil = ab | (ab << 1) | (ab >> 1) | (al ? 1u : 0u) |
                           (ar ? 1u << (BPT - 1) : 0u);
      for (unsigned v = valid; v; v &= v - 1) {
        const int i = __ffs(v) - 1;
        int last = last_of(i);
        if ((dil >> i) & 1u) {
          last = idx;
          last_of(i) = idx;
        }
        const bool lb = (last - start_of(i)) > p.max_burst_len;
        longb |= lb;
        if (last + p.post_len <= idx || lb) gone |= 1u << i;
      }
    }

    // phase: reduce
    const Reduced r =
        block_reduce<C, kGrid>(key0, __popc(gone), longb, red_buf(), grid,
                               NC, cluster);
    if constexpr (kWide) {
      // every thread is past frame f - 1, and the history stores have
      // read its stage: refill it with frame f + 1
      if (tid == 0 && f >= 1 && f + 1 < p.n_frames) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load_row(f + 1);
      }
    } else {
      // every thread is past the last noise update: load the next evicted
      // row
      load_evicted();
    }

    // phase: delete
    const int n_del = r.total;
    const bool forced = n_del > 0 && r.any;
    if (n_del > 0) {
      if (tid == 0) {
        s_tally->n_tagged += n_del;
        s_tally->dropped += max(n_del - kEDel, 0);
      }
      int e = r.excl;
      for (unsigned v = gone; v; v &= v - 1, ++e) {
        const int i = __ffs(v) - 1;
        if (e < kEDel)
          emit(emitted + e, b0 + i, idx, last_of(i), start_of(i));
        s_gone[e - r.lo] = (unsigned short)(b0 + i - lo_bin);
        if (x_lo || x_hi)
          grid.gone[(size_t)gb * FB + e - r.lo] =
              (unsigned short)(b0 + i - lo_bin);
      }
      emitted += min(n_del, kEDel);
      if (C > 1 && tid == 0) *s_ngone = r.own;
      if ((x_lo || x_hi) && tid == 0) grid.ngone[gb] = r.own;
      all_sync<C, kGrid>(grid, NC, rank);
      // release the +-half_bw mask of every gone bin, emitted or not
      if (live) {
        int dec[BPT] = {};
        auto release = [&](int bin) {
          if (bin + hb < b0 || bin - hb >= b0 + BPT) return false;
#pragma unroll
          for (int i = 0; i < BPT; ++i)
            if (abs(b0 + i - bin) <= hb) ++dec[i];
          return true;
        };
        for (int k = 0; k < r.own; ++k) release(lo_bin + s_gone[k]);
        if constexpr (C > 1) {
          // gone bins of the neighbours whose windows reach this thread's
          // bins: the top of the lower block's list, the bottom of the
          // upper's
          if (rank > 0 && b0 - hb < lo_bin) {
            const unsigned short* g = peer(s_gone, rank - 1);
            const int base = lo_bin - FB;
            for (int k = *peer(s_ngone, rank - 1) - 1; k >= 0; --k)
              if (!release(base + g[k])) break;
          }
          if (rank < C - 1 && b0 + BPT + hb > hi_bin) {
            const unsigned short* g = peer(s_gone, rank + 1);
            const int n = *peer(s_ngone, rank + 1);
            for (int k = 0; k < n; ++k)
              if (!release(hi_bin + g[k])) break;
          }
          // across a cluster edge: the neighbour block's list in device
          // memory
          if (x_lo && b0 - hb < lo_bin) {
            const unsigned short* g = grid.gone + (size_t)(gb - 1) * FB;
            const int base = lo_bin - FB;
            for (int k = __ldcg(grid.ngone + gb - 1) - 1; k >= 0; --k)
              if (!release(base + __ldcg(g + k))) break;
          }
          if (x_hi && b0 + BPT + hb > hi_bin) {
            const unsigned short* g = grid.gone + (size_t)(gb + 1) * FB;
            const int n = __ldcg(grid.ngone + gb + 1);
            for (int k = 0; k < n; ++k)
              if (!release(hi_bin + __ldcg(g + k))) break;
          }
        }
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          if (dec[i] == 0) continue;
          const int m = st.mask_count[b0 + i] - dec[i];
          st.mask_count[b0 + i] = m;
          if (m == 0) unmasked |= 1u << i;
        }
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
        key = block_reduce<C, kGrid>(best_key(), 0, false, red_buf(), grid,
                                     NC, cluster)
                  .key;
      const float m = __uint_as_float((unsigned)(key >> 32));
      if (!(m > thr)) break;
      const int b = (int)(kFull - (unsigned)(key & kFull));
      const float mag_db =
          10.0f * log10f(fmaxf(m * p.hist_f * p.enbw, 1e-30f));
      if (live && (unsigned)(b - b0) < (unsigned)BPT) {
        const int li = b - b0;
        float base_at = 0.0f;
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          if (i == li) base_at = bsum[i];
        // the sum after the forced noise update, which runs below
        if (forced) {
          mbar_wait(smem(s_ev_full), n_upd & 1);
          base_at = (base_at - (prim >= H ? s_ev[l0 + li] : 0.0f)) +
                    row[l0 + li];
        }
        const float noise_db = 10.0f * log10f(fmaxf(
            base_at / p.hist_f / p.f2 / p.enbw / p.bin_width, 1e-30f));
        st.a_id[b] = burst_id;
        start_of(li) = idx - p.pre_len;
        st.a_mag[b] = mag_db;
        st.a_noise[b] = noise_db;
        last_of(li) = idx - p.pre_len;
        valid |= 1u << li;
        crt |= 1u << li;
      }
      burst_id += 10;
      ++n_acc;
      ++n_act;
      if (tid == 0) s_tally->peak = fmaxf(s_tally->peak, mag_db);
      if (live && b + hb >= b0 && b - hb < b0 + BPT) {
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
        block_reduce<C, kGrid>(0ull, 0, cand != 0u, red_buf(), grid, NC,
                               cluster)
            .any &&
        tid == 0)
      ++s_tally->waits;
    if constexpr (!kWide) {
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
    // storing the history row that this update evicts next before every
    // block has read its halo words of it, and lets the row's bulk copy
    // overwrite s_ev.
    if (forced) {
      noise_update(row, f);
      all_sync<C, kGrid>(grid, NC, rank);
      load_evicted();
    }

    // phase: squelch
    // squelch (burst_detect.c:594-631)
    const bool squelch = p.max_bursts > 0 && primed && n_act > p.max_bursts;
    if (squelch) {
      const unsigned sq = valid & ~crt;
      const Reduced q =
          block_reduce<C, kGrid>(0ull, __popc(sq), false, red_buf(), grid,
                                 NC, cluster);
      if (tid == 0) {
        s_tally->n_tagged += q.total;
        s_tally->dropped += max(q.total - kESq, 0);
      }
      int e = q.excl;
      for (unsigned v = sq; v; v &= v - 1, ++e) {
        const int i = __ffs(v) - 1;
        if (e < kESq)
          emit(emitted + e, b0 + i, idx, last_of(i), start_of(i));
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
    if (act && n_act == 0) noise_update(row, f);
  }
  // phase: end

  if (tid == 0) {
    // the bulk copies still in flight: the history stores and the
    // evicted row loaded for an update that did not come
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (ev_ahead) mbar_wait(smem(s_ev_full), n_upd & 1);
  }
  if (live) {
    store_bins(st.bsum + b0, bsum);
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int g = b0 + i;
      st.a_valid[g] = (valid >> i) & 1u;
      if constexpr (!kWide) {
        st.a_last[g] = last_of(i);
        st.a_start[g] = start_of(i);
      }
    }
  }
  if (tid == 0 && gb == 0) {
    st.sc[0] = hidx;
    st.sc[1] = prim;
    st.sc[2] = burst_id;
    st.sc[3] = sq_count;
    st.sc[4] = s_tally->n_tagged;
    st.sc[5] = s_tally->dropped;
    st.sc[6] = s_tally->waits;
    st.sc[7] = min(emitted, p.G);
    st.scf[0] = s_tally->peak;
  }
  // no block leaves while another may still read its shared memory
  if constexpr (C > 1) cluster_sync();
}

// The tiled grid (F above MAX_RESIDENT, 1,835,008 on the H100): more
// bins than blocks that keep their bins' state on chip cover, since the
// grid barrier needs every block resident at once (7 clusters of 16 one-SM
// blocks). The grid stays 7 clusters of 16, and each block owns K
// contiguous tiles of at most kMaxBins bins (`layout`: tile t of the grid,
// block t / K, owns [t FB, min((t + 1) FB, F)); thread i of a block the 16
// bins from t FB + 16 i of each of its tiles). Each phase of a frame walks
// the block's tiles in ascending bin order, and what a thread keeps of a
// tile between the block's turns on it waits in device memory (L2):
//   - baseline_sum stays in its plane (each thread reads and writes only
//     its own bins' words), a_last / a_start and mask_count too, as on the
//     wide path;
//   - the valid, unmasked, candidate and gone (then created) bits and the
//     two halo sums go to `Turn`, one 16-byte word a thread a tile;
//   - the |X|^2 row and the history words are read from device memory
//     where they are used (16-byte loads; the row is read-only, so the
//     halo words need no exchange);
//   - a noise update reads the row it evicts (own and halo words) and
//     writes the new row only after the next barrier (`flush`): by then
//     every thread has read its words of the evicted row, and the next
//     update evicts another row (H >= 2), so no thread reads a word that
//     another has overwritten, and the halo sums need no private ring;
//   - a reduction (`tiled_reduce`) sums each tile's warp counts into
//     shared memory and carries each warp's key max and flag OR over the
//     tiles, then combines the blocks as a grid of clusters does
//     (`block_reduce`); a tile's count prefix adds, in bin order, the
//     lower blocks' counts (the reduction's), the block's lower tiles' and
//     the tile's lower warps' (`tile_prefix`), so emissions keep ascending
//     bin order;
//   - the gone lists are per tile in device memory (`Grid`, FB local bins
//     a tile: every bin the grid owns), and a mask release reads the lists
//     of every tile its window reaches, in this block or another.
// Every branch around a barrier depends only on grid-reduced values, and
// the tile loops hold no barrier (the warp shuffles inside them run on
// every lane). Its bound is bytes: a frame reads each bin's |X|^2 word,
// baseline_sum and Turn word, and a noise update also reads and writes
// baseline_sum and reads the evicted and writes the new history row (~25
// MB a frame at 2,097,152 bins, ~7.5 us at 3.35 TB/s). It runs several
// times that (tools/exp_scan.py): a block's tile turns are a chain of
// device-memory round trips. A noise update issues all of a tile's loads
// before its stores, since the compiler cannot tell the history from
// baseline_sum. Its per-bin state machine is detect_scan_kernel's, written
// over tiles: a change to the one is made to the other, and both are held
// to scan_plain.
constexpr int kTileBins = 16;     // a thread's bins of a tile
constexpr int kTileCluster = 16;  // blocks of a tiled grid's cluster

__global__ void __launch_bounds__(1024)
    detect_scan_tiled(State st, Params p, int K, uint4* turns) {
  constexpr int BPT = kTileBins, C = kTileCluster;
  constexpr unsigned kAll = (1u << BPT) - 1u;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int F = p.F, H = p.H, hb = p.half_bw, dc = F / 2;
  const int FB = p.block_bins;  // the bins of a tile
  const int NC = p.n_clusters, NT = NC * C * K;
  const int rank = cluster_rank();
  const int cluster = (int)blockIdx.x / C;
  const int gb = cluster * C + rank;
  const float thr = p.threshold;
  Grid grid{};
  grid.count = st.grid;
  grid.slots = reinterpret_cast<Slot*>(st.grid + 32);
  grid.ngone = reinterpret_cast<int*>(grid.slots + 2 * NC);
  grid.gone = reinterpret_cast<unsigned short*>(grid.ngone + NT);
  Red* s_red = reinterpret_cast<Red*>(smem_raw);     // 2
  int* s_cnt = reinterpret_cast<int*>(s_red + 2);    // [2][K][32]
  Tally* s_tally = reinterpret_cast<Tally*>(s_cnt + 2 * K * 32);

  struct Tile {
    int t, lo, b0;
    bool live, has_l, has_r;
  };
  auto tile = [&](int j) {
    Tile x;
    x.t = gb * K + j;
    x.lo = x.t * FB;
    x.b0 = x.lo + tid * BPT;
    x.live = x.b0 < min(x.lo + FB, F);
    x.has_l = x.live && x.b0 > 0;
    x.has_r = x.live && x.b0 + BPT < F;
    return x;
  };
  // the thread's Turn word of a tile: x valid | unmasked << 16; y
  // candidates | (gone, after the deletions created) << 16; z, w the halo
  // sums of bins b0 - 1 and b0 + 16
  auto turn = [&](const Tile& x) -> uint4& {
    return turns[(size_t)x.t * T + tid];
  };
  auto mag_row = [&](int f) { return st.mag2 + (size_t)f * F; };
  auto hist_row = [&](int r) { return st.hist + (size_t)r * F; };
  auto eligible = [&](const Tile& x) {
    unsigned e = 0;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int g = x.b0 + i;
      if (x.live && g >= hb && g < F - hb && !(g >= dc - 3 && g <= dc + 3))
        e |= 1u << i;
    }
    return e;
  };
  auto key_of = [&](float rel, int g) {
    return ((unsigned long long)__float_as_uint(rel) << 32) |
           (kFull - (unsigned)g);
  };
  bool red_odd = false;
  // One reduction over the grid's tiles: of_tile(x, key, cnt, flag) gives
  // the thread's values of tile x (zero-initialised); each tile's warp
  // counts stay in s_cnt for tile_prefix
  auto tiled_reduce = [&](auto&& of_tile) -> Reduced {
    red_odd = !red_odd;
    int* cnt_w = s_cnt + (red_odd ? K * 32 : 0);
    unsigned long long wk = 0ull;
    int wc = 0;
    bool wf = false;
    for (int j = 0; j < K; ++j) {
      unsigned long long key = 0ull;
      int cnt = 0;
      bool flag = false;
      of_tile(tile(j), key, cnt, flag);
      int c = 0;
      if (__any_sync(kFull, cnt != 0 || key != 0ull || flag)) {
        c = warp_sum(cnt);
        const unsigned long long k = warp_max64(key);
        wk = k > wk ? k : wk;
        wf |= __any_sync(kFull, flag);
      }
      if (lane == 0) cnt_w[j * 32 + warp] = c;
      wc += c;
    }
    // lane 31 carries the warp's count over the tiles
    return block_reduce<C, true>(wk, lane == 31 ? wc : 0, wf,
                                 s_red + (red_odd ? 1 : 0), grid, NC,
                                 cluster);
  };
  // of the last reduction: the count of tile j's bins below this thread's
  // (whose own count is cnt), and the tile's count
  auto tile_prefix = [&](int j, int cnt, int& before, int& total) {
    const int* cnt_w = s_cnt + (red_odd ? K * 32 : 0) + j * 32;
    const int c = lane < nw ? cnt_w[lane] : 0;
    const int wi = warp_incl_scan(c);
    total = __shfl_sync(kFull, wi, 31);
    before = __shfl_sync(kFull, wi - c, warp) + warp_incl_scan(cnt) - cnt;
  };

  if (tid == 0) *s_tally = Tally{st.sc[4], st.sc[5], st.sc[6], st.scf[0]};
  for (int j = 0; j < K; ++j) {
    const Tile x = tile(j);
    unsigned valid = 0, unmasked = x.live ? 0u : kAll;
    float bl = 0.0f, br = 0.0f;
    if (x.live) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const int g = x.b0 + i;
        if (st.a_valid[g]) valid |= 1u << i;
        if (st.mask_count[g] == 0) unmasked |= 1u << i;
      }
      if (x.has_l) bl = st.bsum[x.b0 - 1];
      if (x.has_r) br = st.bsum[x.b0 + BPT];
    }
    turn(x) = make_uint4(valid | unmasked << 16, 0u, __float_as_uint(bl),
                         __float_as_uint(br));
  }
  int hidx = st.sc[0], prim = st.sc[1], burst_id = st.sc[2];
  int sq_count = st.sc[3];
  int emitted = 0;
  // the last noise update's history row (hist row pend_row := |X|^2 row
  // pend_f), written after the next barrier; pend_f < 0: none
  int pend_f = -1, pend_row = 0;
  auto flush = [&]() {
    if (pend_f < 0) return;
    const float4* src = reinterpret_cast<const float4*>(mag_row(pend_f));
    float4* dst = reinterpret_cast<float4*>(hist_row(pend_row));
    for (int j = 0; j < K; ++j) {
      const Tile x = tile(j);
      if (!x.live) continue;
      float4 v[BPT / 4];
#pragma unroll
      for (int c = 0; c < BPT / 4; ++c) v[c] = __ldg(src + x.b0 / 4 + c);
#pragma unroll
      for (int c = 0; c < BPT / 4; ++c) dst[x.b0 / 4 + c] = v[c];
    }
    pend_f = -1;
  };
  int n_act = tiled_reduce([&](const Tile& x, unsigned long long&, int& cnt,
                               bool&) { cnt = __popc(turn(x).x & kAll); })
                  .total;
  // phase: begin

  auto noise_update = [&](int f) {
    // burst_detect.c:438-454; the order (sum - evicted) + mag is kept
    // (x - 0.0f is x, so an ungated update is a plain add)
    const bool gate = prim >= H;
    const float* row = mag_row(f);
    const float* ev = hist_row(hidx);
    for (int j = 0; j < K; ++j) {
      const Tile x = tile(j);
      if (!x.live) continue;
      const float4* m4 = reinterpret_cast<const float4*>(row + x.b0);
      const float4* e4 = reinterpret_cast<const float4*>(ev + x.b0);
      float4* s4 = reinterpret_cast<float4*>(st.bsum + x.b0);
      // every load before the first store; an ungated update subtracts
      // 0, and x - 0.0f is x
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 m[BPT / 4], e[BPT / 4], s[BPT / 4];
#pragma unroll
      for (int c = 0; c < BPT / 4; ++c) {
        m[c] = __ldg(m4 + c);
        e[c] = gate ? __ldcg(e4 + c) : z;
        s[c] = s4[c];
      }
      uint4 u = turn(x);
      const float ml = x.has_l ? __ldg(row + x.b0 - 1) : 0.0f;
      const float mr = x.has_r ? __ldg(row + x.b0 + BPT) : 0.0f;
      const float el = x.has_l && gate ? __ldcg(ev + x.b0 - 1) : 0.0f;
      const float er = x.has_r && gate ? __ldcg(ev + x.b0 + BPT) : 0.0f;
#pragma unroll
      for (int c = 0; c < BPT / 4; ++c)
        s4[c] = make_float4((s[c].x - e[c].x) + m[c].x,
                            (s[c].y - e[c].y) + m[c].y,
                            (s[c].z - e[c].z) + m[c].z,
                            (s[c].w - e[c].w) + m[c].w);
      if (x.has_l) u.z = __float_as_uint((__uint_as_float(u.z) - el) + ml);
      if (x.has_r) u.w = __float_as_uint((__uint_as_float(u.w) - er) + mr);
      turn(x) = u;
    }
    prim = min(prim + 1, H);
    pend_f = f;
    pend_row = hidx;
    hidx = hidx + 1 == H ? 0 : hidx + 1;
  };
  auto emit = [&](int pos, int g, int stop) {
    if (pos >= p.G) return;
    st.g_id[pos] = st.a_id[g];
    st.g_start[pos] = st.a_start[g];
    st.g_stop[pos] = stop;
    st.g_last[pos] = st.a_last[g];
    st.g_bin[pos] = g;
    st.g_mag[pos] = st.a_mag[g];
    st.g_noise[pos] = st.a_noise[g];
  };

  for (int f = 0; f < p.n_frames; ++f) {
    // phase: scan
    const int idx = f * F;
    const bool act = idx + F <= p.n_valid;
    const bool primed = prim >= H && act;
    const bool track = primed && n_act > 0;
    const float* row = mag_row(f);
    // each tile: the bins above threshold and, from the carried mask, the
    // candidates and their best key (burst_detect.c:679-699); then
    // update_bursts: a_last on the +-1-bin dilation, the gone bursts
    // (:458-469, :490-518)
    const Reduced r = tiled_reduce([&](const Tile& x, unsigned long long& key,
                                       int& cnt, bool& longb) {
      if (!x.live) return;
      const uint4 u = turn(x);
      const unsigned valid = u.x & kAll, pool = (u.x >> 16) & eligible(x);
      const float4* m4 = reinterpret_cast<const float4*>(row + x.b0);
      const float4* s4 = reinterpret_cast<const float4*>(st.bsum + x.b0);
      unsigned ab = 0, cand = 0;
#pragma unroll
      for (int c = 0; c < BPT / 4; ++c) {
        const float4 m4c = __ldg(m4 + c), s4c = s4[c];
        const float m[4] = {m4c.x, m4c.y, m4c.z, m4c.w};
        const float s[4] = {s4c.x, s4c.y, s4c.z, s4c.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * c + q;
          if (!above(m[q], s[q], thr)) continue;
          ab |= 1u << i;
          if (!((pool >> i) & 1u)) continue;
          cand |= 1u << i;
          if (primed) {
            const unsigned long long k = key_of(rel_of(m[q], s[q]),
                                                x.b0 + i);
            key = k > key ? k : key;
          }
        }
      }
      unsigned gone = 0;
      if (track && valid) {
        const bool al = x.has_l && above(__ldg(row + x.b0 - 1),
                                         __uint_as_float(u.z), thr);
        const bool ar = x.has_r && above(__ldg(row + x.b0 + BPT),
                                         __uint_as_float(u.w), thr);
        const unsigned dil = ab | (ab << 1) | (ab >> 1) | (al ? 1u : 0u) |
                             (ar ? 1u << (BPT - 1) : 0u);
        for (unsigned v = valid; v; v &= v - 1) {
          const int i = __ffs(v) - 1, g = x.b0 + i;
          int last = st.a_last[g];
          if ((dil >> i) & 1u) {
            last = idx;
            st.a_last[g] = idx;
          }
          const bool lb = (last - st.a_start[g]) > p.max_burst_len;
          longb |= lb;
          if (last + p.post_len <= idx || lb) gone |= 1u << i;
        }
      }
      turn(x).y = cand | gone << 16;
      cnt = __popc(gone);
    });
    flush();

    // phase: delete
    const int n_del = r.total;
    const bool forced = n_del > 0 && r.any;
    if (n_del > 0) {
      if (tid == 0) {
        s_tally->n_tagged += n_del;
        s_tally->dropped += max(n_del - kEDel, 0);
      }
      // emission ranks and each tile's gone list, in ascending bin order
      int below = r.lo;
      for (int j = 0; j < K; ++j) {
        const Tile x = tile(j);
        const unsigned gone = x.live ? turn(x).y >> 16 : 0u;
        int before, total;
        tile_prefix(j, __popc(gone), before, total);
        unsigned short* list = grid.gone + (size_t)x.t * FB;
        int e = below + before;
        for (unsigned v = gone; v; v &= v - 1, ++e, ++before) {
          const int i = __ffs(v) - 1;
          if (e < kEDel) emit(emitted + e, x.b0 + i, idx);
          list[before] = (unsigned short)(x.b0 + i - x.lo);
        }
        if (tid == 0) grid.ngone[x.t] = total;
        below += total;
      }
      emitted += min(n_del, kEDel);
      all_sync<C, true>(grid, NC, rank);
      // release the +-half_bw mask of every gone bin, emitted or not: the
      // tile's own list, then those of the tiles below and above (of this
      // block or another) that the thread's windows reach
      for (int j = 0; j < K; ++j) {
        const Tile x = tile(j);
        if (!x.live) continue;
        uint4& u = turn(x);
        int dec[BPT] = {};
        auto release = [&](int bin) {
          if (bin + hb < x.b0 || bin - hb >= x.b0 + BPT) return false;
#pragma unroll
          for (int i = 0; i < BPT; ++i)
            if (abs(x.b0 + i - bin) <= hb) ++dec[i];
          return true;
        };
        auto list = [&](int t) { return grid.gone + (size_t)t * FB; };
        for (int k = 0, n = __ldcg(grid.ngone + x.t); k < n; ++k)
          release(x.lo + __ldcg(list(x.t) + k));
        for (int t = x.t - 1; t >= 0 && x.b0 - hb < (t + 1) * FB; --t)
          for (int k = __ldcg(grid.ngone + t) - 1; k >= 0; --k)
            if (!release(t * FB + __ldcg(list(t) + k))) break;
        for (int t = x.t + 1; t < NT && x.b0 + BPT + hb > t * FB; ++t)
          for (int k = 0, n = __ldcg(grid.ngone + t); k < n; ++k)
            if (!release(t * FB + __ldcg(list(t) + k))) break;
        unsigned unmasked = u.x >> 16;
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          if (dec[i] == 0) continue;
          const int m = st.mask_count[x.b0 + i] - dec[i];
          st.mask_count[x.b0 + i] = m;
          if (m == 0) unmasked |= 1u << i;
        }
        const unsigned gone = u.y >> 16;
        u.x = (u.x & kAll & ~gone) | unmasked << 16;
        u.y &= kAll;  // the high half holds the created bits next
      }
      n_act -= n_del;
    }

    // phase: create
    // create_new_bursts: greedy argmax-and-mask (burst_detect.c:556-632)
    int n_acc = 0;
    unsigned long long key = r.key;
    for (int jc = 0; jc < p.k_create; ++jc) {
      if (jc > 0)
        key = tiled_reduce([&](const Tile& x, unsigned long long& k, int&,
                               bool&) {
                if (!x.live) return;
                for (unsigned v = turn(x).y & kAll; v; v &= v - 1) {
                  const int g = x.b0 + __ffs(v) - 1;
                  const unsigned long long c =
                      key_of(rel_of(__ldg(row + g), st.bsum[g]), g);
                  k = c > k ? c : k;
                }
              }).key;
      const float m = __uint_as_float((unsigned)(key >> 32));
      if (!(m > thr)) break;
      const int b = (int)(kFull - (unsigned)(key & kFull));
      const float mag_db =
          10.0f * log10f(fmaxf(m * p.hist_f * p.enbw, 1e-30f));
      for (int j = 0; j < K; ++j) {
        const Tile x = tile(j);
        if (!x.live || b + hb < x.b0 || b - hb >= x.b0 + BPT) continue;
        uint4& u = turn(x);
        unsigned valid = u.x & kAll, unmasked = u.x >> 16;
        unsigned cand = u.y & kAll, crt = u.y >> 16;
        if ((unsigned)(b - x.b0) < (unsigned)BPT) {
          float base_at = st.bsum[b];
          // the sum after the forced noise update, which runs below
          if (forced)
            base_at = (base_at - (prim >= H ? __ldcg(hist_row(hidx) + b)
                                            : 0.0f)) +
                      __ldg(row + b);
          const float noise_db = 10.0f * log10f(fmaxf(
              base_at / p.hist_f / p.f2 / p.enbw / p.bin_width, 1e-30f));
          st.a_id[b] = burst_id;
          st.a_start[b] = idx - p.pre_len;
          st.a_mag[b] = mag_db;
          st.a_noise[b] = noise_db;
          st.a_last[b] = idx - p.pre_len;
          valid |= 1u << (b - x.b0);
          crt |= 1u << (b - x.b0);
        }
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          if (abs(x.b0 + i - b) <= hb) {
            st.mask_count[x.b0 + i] += 1;
            unmasked &= ~(1u << i);
            cand &= ~(1u << i);
          }
        }
        u.x = valid | unmasked << 16;
        u.y = cand | crt << 16;
      }
      burst_id += 10;
      ++n_acc;
      ++n_act;
      if (tid == 0) s_tally->peak = fmaxf(s_tally->peak, mag_db);
    }
    if (n_acc == p.k_create &&
        tiled_reduce([&](const Tile& x, unsigned long long&, int&,
                         bool& any) {
          any = x.live && (turn(x).y & kAll) != 0u;
        }).any &&
        tid == 0)
      ++s_tally->waits;
    // the forced noise update on a long-burst deletion
    // (burst_detect.c:516); its history row is written after the barrier
    if (forced) {
      noise_update(f);
      all_sync<C, true>(grid, NC, rank);
      flush();
    }

    // phase: squelch
    // squelch (burst_detect.c:594-631)
    const bool squelch = p.max_bursts > 0 && primed && n_act > p.max_bursts;
    if (squelch) {
      const Reduced q = tiled_reduce([&](const Tile& x, unsigned long long&,
                                         int& cnt, bool&) {
        if (x.live) cnt = __popc(turn(x).x & kAll & ~(turn(x).y >> 16));
      });
      if (tid == 0) {
        s_tally->n_tagged += q.total;
        s_tally->dropped += max(q.total - kESq, 0);
      }
      int below = q.lo;
      for (int j = 0; j < K; ++j) {
        const Tile x = tile(j);
        const uint4 u = x.live ? turn(x) : make_uint4(0u, 0u, 0u, 0u);
        const unsigned sq = u.x & kAll & ~(u.y >> 16);
        int before, total;
        tile_prefix(j, __popc(sq), before, total);
        int e = below + before;
        for (unsigned v = sq; v; v &= v - 1, ++e)
          if (e < kESq) emit(emitted + e, x.b0 + __ffs(v) - 1, idx);
        below += total;
        if (x.live) {
#pragma unroll
          for (int i = 0; i < BPT; ++i)
            if (!((u.x >> (16 + i)) & 1u)) st.mask_count[x.b0 + i] = 0;
          turn(x).x = kAll << 16;
        }
      }
      emitted += min(q.total, kESq);
      n_act = 0;
      sq_count += 3;
    } else if (act) {
      sq_count = max(sq_count - 1, 0);
    }
    // noise-estimate reset after repeated squelch
    if (act && sq_count >= 10) {
      for (int j = 0; j < K; ++j) {
        const Tile x = tile(j);
        if (!x.live) continue;
        float4* s4 = reinterpret_cast<float4*>(st.bsum + x.b0);
#pragma unroll
        for (int c = 0; c < BPT / 4; ++c)
          s4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        turn(x).z = 0u;
        turn(x).w = 0u;
      }
      prim = 0;
      sq_count = 0;
    }
    // phase: noise
    // final noise update if no burst is active (burst_detect.c:698)
    if (act && n_act == 0) noise_update(f);
  }
  // phase: end

  // every thread has read its words of the row the last update evicted
  all_sync<C, true>(grid, NC, rank);
  flush();
  for (int j = 0; j < K; ++j) {
    const Tile x = tile(j);
    if (!x.live) continue;
    const unsigned valid = turn(x).x;
#pragma unroll
    for (int i = 0; i < BPT; ++i) st.a_valid[x.b0 + i] = (valid >> i) & 1u;
  }
  if (tid == 0 && gb == 0) {
    st.sc[0] = hidx;
    st.sc[1] = prim;
    st.sc[2] = burst_id;
    st.sc[3] = sq_count;
    st.sc[4] = s_tally->n_tagged;
    st.sc[5] = s_tally->dropped;
    st.sc[6] = s_tally->waits;
    st.sc[7] = min(emitted, p.G);
    st.scf[0] = s_tally->peak;
  }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

// The dynamic shared memory of a block of T threads of BPT bins, FB bins
// a block, as the kernel carves it up
size_t shared_bytes(int FB, int T, int BPT) {
  const bool wide = BPT == 16;
  const size_t stages = wide ? 2 : 3;
  const size_t RW = wide ? kMaxBins : FB;
  const size_t NB = wide ? kMaxBins : (size_t)T * BPT;
  return (stages + 1) * RW * sizeof(float) +
         (wide ? 0 : 2 * NB * sizeof(int)) + NB * sizeof(unsigned short) +
         2 * sizeof(Red) + (stages + 6) * sizeof(unsigned long long);
}

// The tiled kernel's dynamic shared memory: the reduction buffers, each
// tile's warp counts of two reductions, the tally
size_t tiled_shared_bytes(int K) {
  return 2 * sizeof(Red) + 2 * (size_t)K * 32 * sizeof(int) + sizeof(Tally);
}

// A kernel's attributes: its dynamic shared memory and, for a cluster
// above the portable 8 blocks, the non-portable size
template <typename Kern>
cudaError_t set_attributes(Kern kern, int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int C, int N, int T, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * N, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of C blocks of the kernel the card can hold at once
// (cudaOccupancyMaxActiveClusters, after the launch's attributes are set)
template <typename Kern>
cudaError_t max_clusters(Kern kern, int C, int T, size_t smem, int* n) {
  cudaError_t err = set_attributes(kern, C, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, 1, T, smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// A launch of N clusters of C blocks. A grid (kGrid) spins at its
// barriers, so every cluster must be resident at once: a grid of more
// clusters than the card places is refused here (the cooperative launch
// counts blocks, not where clusters fit), and the launch is cooperative
// besides
template <typename Kern, typename... Args>
cudaError_t launch_clusters(Kern kern, bool grid, int C, int N, int T,
                            size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = set_attributes(kern, C, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(C, N, T, smem, stream, attr);
  if (grid) {
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < N) return cudaErrorCooperativeLaunchTooLarge;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing behind
    return err;
  }
  return cudaGetLastError();
}

template <int BPT, int C, bool kGrid>
cudaError_t launch(const State& st, const Params& p, int T,
                   cudaStream_t stream) {
  const size_t smem = shared_bytes(p.block_bins, T, BPT);
  if constexpr (C == 1) {
    const cudaError_t err =
        set_attributes(detect_scan_kernel<BPT, C, kGrid>, C, smem);
    if (err != cudaSuccess) return err;
    detect_scan_kernel<BPT, C, kGrid><<<1, T, smem, stream>>>(st, p);
    return cudaGetLastError();
  } else {
    return launch_clusters(detect_scan_kernel<BPT, C, kGrid>, kGrid, C,
                           p.n_clusters, T, smem, stream, st, p);
  }
}

// Whether (clusters, block_bins, threads, bins_per_thread, grid clusters,
// tiles) is a layout the kernel runs at F bins: every bin one thread's,
// whole warps of at most 1024 threads and kMaxBins bin slots, shared
// memory within a block's kMaxShared, an instantiation for the bins a
// thread and the cluster (the wide path only in clusters of 16; a grid
// only of clusters of 16, of 8 or 16 bins a thread; tiles only in clusters
// of 16, of 16 bins a thread, the last block holding bins)
bool valid_layout(int F, int C, int FB, int T, int BPT, int N, int K) {
  if (F <= 0 || F % 128 != 0 || T < 32 || T > 1024 || T % 32 != 0 ||
      BPT <= 0 || (long long)T * BPT > kMaxBins || FB <= 0 ||
      FB % BPT != 0 || FB > T * BPT || FB - T * BPT <= -32 * BPT || N < 1 ||
      K < 1)
    return false;
  const long long B = (long long)C * N;
  if (K > 1)
    return C == 16 && BPT == kTileBins &&
           tiled_shared_bytes(K) <= kMaxShared && B * K * FB >= F &&
           (B - 1) * K * FB < F;
  if (shared_bytes(FB, T, BPT) > kMaxShared) return false;
  if (B * FB < F || (B - 1) * FB >= F) return false;
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return false;
  if (N > 1) return C == 16 && (BPT == 8 || BPT == 16);
  if (C == 1) return BPT == 1 || BPT == 2 || BPT == 4 || BPT == 8;
  return BPT == 8 || (BPT == 16 && C == 16);
}

// fn<BPT, C, grid>() for the layout's instantiation (valid_layout holds)
template <template <int, int, bool> class Fn, typename... Args>
cudaError_t dispatch(int C, int BPT, int N, Args&&... args) {
  if (N > 1)
    return BPT == 8 ? Fn<8, 16, true>::run(args...)
                    : Fn<16, 16, true>::run(args...);
  switch (C * 64 + BPT) {
    case 64 + 1: return Fn<1, 1, false>::run(args...);
    case 64 + 2: return Fn<2, 1, false>::run(args...);
    case 64 + 4: return Fn<4, 1, false>::run(args...);
    case 64 + 8: return Fn<8, 1, false>::run(args...);
    case 128 + 8: return Fn<8, 2, false>::run(args...);
    case 256 + 8: return Fn<8, 4, false>::run(args...);
    case 512 + 8: return Fn<8, 8, false>::run(args...);
    case 1024 + 8: return Fn<8, 16, false>::run(args...);
    default: return Fn<16, 16, false>::run(args...);
  }
}

template <int BPT, int C, bool kGrid>
struct Launch {
  static cudaError_t run(const State& st, const Params& p, int T,
                         cudaStream_t stream) {
    return launch<BPT, C, kGrid>(st, p, T, stream);
  }
};

template <int BPT, int C, bool kGrid>
struct MaxClusters {
  static cudaError_t run(const Params& p, int T, int* n) {
    if constexpr (C == 1) {
      return cudaErrorInvalidValue;
    } else {
      return max_clusters(detect_scan_kernel<BPT, C, kGrid>, C, T,
                          shared_bytes(p.block_bins, T, BPT), n);
    }
  }
};

}  // namespace

// The layout is dsp/detect_scan.py's `layout(F)`: `grid_clusters` clusters
// of `clusters` blocks of `threads` threads, `tiles` tiles of `block_bins`
// bins a block, `bins_per_thread` a thread. `halo`: scratch of blocks x 2 x
// H floats (unused by one block and by tiles); `grid`: a grid's scratch
// (`Grid`, `grid_words` 32-bit words, zeroed; unused by one cluster);
// `turns`: the tiled kernel's (`tile_words` 32-bit words; unused without
// tiles). A grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge, 720) before anything runs.
extern "C" int detect_scan(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf,
    float* halo, unsigned* grid, uint4* turns, int F, int n_frames, int H,
    int G, int n_valid,
    int half_bw, int k_create, int max_bursts, int max_burst_len,
    int post_len, int pre_len, float threshold, float hist_f, float enbw,
    float f2, float bin_width, int clusters, int block_bins, int threads,
    int bins_per_thread, int grid_clusters, int tiles,
    cudaStream_t stream) {
  const State st{mag2,  hist,   bsum,    a_valid, a_id,   a_start, a_last,
                 a_mag, a_noise, mask_count, g_id, g_start, g_stop, g_last,
                 g_bin, g_mag,  g_noise, sc,      scf,    halo,   grid};
  const Params p{F,          n_frames, H,        G,        n_valid,
                 half_bw,    k_create, max_bursts, max_burst_len, post_len,
                 pre_len,    threshold, hist_f,  enbw,     f2,
                 bin_width,  block_bins, grid_clusters};
  if (!valid_layout(F, clusters, block_bins, threads, bins_per_thread,
                    grid_clusters, tiles))
    return (int)cudaErrorInvalidValue;
  if (tiles > 1)
    return (int)launch_clusters(detect_scan_tiled, true, kTileCluster,
                                grid_clusters, threads,
                                tiled_shared_bytes(tiles), stream, st, p,
                                tiles, turns);
  return (int)dispatch<Launch>(clusters, bins_per_thread, grid_clusters, st,
                               p, threads, stream);
}

// The clusters of the F-bin layout that the card can hold at once, into
// *n (0: it cannot launch one); the launch's own attributes are set first,
// so a cluster of 16 is asked for as the launch asks for it
extern "C" int detect_scan_max_clusters(int F, int clusters, int block_bins,
                                        int threads, int bins_per_thread,
                                        int grid_clusters, int tiles,
                                        int* n) {
  Params p{};
  p.F = F;
  p.block_bins = block_bins;
  p.n_clusters = grid_clusters;
  if (!valid_layout(F, clusters, block_bins, threads, bins_per_thread,
                    grid_clusters, tiles) ||
      clusters < 2)
    return (int)cudaErrorInvalidValue;
  if (tiles > 1)
    return (int)max_clusters(detect_scan_tiled, kTileCluster, threads,
                             tiled_shared_bytes(tiles), n);
  return (int)dispatch<MaxClusters>(clusters, bins_per_thread,
                                    grid_clusters, p, threads, n);
}

extern "C" const char* detect_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
