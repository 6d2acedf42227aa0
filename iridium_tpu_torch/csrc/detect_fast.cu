// detect_fast: the branchless chunked burst detector over one block of
// fftshifted |X|^2 frames: one launch a block over one bin range, or, for
// binshard's bin ranges coupled by an all_reduce a frame, two launches a
// frame cut at the coupling seam (the split, below).
//
// Replaces: the compiled scan of iridium_tpu/dsp/detect_fast.py
// `make_scan_fast` (:169): its chunk body's `lax.scan` (:604) over the
// frame body's (:530; the frame body :280-508). That program is not a
// `pallas_call`; the port ran it as a Python loop of about 240 tensor
// operations a frame (dsp/detect_fast.py `scan_fast_plain`, the plain
// twin that this kernel is held to bit for bit).
//
// Bound on the H100: the |X|^2 rows are read once (n_frames x FL x 4
// bytes: 67 MB for a 2,048 x 8,192 block, 20 us at 3.35 TB/s) and the
// state is read and written once; but frame f + 1 depends on the state
// frame f leaves, and every frame couples all bins (the creation
// candidates, the deletion ranks and the active count are band-wide), so
// the frames run one after another and the time goes to each frame's
// chain of dependent steps and barriers, not to bytes.
//
// Semantics are the twin's (and so the JAX function's), frame by frame:
//   phase A, per bin: the relative magnitude, the +-1-bin dilation that
//     extends a_last, the long-burst and gone tests, the deletion (its
//     flag for the mask release), the masked candidate value relm;
//   the seam: the K_TOP largest segment maxima of relm (a segment's
//     lowest bin among equal values, as `max(1)`; the lower segment first
//     among equal maxima, as the twin's keys), the greedy acceptance (a
//     candidate within half_bw of an accepted one is skipped, at most
//     k_create taken), and the coupling pair [any long-burst deletion,
//     owned active count after the creations];
//   phase B, per bin: the deletion rows, the creations (their dB values
//     from the bin's sum before the forced noise update, which they
//     apply in the twin's float order), the forced update, the mask
//     update (creations added, deletions released, within +-half_bw), the
//     squelch rows and the squelch, the noise reset and the final noise
//     update.
// The twin reads the 2 CHUNK history rows a chunk can evict when the
// chunk starts and writes the rows it updated when it ends; the kernel
// keeps the ring live (an update reads the row at hist_idx, then writes
// the frame's row there). The rows are the same: a chunk makes at most 2
// CHUNK <= H updates, so no eviction of a chunk reaches a row the chunk
// wrote (plan() refuses H < 2, where it would).
// The twin counts a frame's deletion and squelch emissions in one int32
// cumsum of packed 16-bit halves; the kernel counts them apart, so its
// results equal the twin's wherever the twin's halves stay apart (fewer
// than 65,536 deletions of owned bins in one frame).
// Burst ids and the counters are formed in unsigned 32-bit arithmetic:
// the twin forms them in int64 and casts to int32, which keeps the same
// low 32 bits. Positions are int32 (idx = f F <= 2^31 - F, plan()).
//
// Layout (dsp/detect_fast.py `plan`, the one place it is decided; the C
// entry refuses any other): `blocks` blocks of `threads` threads in
// clusters of `clusters` blocks, block b owning the local bins [b FB,
// min((b + 1) FB, FL)) (FB = threads x BPT), thread t of it the BPT from
// b FB + t BPT (bins past FL idle):
//   - up to 8,192 bins one block, BPT the fewest of 1, 2, 4, 8 that 1,024
//     threads hold (its barrier: __syncthreads);
//   - up to 131,072 bins one cluster of 2-16 blocks of at most 8,192 bins,
//     8 a thread, up to 262,144 of 16 blocks of 16 a thread (the wide
//     path); the blocks meet through distributed shared memory (`mapa`)
//     after a cluster barrier (barrier.cluster.arrive.release /
//     wait.acquire);
//   - above, a grid of clusters that meet in device memory only between
//     clusters (an arrival counter, red.release / ld.acquire at gpu scope,
//     a wait over ~17 s traps instead of hanging the card): up to 7
//     clusters of 16 blocks of 8 then 16 bins a thread, then clusters of 2
//     wide blocks, one an SM, to 2,162,688 bins, then clusters of 2 deep
//     blocks of 32 bins a thread (the deep path: 3.2 GHz), to 4,325,376.
//     Every cluster must be resident at once: the packing asks the card
//     and refuses a grid it cannot place
//     (cudaErrorCooperativeLaunchTooLarge), and the launch is cooperative.
// Every branch around a barrier depends only on values every block
// computes alike.
//
// Design of a block: the frames form one chain, so what a frame waits on
// is kept off it and the common frame is short:
//   - the block's |X|^2 words of each row stream through a ring of two
//     stages in shared memory, one TMA bulk copy a row (`cp.async.bulk`,
//     completing on the stage's mbarrier), issued by thread 0 a frame
//     ahead (on the deep path, whose 32,768-bin rows leave no room for two
//     stages beside the evicted row, the threads read their row words from
//     device memory). A local width of 2 mod 4 bins (binshard's ranges)
//     starts every other row 8 bytes past a 16-byte boundary, which a bulk
//     copy needs: the copy starts at the boundary below the row (`mis` words
//     early; the wrapper checks that |X|^2 starts on one) and ends at the
//     one above, and the readers skip `mis` words;
//   - the noise history stays a ring in device memory. The same
//     misalignment rules out bulk copies of history rows (the frame's row
//     and the history row start at different offsets from a boundary), so
//     each thread moves its own words, as 16-byte vectors where the row
//     allows: the row that the next update evicts is copied into shared
//     memory right after the update before, with `cp.async` (each thread
//     waits for its own words before the frame's barrier), and an update
//     stores the frame's words from the ring stage;
//   - baseline_sum stays in registers; each thread also carries the sums
//     of the two bins beside its range (updated with the same arithmetic,
//     so bit-equal to the owner's), so the +-1-bin dilation needs no
//     exchange. The evicted history words of those two bins are the
//     neighbours' words of the evicted-row buffer, which alternates
//     between two by update (a thread loads the next row's words into one
//     while its neighbours may still read the other); the block's edge
//     threads, and on the wide path (one buffer) every thread, read them
//     from the history right after each update, before the barrier that
//     orders their owner's next store of that row (a frame has a barrier
//     before every update);
//   - at most 1,024 threads of 64 registers; the state a thread keeps
//     across frames and phase B's rarer work spill (`ptxas -v`), and the
//     spills land in L2, since the shared memory leaves ~28 KB of L1
//     (tools/exp_fast.py --phases splits a frame between the phases);
//   - a_valid and "mask_count is zero" are bitmasks; a_last and a_start
//     live in shared memory (the wide path keeps them in device memory,
//     read only where a burst is active); mask_count, a_id, a_mag and
//     a_noise are touched in device memory only at a creation, a release
//     or an emission; the state is read once at the start of a launch and
//     written once at its end;
//   - the relative magnitude is divided out only where it can exceed the
//     threshold: mag <= RD(threshold * sum) proves mag / sum <= threshold,
//     so the common bin costs a multiply and a compare (the division stays
//     IEEE, --fmad=false);
//   - a frame makes ONE reduction: each warp's 8 largest candidate keys
//     (a key: relm's bits, the bin reversed, the bin's active flag after
//     the deletions; keys are unique, so a merge of any grouping is
//     exact), its owned deletions (an inclusive scan: the emission ranks)
//     and the OR of its deletion and long-burst flags, published in shared
//     memory on alternating buffers. One block: every warp reads the 32
//     warps' headers after the barrier, and a frame with no candidate,
//     deletion or long burst ends there; a frame with candidates adds a
//     barrier, after warp 0 merges the keys and walks the acceptance. A
//     cluster: after the cluster barrier warp 0 of every block reads every
//     block's headers through distributed shared memory (lane l: warp l of
//     each block) and hands the result to its block at a block barrier; a
//     grid adds the clusters' results in device memory between the two; a
//     warp's keys are extracted largest first (one warp max a key, each
//     lane's segment maxima below the last key recomputed), and merged by
//     the same walk over the lists' heads, so no lane holds a list;
//   - the owned active count is kept as a scalar (less the frame's owned
//     deletions, plus the creations at inactive owned bins, 0 after a
//     squelch), so the common frame's reduction is all zeros and its
//     votes skip the shuffles; a squelch adds one reduction (its rows'
//     ranks); a noise update right after a forced one adds a barrier;
//   - the mask release reads each deleted bin's flag from the flag words
//     (a word a thread: bit j, its bin j) within +-half_bw: the block's in
//     shared memory, other blocks' in device memory, both on alternating
//     buffers.
//
// The split (dsp/detect_fast.py `SplitScan`, binshard): frame f of the
// block is two launches of the same plan around the caller's all_reduce,
// on one stream, over one scratch the wrapper zeroes once a block:
//   - launch A: phase A, the reduction, the seam; it stores the frame's
//     Seam (the taken candidates, the counts) and, from block 0, the pair
//     [any_long, n_own_post] as two int64 (the reduction's second count
//     gives the owned active count; every block computes the same pair),
//     and each thread's flag word and first emission rank; it writes back
//     a_valid and a_last;
//   - the caller sums the pair over the bin ranges in place (`all_reduce`;
//     one range: leaves it);
//   - launch B: loads the Seam, reads the summed pair, forms force and
//     squelch from it, and runs phase B; it writes back the state.
// A launch carries nothing to the next but device memory: the per-bin
// state is read at its start and written at its end (binshard's ranges
// are small enough for L2, and keeping a second copy in the scratch would
// save nothing); the scalar chain crosses frames in two slots of the
// scratch (frame f's launches read slot f % 2, A of frame 0 reads the
// state's scalars and block 0 stores them in slot 0, block 0 of B writes
// slot (f + 1) % 2, which no block of frame f reads; B of the last frame
// writes the state's scalars); each launch kind has its own arrival
// counter, which block 0 zeroes for the other kind (its last launch has
// ended, its next has not begun). The dilation's halo sums are read from
// baseline_sum at each launch A.
//
// Built with --fmad=false and nvcc's default IEEE division, so every sum,
// product and quotient rounds as the twin's tensor operations do on the
// card: a tensor divided by a tensor is an IEEE quotient; a tensor divided
// by a Python scalar (the noise dB's four divisions) is, in PyTorch's CUDA
// kernel, a product with the scalar's f32 reciprocal (on the CPU a
// quotient: the two part by an ulp in some values, which the CPU tests'
// dB tolerance covers); log10f is the function PyTorch's CUDA log10 calls.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kEDel = 8;   // deletion rows a frame
constexpr int kESq = 16;   // squelch rows a frame
constexpr int kList = 8;   // candidate keys kept (the most K_TOP there is)
constexpr int kMaxCreate = 4;
constexpr int kMaxThreads = 1024;
constexpr int kRingBins = 8192;    // a ring block's most bins (BPT <= 8)
constexpr int kWideBins = 16384;   // a wide block's (BPT 16)
constexpr int kDeepBins = 32768;   // a deep block's (BPT 32, no ring)
constexpr size_t kMaxShared = 227 * 1024;  // a block's most on sm_90
constexpr int kLineWords = 32;     // an arrival counter's line (two)
constexpr int kFrameWords = 20;    // sizeof(Frame) / 4
constexpr int kPairWords = 4;      // the split's pair: two int64
constexpr int kScalarWords = 10;   // sizeof(Scalars) / 4
constexpr int kSeamWords = 16;     // sizeof(Seam) / 4
// `detect_fast`'s modes: the whole block in one launch; launch A or B of
// one frame of the split
constexpr int kModeWhole = 0, kModeA = 1, kModeB = 2;
constexpr unsigned kFull = 0xffffffffu;
// a grid barrier's longest wait, ~17 s at the H100's 1.98 GHz: far above
// any frame's, and a fault instead of a hang where a cluster never arrives
constexpr long long kSpinCycles = 1ll << 35;

struct Params {
  int F, FL, n_act, H, G, hb, k_create, max_bursts, max_burst_len, post_len,
      pre_len, id_stride, bin_lo, own_lo, own_hi;
  float thr, hist_f, enbw, f2, bin_width;
  int blocks, clusters, block_bins, threads, bpt, seg;
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
  int* mask;
  int* g_id;
  int* g_start;
  int* g_stop;
  int* g_last;
  int* g_bin;
  float* g_mag;
  float* g_noise;
  int* sc;     // hist_idx, primed, burst_id, squelch_count, n_tagged,
               // burst_dropped, create_waits, g_count
  float* scf;  // peak_signal_db
  unsigned* scratch;  // `Scratch`
};

// A reduction's result: the count's total, the second count's total, the
// OR of the flags (bit 0: a deletion, bit 1: a long burst, bit 2: keys),
// the count of the lower blocks, and the largest candidate keys
// (descending, 0-padded); a cluster's share of a grid reduction (lo
// unused)
struct Frame {
  int n_del, cnt2, bits, lo;
  unsigned long long keys[kList];
};
static_assert(sizeof(Frame) == 4 * kFrameWords, "Frame layout");

// A warp's share of a reduction, in shared memory
struct Hdr {
  int cnt;   // the warp's count (lane 31's inclusive scan)
  int cnt2;
  int bits;  // the flags; 4: the warp has keys
  int pad;
  unsigned long long keys[kList];  // 0-ended where fewer
};

// The frame's seam, as warp 0 leaves it for its block (and launch A for
// launch B)
struct Seam {
  int take_bin[kMaxCreate];  // the taken candidates, in acceptance order
  float take_val[kMaxCreate];
  int take_valid;  // bit k: taken candidate k's bin was active
  int n_acc, more;
  int n_del;   // owned deletions, all blocks
  int bits;    // the reduction's flags
  int n_post;  // this range's owned active count after the creations
  int pad[2];
};
static_assert(sizeof(Seam) == 4 * kSeamWords, "Seam layout");

// The scalar chain of the split, crossing launches
struct Scalars {
  int hidx, prim, sq_count, g_run;
  unsigned burst_id, n_tagged, dropped, waits;
  float peak;
  int pad;
};
static_assert(sizeof(Scalars) == 4 * kScalarWords, "Scalars layout");

// The counters only the final state reports, kept by thread 0 (every
// block's alike; block 0's are written)
struct Tally {
  unsigned n_tagged, dropped, waits;
  float peak;
};

// The scratch (32-bit words, zeroed by the wrapper; dsp/detect_fast.py
// `scratch_words`): two arrival counters (a line each), a grid's slots
// (two parities of one Frame a cluster), the flag words (two parities of
// one a thread); the split's after them: the pair, two Scalars slots, the
// Seam, each thread's first emission rank
struct Scratch {
  unsigned* count;
  Frame* slots;
  unsigned* flags;
  long long* pair;
  Scalars* slot;
  Seam* seam;
  int* rank;
};

__host__ __device__ __forceinline__ long long one_words(const Params& p) {
  const long long B = p.blocks, N = p.blocks / p.clusters;
  return 2 * kLineWords + (N > 1 ? 2 * N * kFrameWords : 0) +
         2 * B * p.threads;
}

__host__ __device__ __forceinline__ long long split_words(const Params& p) {
  return one_words(p) + kPairWords + 2 * kScalarWords + kSeamWords +
         (long long)p.blocks * p.threads;
}

__device__ __forceinline__ Scratch scratch_of(unsigned* base,
                                              const Params& p) {
  const long long B = p.blocks, N = p.blocks / p.clusters;
  Scratch s;
  s.count = base;
  unsigned* w = base + 2 * kLineWords;
  s.slots = reinterpret_cast<Frame*>(w);
  w += N > 1 ? 2 * N * kFrameWords : 0;
  s.flags = w;
  w += 2 * B * p.threads;
  s.pair = reinterpret_cast<long long*>(w);
  w += kPairWords;
  s.slot = reinterpret_cast<Scalars*>(w);
  w += 2 * kScalarWords;
  s.seam = reinterpret_cast<Seam*>(w);
  w += kSeamWords;
  s.rank = reinterpret_cast<int*>(w);
  return s;
}

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

// *p in the shared memory of cluster block `rank` (a generic address)
template <typename T>
__device__ __forceinline__ const T* peer(const T* p, int rank) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(a)
               : "l"(p), "r"(rank));
  return reinterpret_cast<const T*>(a);
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

// A candidate's key: relm's bits (relm > 0, so they order as its
// values), then the bin reversed (the lower bin first among equal
// values), then whether the bin is active after the deletions (never
// decides an order: the bins differ)
__device__ __forceinline__ unsigned long long cand_key(float relm, int bin,
                                                       bool active) {
  return ((unsigned long long)__float_as_uint(relm) << 32) |
         ((unsigned long long)(0x7fffffffu - (unsigned)bin) << 1) |
         (active ? 1ull : 0ull);
}

__device__ __forceinline__ float key_val(unsigned long long k) {
  return __uint_as_float((unsigned)(k >> 32));
}

__device__ __forceinline__ int key_bin(unsigned long long k) {
  return (int)(0x7fffffffu - ((unsigned)k >> 1));
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
  return thr < 0.0f || mag > __fmul_rd(thr, sum);
}
__device__ __forceinline__ bool above(float mag, float sum, float thr) {
  return maybe_above(mag, sum, thr) && rel_of(mag, sum) > thr;
}

__device__ __forceinline__ int next_slot(int h, int H) {
  return h + 1 == H ? 0 : h + 1;
}

// The first n of BPT contiguous 32-bit words at p (shared or device
// memory) into v, as 16- or 8-byte vectors where n = BPT and p allows (a
// warp then reads whole lines, where word-by-word loads from neighbouring
// threads' BPT-word runs would hit the same banks), and `put`, the same
// the other way
template <int BPT, typename W>
__device__ __forceinline__ void get(W (&v)[BPT], const W* p, int n) {
  static_assert(sizeof(W) == 4, "32-bit words");
  const uintptr_t a = (uintptr_t)p;
  if (BPT % 4 == 0 && n == BPT && (a & 15u) == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) v[i + k] = *reinterpret_cast<const W*>(&u[k]);
    }
  } else if (BPT % 2 == 0 && n == BPT && (a & 7u) == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 2) {
      const uint2 q = *reinterpret_cast<const uint2*>(p + i);
      v[i] = *reinterpret_cast<const W*>(&q.x);
      v[i + 1] = *reinterpret_cast<const W*>(&q.y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BPT; ++i)
      if (i < n) v[i] = p[i];
  }
}

// Group q of the thread's words at p (4 words, or BPT where fewer) into
// v, as one 16-byte vector where `vec` (p on a 16-byte boundary, BPT a
// multiple of 4), and `put4`, the same the other way: a thread walks its
// words a group at a time, so that only one group is live at once
template <int BPT>
__device__ __forceinline__ void get4(float (&v)[4], const float* p, int q,
                                     bool vec) {
  constexpr int G = BPT < 4 ? BPT : 4;
  if (G == 4 && vec) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = p[G * q + k];
  }
}

template <int BPT>
__device__ __forceinline__ void put4(float* p, const float (&v)[4], int q,
                                     bool vec, int n) {
  constexpr int G = BPT < 4 ? BPT : 4;
  if (G == 4 && vec) {
    *reinterpret_cast<float4*>(p + 4 * q) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (G * q + k < n) p[G * q + k] = v[k];
  }
}

template <int BPT, typename W>
__device__ __forceinline__ void put(W* p, const W (&v)[BPT], int n) {
  static_assert(sizeof(W) == 4, "32-bit words");
  const uintptr_t a = (uintptr_t)p;
  if (BPT % 4 == 0 && n == BPT && (a & 15u) == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 4) {
      uint4 q;
      q.x = *reinterpret_cast<const unsigned*>(&v[i]);
      q.y = *reinterpret_cast<const unsigned*>(&v[i + 1]);
      q.z = *reinterpret_cast<const unsigned*>(&v[i + 2]);
      q.w = *reinterpret_cast<const unsigned*>(&v[i + 3]);
      *reinterpret_cast<uint4*>(p + i) = q;
    }
  } else if (BPT % 2 == 0 && n == BPT && (a & 7u) == 0) {
#pragma unroll
    for (int i = 0; i < BPT; i += 2) {
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&v[i]);
      q.y = *reinterpret_cast<const unsigned*>(&v[i + 1]);
      *reinterpret_cast<uint2*>(p + i) = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BPT; ++i)
      if (i < n) p[i] = v[i];
  }
}

// Whether this launch's blocks meet through a cluster, and a grid
template <int BPT, bool kClu, bool kGrid>
__global__ void __launch_bounds__(kMaxThreads, 1)
    detect_fast_kernel(const State st, const Params p, int mode, int frame) {
  static_assert(!kGrid || kClu, "a grid is of clusters");
  static_assert(!kClu || BPT >= 8, "a cluster block holds 8 bins a thread "
                                    "or more");
  // two ring stages; off the wide path two evicted-row buffers and a_last /
  // a_start in shared memory, on it (16 bins a thread) one buffer and
  // device memory; the deep path (32) as the wide, without the ring
  constexpr bool kWide = BPT >= 16;
  constexpr bool kRing = BPT <= 16;
  constexpr int kStages = kRing ? 2 : 1;
  constexpr int kEvBufs = kWide ? 1 : 2;
  constexpr unsigned kAll = BPT == 32 ? kFull : (1u << (BPT & 31)) - 1u;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // phase: begin
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int FL = p.FL, H = p.H, hb = p.hb, FB = p.block_bins;
  const int C = kClu ? p.clusters : 1;
  const int NC = kGrid ? p.blocks / p.clusters : 1;
  const int rank = kClu ? cluster_rank() : 0;
  const int gb = blockIdx.x;  // the block across the grid
  const int cluster = gb / C;
  const float thr = p.thr;
  const bool whole = mode == kModeWhole, is_a = mode == kModeA,
             is_b = mode == kModeB;
  const Scratch sx = scratch_of(st.scratch, p);
  // a grid's last blocks may hold no bin (`plan` balances the blocks)
  const int lo_bin = gb * FB, hi_bin = max(min(lo_bin + FB, FL), lo_bin);
  const int RW = (FB + 7) & ~3;  // a ring stage's words: mis <= 3 more

  // shared memory: the headers (2 x 32), the frame results (2), the seam,
  // the tally, the mbarriers, then the ring, the evicted row, the flag
  // words (2 x T) and, off the wide path, a_last and a_start ([i T + tid])
  Hdr* s_hdr = reinterpret_cast<Hdr*>(smem_raw);
  Frame* s_fr = reinterpret_cast<Frame*>(s_hdr + 64);
  Seam* s_seam = reinterpret_cast<Seam*>(s_fr + 2);
  Tally* s_tally = reinterpret_cast<Tally*>(s_seam + 1);
  unsigned long long* s_bar =
      reinterpret_cast<unsigned long long*>(s_tally + 1);
  float* s_ring = reinterpret_cast<float*>(s_bar + 4);
  // kEvBufs x T BPT
  float* s_evs = s_ring + (kRing ? (size_t)kStages * RW : 0);
  unsigned* s_flag =
      reinterpret_cast<unsigned*>(s_evs + (size_t)kEvBufs * T * BPT);
  int* s_last = reinterpret_cast<int*>(s_flag + 2 * T);
  int* s_start = s_last + (kWide ? 0 : T * BPT);

  const int b0 = lo_bin + tid * BPT;  // the thread's first local bin
  const bool live = b0 < hi_bin;
  const int l0 = tid * BPT;           // its first word in a block row
  const int n_in = live ? min(BPT, hi_bin - b0) : 0;
  const unsigned inb = n_in >= BPT ? kAll : (1u << n_in) - 1u;
  const bool has_l = live && b0 > 0, has_r = live && b0 + BPT < FL;
  // the threads whose halo bin is another block's
  const bool edge_l = has_l && b0 == lo_bin;
  const bool edge_r = has_r && b0 + BPT >= hi_bin;
  // a_last and a_start in shared memory for one launch off the wide path,
  // else in device memory (the split's launches read a few of them)
  const bool on_chip = !kWide && whole;
  auto last_of = [&](int i) -> int& {
    return on_chip ? s_last[i * T + tid] : st.a_last[b0 + i];
  };
  auto start_of = [&](int i) -> int& {
    return on_chip ? s_start[i * T + tid] : st.a_start[b0 + i];
  };

  // ---- the rows: thread 0's bulk copies into the ring ----
  // |X|^2 word k of the block's row of `f` is at stage[mis_of(f) + k]
  auto mis_of = [&](int f) {
    return (int)(((uintptr_t)(st.mag2 + (size_t)f * FL + lo_bin) >> 2) &
                 3u);
  };
  auto load_row = [&](int f, int s) {
    const int mis = mis_of(f);
    const unsigned bytes = (unsigned)((mis + hi_bin - lo_bin + 3) & ~3) * 4u;
    const uint32_t bar = smem(s_bar + s);
    if (hi_bin == lo_bin) {
      // a block without bins: the stage's phase completes at once
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
      return;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem(s_ring + (size_t)s * RW)),
        "l"(st.mag2 + (size_t)f * FL + lo_bin - mis), "r"(bytes), "r"(bar)
        : "memory");
  };

  // the halo |X|^2 words of frame f (the edge threads': another block's,
  // read from device memory)
  auto x_left = [&](const float* row, int f) {
    return edge_l ? __ldg(st.mag2 + (size_t)f * FL + b0 - 1) : row[l0 - 1];
  };
  auto x_right = [&](const float* row, int f) {
    return edge_r ? __ldg(st.mag2 + (size_t)f * FL + b0 + BPT)
                  : row[l0 + BPT];
  };

  // ---- the history: each thread's own words ----
  // the row the next update evicts, into the evicted-row buffer `evb`
  // (the thread's words; off the wide path the buffers alternate by
  // update, so that a thread reads its neighbours' words of one while they
  // load the other), and in one launch the halo words the buffer does not
  // give into registers
  float ev_l = 0.0f, ev_r = 0.0f;
  int evb = 0;
  auto s_ev = [&]() { return s_evs + (size_t)evb * T * BPT; };
  // the halo words a thread reads from the history: the block's edge
  // threads', and on the wide path every thread's
  const bool gl_l = edge_l || (kWide && has_l);
  const bool gl_r = edge_r || (kWide && has_r);
  auto load_ev = [&](int h) {
    if (live) {
      const float* src = st.hist + (size_t)h * FL + b0;
      float* dst = s_ev() + l0;
      if (BPT % 4 == 0 && n_in == BPT && ((uintptr_t)src & 15u) == 0) {
#pragma unroll
        for (int j = 0; j < BPT; j += 4)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem(dst + j)),
                       "l"(src + j)
                       : "memory");
      } else {
        for (int j = 0; j < n_in; ++j)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem(dst + j)),
                       "l"(src + j)
                       : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // the halo words from the history, read before the barrier that
    // orders their owner's next store of the row
    if (whole) {
      const float* row = st.hist + (size_t)h * FL;
      if (gl_l) ev_l = __ldcg(row + b0 - 1);
      if (gl_r) ev_r = __ldcg(row + b0 + BPT);
    }
  };
  auto wait_ev = [&]() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  // ---- the per-bin state, read once ----
  float bsum[BPT];
  unsigned valid = 0, unmasked = 0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) bsum[j] = 0.0f;
  get(bsum, st.bsum + b0, n_in);
  {
    int w[BPT];
    get(w, st.mask + b0, n_in);
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (j >= n_in) continue;
      if (st.a_valid[b0 + j]) valid |= 1u << j;
      if (w[j] == 0) unmasked |= 1u << j;
    }
    if (on_chip) {
      get(w, st.a_last + b0, n_in);
#pragma unroll
      for (int j = 0; j < BPT; ++j) last_of(j) = w[j];
      get(w, st.a_start + b0, n_in);
#pragma unroll
      for (int j = 0; j < BPT; ++j) start_of(j) = w[j];
    }
  }
  const unsigned valid0 = valid;
  bool updated = false;  // baseline_sum changed
  float bsum_l = has_l ? st.bsum[b0 - 1] : 0.0f;
  float bsum_r = has_r ? st.bsum[b0 + BPT] : 0.0f;

  // ---- the scalar chain ----
  Scalars sc;
  if (whole || (is_a && frame == 0)) {
    sc.hidx = st.sc[0];
    sc.prim = st.sc[1];
    sc.burst_id = (unsigned)st.sc[2];
    sc.sq_count = st.sc[3];
    sc.n_tagged = (unsigned)st.sc[4];
    sc.dropped = (unsigned)st.sc[5];
    sc.waits = (unsigned)st.sc[6];
    sc.g_run = 0;
    sc.peak = st.scf[0];
    sc.pad = 0;
  } else {
    sc = sx.slot[frame & 1];
  }
  if (tid == 0) {
    *s_tally = Tally{sc.n_tagged, sc.dropped, sc.waits, sc.peak};
    if (gb == 0 && !whole) {
      if (is_a && frame == 0) sx.slot[0] = sc;
      // the other launch kind's counter, for its next launch
      sx.count[(is_a ? 1 : 0) * kLineWords] = 0u;
    }
  }
  unsigned* count = sx.count + (is_b ? kLineWords : 0);
  unsigned gen = 0;  // grid barriers passed (warp 0 counts)
  int hidx = sc.hidx, prim = sc.prim, sq_count = sc.sq_count;
  int g_run = sc.g_run;
  unsigned burst_id = sc.burst_id;

  // the frames this launch walks, and the first's ring stage
  const int f_lo = whole ? 0 : frame, f_hi = whole ? p.n_act : frame + 1;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem(s_bar + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (kRing)
      for (int f = f_lo; f < f_hi && f < f_lo + kStages; ++f)
        load_row(f, (f - f_lo) % kStages);
  }
  if (!is_a) load_ev(hidx);
  // no thread waits on an mbarrier before thread 0 has made it
  __syncthreads();

  // ---- the reduction ----
  // bins the thread owns, and those a burst may start at (away from the
  // band edges and the DC notch): computed where needed, not kept
  auto own_bits = [&]() {
    unsigned o = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int g = p.bin_lo + b0 + j;
      if (j < n_in && g >= p.own_lo && g < p.own_hi) o |= 1u << j;
    }
    return o;
  };
  auto elig_bits = [&]() {
    const int dc = p.F / 2;
    unsigned e = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int g = p.bin_lo + b0 + j;
      if (j < n_in && g >= hb && g < p.F - hb && !(g >= dc - 3 && g <= dc + 3))
        e |= 1u << j;
    }
    return e;
  };
  // the thread's largest segment maximum below `below` (0: none left);
  // `cand`: its candidate bins of `row`. A segment wider than BPT spans
  // seg / BPT lanes (every lane takes part)
  auto seg_below = [&](unsigned cand, const float* row,
                       unsigned long long below) {
    unsigned long long best = 0ull, cur = 0ull;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if ((cand >> j) & 1u) {
        const unsigned long long k = cand_key(
            rel_of(row[l0 + j], bsum[j]), b0 + j, (valid >> j) & 1u);
        cur = k > cur ? k : cur;
      }
      if (p.seg <= BPT && ((j + 1) & (p.seg - 1)) == 0) {
        if (cur < below && cur > best) best = cur;
        cur = 0ull;
      }
    }
    if (p.seg > BPT) {
      const int w = p.seg / BPT;
      for (int o = 1; o < w; o <<= 1) {
        const unsigned long long t = __shfl_xor_sync(kFull, cur, o);
        cur = t > cur ? t : cur;
      }
      if ((lane & (w - 1)) == 0 && cur < below) best = cur;
    }
    return best;
  };
  // the greedy acceptance (detect_fast.py:349-361) of the K_TOP largest
  // keys `top` into s_seam (one thread): a candidate within half_bw of an
  // accepted one is skipped; the first k_create accepted are taken, the
  // rest retry next frame
  auto accept = [&](const unsigned long long* top, bool primed) {
    int n_acc = 0, n_accepted = 0, tv = 0;
    unsigned acc = 0;
    for (int j = 0; j < 2 * p.k_create; ++j) {
      const unsigned long long kj = top[j];
      if (kj == 0ull || !primed || !(key_val(kj) > thr)) continue;
      const int bj = key_bin(kj);
      bool a = true;
      for (int k = 0; k < j && a; ++k)
        if (((acc >> k) & 1u) && abs(bj - key_bin(top[k])) <= hb) a = false;
      if (!a) continue;
      acc |= 1u << j;
      if (n_accepted < p.k_create) {
        s_seam->take_bin[n_acc] = bj;
        s_seam->take_val[n_acc] = key_val(kj);
        if (kj & 1ull) tv |= 1 << n_acc;
        ++n_acc;
      }
      ++n_accepted;
    }
    s_seam->take_valid = tv;
    s_seam->n_acc = n_acc;
    s_seam->more = n_accepted > p.k_create;
  };
  // the kList largest keys of up to 16 descending, 0-ended lists a lane
  // (`n` lists, list t's key i at at(t, i)), merged over the warp into
  // `top` (lane 0 writes; 0-padded): one warp max a key
  auto merge = [&](int n, auto at, unsigned long long* top) {
    unsigned long long idx = 0ull;  // 4 bits a list: its next key
    for (int r = 0; r < kList; ++r) {
      unsigned long long best = 0ull;
      int bt = 0;
      for (int t = 0; t < n; ++t) {
        const unsigned i = (unsigned)(idx >> (4 * t)) & 15u;
        if (i < kList) {
          const unsigned long long k = at(t, (int)i);
          if (k > best) {
            best = k;
            bt = t;
          }
        }
      }
      const unsigned long long m = warp_max64(best);
      if (lane == 0) top[r] = m;
      if (m == 0ull) {
        if (lane == 0)
          for (int q = r + 1; q < kList; ++q) top[q] = 0ull;
        break;
      }
      if (best == m) idx += 1ull << (4 * bt);
    }
  };

  // One reduction over the block, cluster or grid (see the file's header)
  // of per-thread (cnt, cnt2, bits) and, where `cand` has bits, the
  // thread's segment maxima of `row`. Returns the totals in every thread,
  // bits 4 if there are keys (then s_seam holds the frame's acceptance),
  // and `excl`, the thread's exclusive prefix of cnt in bin order, when
  // the total is not 0.
  int red_par = 0;
  struct Red {
    int n, cnt2, bits, excl;
  };
  auto reduce = [&](int cnt, int cnt2, int bits, unsigned cand,
                    const float* row, bool primed) -> Red {
    const int par = red_par;
    red_par ^= 1;
    Hdr* hd = s_hdr + 32 * par;
    Frame* fr = s_fr + par;
    int incl = 0;
    if (__any_sync(kFull, cnt != 0 || cnt2 != 0 || bits != 0 || cand != 0u)) {
      incl = warp_incl_scan(cnt);
      cnt2 = warp_sum(cnt2);
      bits = (int)__reduce_or_sync(kFull, (unsigned)bits);
      if (__any_sync(kFull, cand != 0u)) {
        // the warp's segment maxima, largest first
        bits |= 4;
        unsigned long long below = ~0ull;
        for (int r = 0; r < kList; ++r) {
          const unsigned long long k = warp_max64(seg_below(cand, row, below));
          if (lane == 0) hd[warp].keys[r] = k;
          if (k == 0ull) break;
          below = k;
        }
      }
    } else {
      cnt2 = 0;
      bits = 0;
    }
    if (lane == 31) hd[warp].cnt = incl;
    if (lane == 0) {
      hd[warp].cnt2 = cnt2;
      hd[warp].bits = bits;
    }
    Red o{0, 0, 0, 0};
    // a warp's header: [cnt, cnt2, bits, 0]
    auto head = [&](const Hdr* h) {
      return *reinterpret_cast<const int4*>(h);
    };
    if constexpr (!kClu) {
      __syncthreads();
      // every warp reads the block's headers (lane l: warp l's)
      const int4 e = lane < nw ? head(hd + lane) : make_int4(0, 0, 0, 0);
      if (__any_sync(kFull, e.x != 0 || e.y != 0 || e.z != 0)) {
        const int wi = warp_incl_scan(e.x);
        o.n = __shfl_sync(kFull, wi, 31);
        o.excl = __shfl_sync(kFull, wi - e.x, warp) + incl - cnt;
        o.cnt2 = warp_sum(e.y);
        o.bits = (int)__reduce_or_sync(kFull, (unsigned)e.z);
      }
      if (o.bits & 4) {
        // warp 0 merges the warps' keys and walks the acceptance
        if (warp == 0) {
          const bool has = lane < nw && (e.z & 4);
          merge(has ? 1 : 0,
                [&](int, int i) { return hd[lane].keys[i]; }, fr->keys);
          __syncwarp();
          if (lane == 0) accept(fr->keys, primed);
        }
        __syncthreads();
      }
      return o;
    } else {
      cluster_sync();
      if (warp == 0) {
        // lane l reads warp l's header of every block of the cluster
        int all = 0, lo = 0, c2 = 0, bt = 0;
        unsigned has = 0;  // the blocks whose warp l has keys
        if (lane < nw) {
          for (int q = 0; q < C; ++q) {
            const int4 e = head(peer(hd, q) + lane);
            all += e.x;
            if (q < rank) lo += e.x;
            c2 += e.y;
            bt |= e.z;
            if (e.z & 4) has |= 1u << q;
          }
        }
        all = warp_sum(all);
        lo = warp_sum(lo);
        c2 = warp_sum(c2);
        bt = (int)__reduce_or_sync(kFull, (unsigned)bt);
        if (bt & 4) {
          // the lane's lists: warp l's of the blocks in `has`
          merge(C, [&](int t, int i) {
            return (has >> t) & 1u ? peer(hd, t)[lane].keys[i] : 0ull;
          }, fr->keys);
          __syncwarp();
        }
        if constexpr (kGrid) {
          // the cluster's result meets the others' in device memory: lane
          // q reads cluster q's slot of this barrier's parity (L2 loads)
          Frame* slots = sx.slots + (gen & 1u) * NC;
          if (rank == 0 && lane == 0) {
            Frame* mine = slots + cluster;
            mine->n_del = all;
            mine->cnt2 = c2;
            mine->bits = bt;
            if (bt & 4)
              for (int r = 0; r < kList; ++r) mine->keys[r] = fr->keys[r];
            red_release(count, 1u);
          }
          ++gen;
          {
            const unsigned want = gen * (unsigned)NC;
            const long long t0 = clock64();
            while (ld_acquire(count) < want) {
              // a cluster that never arrives fails the launch instead of
              // hanging the card
              if (clock64() - t0 > kSpinCycles) __trap();
            }
          }
          int gall = 0, glo = 0, gc2 = 0, gbt = 0;
          unsigned ghas = 0;  // lane's slots (t: cluster lane + 32 t) with keys
          for (int t = 0, q = lane; q < NC; ++t, q += 32) {
            const int4 e = __ldcg(reinterpret_cast<const int4*>(slots + q));
            gall += e.x;
            if (q < cluster) glo += e.x;
            gc2 += e.y;
            gbt |= e.z;
            if (e.z & 4) ghas |= 1u << t;
          }
          all = warp_sum(gall);
          lo += warp_sum(glo);
          c2 = warp_sum(gc2);
          bt = (int)__reduce_or_sync(kFull, (unsigned)gbt);
          if (bt & 4) {
            merge((NC + 31) / 32, [&](int t, int i) {
              return (ghas >> t) & 1u ? __ldcg(&slots[lane + 32 * t].keys[i])
                                      : 0ull;
            }, fr->keys);
            __syncwarp();
          }
        }
        if (lane == 0) {
          fr->n_del = all;
          fr->cnt2 = c2;
          fr->bits = bt;
          fr->lo = lo;
          if (bt & 4) accept(fr->keys, primed);
        }
      }
      __syncthreads();
      const int4 e = head(reinterpret_cast<const Hdr*>(fr));
      o.n = e.x;
      o.cnt2 = e.y;
      o.bits = e.z;
      if (o.n != 0) {
        // the lower warps of this block, in order
        const int c = lane < nw ? hd[lane].cnt : 0;
        const int wi = warp_incl_scan(c);
        o.excl = e.w + __shfl_sync(kFull, wi - c, warp) + incl - cnt;
      }
      return o;
    }
  };
  // every thread of every block of the launch: the block's barrier, the
  // cluster's, and a grid's arrival counter besides
  auto all_sync = [&]() {
    if constexpr (!kClu) {
      __syncthreads();
    } else {
      cluster_sync();
      if constexpr (kGrid) {
        if (warp == 0) {
          if (rank == 0 && lane == 0) red_release(count, 1u);
          ++gen;
          const unsigned want = gen * (unsigned)NC;
          const long long t0 = clock64();
          while (ld_acquire(count) < want)
            if (clock64() - t0 > kSpinCycles) __trap();
        }
        __syncthreads();
      }
    }
  };

  // the owned active count, kept as a scalar by one launch
  int n_own = 0;
  if (whole)
    n_own = reduce(0, __popc(valid & own_bits()), 0, 0u, nullptr, false).cnt2;

  // the frame's rows of the gone table for the bins set in `bits` (bit j:
  // the thread's bin j), ranked from `r` in ascending bin order: row rank
  // r goes to base + r while r < cap and base + r < G
  auto emit_rows = [&](unsigned bits, int r, int cap, int base, int idx) {
    for (; bits; bits &= bits - 1, ++r) {
      const int j = __ffs(bits) - 1, i = b0 + j, pos = base + r;
      if (r >= cap || pos >= p.G) break;
      st.g_id[pos] = st.a_id[i];
      st.g_start[pos] = start_of(j);
      st.g_stop[pos] = idx;
      st.g_last[pos] = last_of(j);
      st.g_bin[pos] = p.bin_lo + i;
      st.g_mag[pos] = st.a_mag[i];
      st.g_noise[pos] = st.a_noise[i];
    }
  };

  // a noise update with the frame's row (burst_detect.c:438-454; the order
  // (sum - evicted) + mag is kept): the thread's words of the evicted row
  // (s_ev), its frame words stored into the history row, then the next
  // evicted row's words loaded. x - 0.0f is x in IEEE arithmetic, so an
  // ungated update is a plain add (gate is alike in every thread).
  auto noise_update = [&](const float* row, int f) {
    const bool gate = prim >= H;
    wait_ev();
    const float* sev = s_ev();
    float* dst = st.hist + (size_t)hidx * FL + b0;
    const bool rv = ((uintptr_t)(row + l0) & 15u) == 0;
    const bool hv = n_in == BPT && ((uintptr_t)dst & 15u) == 0;
    constexpr int G = BPT < 4 ? BPT : 4;
#pragma unroll
    for (int q = 0; q < BPT / G; ++q) {
      float m[4], ev[4];
      get4<BPT>(m, row + l0, q, rv);
      get4<BPT>(ev, sev + l0, q, true);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        float& b = bsum[G * q + k];
        b = gate ? (b - ev[k]) + m[k] : b + m[k];
      }
      put4<BPT>(dst, m, q, hv, n_in);
    }
    if (whole) {
      if (has_l) {
        const float x = x_left(row, f), e = gl_l ? ev_l : sev[l0 - 1];
        bsum_l = gate ? (bsum_l - e) + x : bsum_l + x;
      }
      if (has_r) {
        const float x = x_right(row, f), e = gl_r ? ev_r : sev[l0 + BPT];
        bsum_r = gate ? (bsum_r - e) + x : bsum_r + x;
      }
    }
    prim = min(prim + 1, H);
    hidx = next_slot(hidx, H);
    updated = true;
    evb = (evb + 1) % kEvBufs;
    load_ev(hidx);
  };

  for (int f = f_lo; f < f_hi; ++f) {
    // phase: load
    const int idx = f * p.F;
    const int s = (f - f_lo) % kStages;
    if (kRing) mbar_wait(smem(s_bar + s), ((f - f_lo) / kStages) & 1);
    // phase: track
    const float* row = kRing ? s_ring + (size_t)s * RW + mis_of(f)
                             : st.mag2 + (size_t)f * FL + lo_bin;
    const bool primed = prim >= H;

    // ---- phase A (a launch B reloads its results) ----
    unsigned ab = 0, flag = 0, emit = 0;
    Red r{0, 0, 0, 0};
    if (!is_b) {
      // above threshold: a branch-free filter over all bins, then the
      // exact test only for the few bins that pass it
      unsigned maybe = 0;
      {
        constexpr int G = BPT < 4 ? BPT : 4;
        const bool rv = ((uintptr_t)(row + l0) & 15u) == 0;
#pragma unroll
        for (int q = 0; q < BPT / G; ++q) {
          float m[4];
          get4<BPT>(m, row + l0, q, rv);
#pragma unroll
          for (int k = 0; k < G; ++k)
            maybe |= (unsigned)maybe_above(m[k], bsum[G * q + k], thr)
                     << (G * q + k);
        }
        maybe &= inb;
        if (maybe) {
#pragma unroll
          for (int j = 0; j < BPT; ++j)
            if (((maybe >> j) & 1u) && rel_of(row[l0 + j], bsum[j]) > thr)
              ab |= 1u << j;
        }
      }
      // extend last_active on the +-1-bin dilation (burst_detect.c:458-
      // 469); gone bursts (:490-518)
      bool longb = false;
      if (valid) {
        const bool al = has_l && above(x_left(row, f), bsum_l, thr);
        const bool ar = has_r && above(x_right(row, f), bsum_r, thr);
        const unsigned dil = ab | (ab << 1) | (ab >> 1) | (al ? 1u : 0u) |
                             (ar ? 1u << (BPT - 1) : 0u);
        for (unsigned v = valid; v; v &= v - 1) {
          const int j = __ffs(v) - 1;
          int last = last_of(j);
          if (primed && ((dil >> j) & 1u)) {
            last = idx;
            last_of(j) = idx;
          }
          const bool lng =
              (int)((unsigned)last - (unsigned)start_of(j)) > p.max_burst_len;
          const bool gone =
              (int)((unsigned)last + (unsigned)p.post_len) <= idx || lng;
          longb |= lng;
          if (gone && primed) flag |= 1u << j;
        }
      }
      emit = flag ? flag & own_bits() : 0u;
      valid &= ~flag;
      // the flag words of this frame's parity: the block's in shared
      // memory, and in device memory for the other blocks and launch B
      s_flag[(f & 1) * T + tid] = flag;
      if (!whole || kClu)
        sx.flags[(size_t)(f & 1) * p.blocks * T + (size_t)gb * T + tid] =
            flag;
      // candidates: peaks under the carried mask; the reduction takes
      // each segment's largest key, and warp 0 walks the acceptance
      const unsigned cand = primed && ab ? ab & unmasked & elig_bits() : 0u;
      // the evicted row's words are in (the neighbours read them after
      // the barrier)
      if (whole) wait_ev();
      // phase: reduce
      r = reduce(__popc(emit), is_a ? __popc(valid & own_bits()) : 0,
                 (flag ? 1 : 0) | (longb ? 2 : 0), cand, row, primed);
      // every thread is past frame f - 1: refill its stage with frame f - 1
      // + kStages
      if (kRing && tid == 0 && f > f_lo && f - 1 + kStages < f_hi)
        load_row(f - 1 + kStages, (f - 1 - f_lo) % kStages);
    }

    // phase: seam
    // ---- the coupling seam ----
    int n_acc = 0, more = 0, n_del = 0, rbits = 0, excl = 0;
    long long any_long = 0, n_active = 0;
    if (!is_b) {
      const bool keys = r.bits & 4;
      n_acc = keys ? s_seam->n_acc : 0;
      more = keys ? s_seam->more : 0;
      n_del = r.n;
      rbits = r.bits;
      excl = r.excl;
      // the owned active count after the creations: the active bins, and
      // the taken bins that were not
      int n_post = is_a ? r.cnt2 : n_own - n_del;
      for (int k = 0; k < n_acc; ++k) {
        const int tb = s_seam->take_bin[k], g = p.bin_lo + tb;
        if (!((s_seam->take_valid >> k) & 1) && g >= p.own_lo &&
            g < p.own_hi)
          ++n_post;
      }
      any_long = (rbits >> 1) & 1;
      n_active = n_post;
      if (is_a) {
        // launch A ends here: what launch B needs, and the state it
        // changed (the file's header)
        sx.rank[(size_t)gb * T + tid] = excl;
        if (gb == 0 && tid == 0) {
          Seam sm = *s_seam;
          sm.n_acc = n_acc;
          sm.more = more;
          sm.n_del = n_del;
          sm.bits = rbits;
          sm.n_post = n_post;
          *sx.seam = sm;
          sx.pair[0] = any_long;
          sx.pair[1] = n_post;
        }
        break;
      }
      // `couple`: binshard's all_reduce goes here; the one launch's range
      // is every range
    } else {
      // launch B: the seam and the summed pair, as launch A and the
      // caller left them
      const Seam& sm = *sx.seam;
      if (tid < kSeamWords)
        reinterpret_cast<int*>(s_seam)[tid] =
            reinterpret_cast<const int*>(&sm)[tid];
      n_acc = sm.n_acc;
      more = sm.more;
      n_del = sm.n_del;
      rbits = sm.bits;
      any_long = sx.pair[0];
      n_active = sx.pair[1];
      flag = sx.flags[(size_t)(f & 1) * p.blocks * T + (size_t)gb * T + tid];
      emit = flag ? flag & own_bits() : 0u;
      excl = sx.rank[(size_t)gb * T + tid];
      __syncthreads();
    }
    const bool force = any_long > 0 && primed;
    const bool squelch =
        p.max_bursts > 0 && primed && n_active > p.max_bursts;
    const bool do1_pre = (squelch ? 0 : n_active) == 0;

    // ---- phase B ----
    // the deletion rows, before a creation can overwrite the bin's burst
    if (n_del > 0) emit_rows(emit, excl, kEDel, g_run, idx);
    const int n_del_rows = min(n_del, kEDel);

    // creations (burst_detect.c:556-632): each from its bin's sum before
    // the forced noise update, with that update applied in the twin's
    // float order (detect_fast.py:385-401)
    unsigned crt = 0;
    const float live_g = prim >= H ? 1.0f : 0.0f;
    const int start = (int)((unsigned)idx - (unsigned)p.pre_len);
    for (int k = 0; k < n_acc; ++k) {
      const int i = s_seam->take_bin[k];
      const float mag_db = 10.0f * log10f(fmaxf(
                               s_seam->take_val[k] * p.hist_f * p.enbw,
                               1e-30f));
      if (tid == 0) s_tally->peak = fmaxf(s_tally->peak, mag_db);
      if ((unsigned)(i - b0) < (unsigned)n_in) {
        const int j = i - b0;
        float base_at = 0.0f, m = 0.0f;
#pragma unroll
        for (int q = 0; q < BPT; ++q)
          if (q == j) base_at = bsum[q];
        m = row[l0 + j];
        if (force) {
          wait_ev();
          base_at = (base_at - s_ev()[l0 + j] * live_g) + m;
        }
        // the twin divides by Python scalars, which PyTorch's CUDA division
        // computes as a product with the scalar's f32 reciprocal
        const float noise_db = 10.0f * log10f(fmaxf(
            base_at * (1.0f / p.hist_f) * (1.0f / p.f2) * (1.0f / p.enbw) *
                (1.0f / p.bin_width),
            1e-30f));
        st.a_id[i] =
            (int)(burst_id + 10u * (unsigned)p.id_stride * (unsigned)k);
        start_of(j) = start;
        last_of(j) = start;
        st.a_mag[i] = mag_db;
        st.a_noise[i] = noise_db;
        valid |= 1u << j;
        crt |= 1u << j;
      }
    }

    // the forced noise update (a long-burst deletion, burst_detect.c:516);
    // a final update in the same frame waits for every thread to have read
    // its halo words of the row this one makes the next to evict
    if (force) {
      noise_update(row, f);
      if (whole && do1_pre) {
        wait_ev();
        all_sync();
      }
    }

    // one mask update: the creations added, the deletions released
    if (!squelch && (n_acc > 0 || (rbits & 1))) {
      const unsigned* wl = s_flag + (f & 1) * T;
      const unsigned* wg = sx.flags + (size_t)(f & 1) * p.blocks * T;
      // deleted bins within +-half_bw of local bin i, clipped at the
      // range's edges, from the flag words (bit j of word w: bin w BPT + j)
      auto released = [&](int i) {
        const int lo = max(i - hb, 0), hi = min(i + hb, FL - 1);
        int n = 0;
        for (int w = lo / BPT; w <= hi / BPT; ++w) {
          const int a = max(lo - w * BPT, 0), b = min(hi - w * BPT, BPT - 1);
          const unsigned msk =
              (b == 31 ? kFull : ((2u << b) - 1u)) & ~((1u << a) - 1u);
          const int wb = w - gb * T;  // this block's word, where it is
          const unsigned word =
              whole && wb >= 0 && wb < T ? wl[wb] : __ldcg(wg + w);
          n += __popc(word & msk);
        }
        return n;
      };
#pragma unroll
      for (int j = 0; j < BPT; ++j) {
        if (j >= n_in) continue;
        const int i = b0 + j;
        int d = 0;
        for (int k = 0; k < n_acc; ++k)
          if (abs(i - s_seam->take_bin[k]) <= hb) ++d;
        if (rbits & 1) d -= released(i);
        if (d != 0) {
          const int m = st.mask[i] + d;
          st.mask[i] = m;
          if (m == 0)
            unmasked |= 1u << j;
          else
            unmasked &= ~(1u << j);
        }
      }
    }
    burst_id += 10u * (unsigned)p.id_stride * (unsigned)n_acc;

    // squelch (burst_detect.c:594-631) on the coupled count: its rows (the
    // active owned bins the frame did not create at), then every burst and
    // the mask cleared
    int n_sq = 0;
    if (squelch) {
      const unsigned sq = valid & own_bits() & ~crt;
      const Red q = reduce(__popc(sq), 0, 0, 0u, nullptr, false);
      n_sq = q.n;
      if (n_sq > 0) emit_rows(sq, q.excl, kESq, g_run + n_del_rows, idx);
      valid = 0;
#pragma unroll
      for (int j = 0; j < BPT; ++j)
        if (((inb & ~unmasked) >> j) & 1u) st.mask[b0 + j] = 0;
      unmasked = inb;
    }
    if (tid == 0) {
      Tally& t = *s_tally;
      t.waits += (unsigned)more;
      t.n_tagged += (unsigned)(n_del + n_sq);
      t.dropped +=
          (unsigned)(max(n_del - kEDel, 0) + max(n_sq - kESq, 0));
    }
    g_run += n_del_rows + min(n_sq, kESq);
    sq_count = squelch ? sq_count + 3 : max(sq_count - 1, 0);

    // the noise reset after repeated squelch (the ring's slots continue),
    // then the final noise update when no burst is active (:698)
    if (sq_count >= 10) {
#pragma unroll
      for (int j = 0; j < BPT; ++j) bsum[j] = 0.0f;
      bsum_l = 0.0f;
      bsum_r = 0.0f;
      updated = true;
      prim = 0;
      sq_count = 0;
    }
    // phase: noise
    if (do1_pre) noise_update(row, f);
    if (whole) n_own = squelch ? 0 : (int)n_active;
  }

  // phase: end
  // ---- the end of the launch ----
  // the state written once: what the launch changed
  wait_ev();
  const unsigned changed = whole ? inb : valid ^ valid0;
  if (updated) put(st.bsum + b0, bsum, n_in);
#pragma unroll
  for (int j = 0; j < BPT; ++j)
    if ((changed >> j) & 1u) st.a_valid[b0 + j] = (valid >> j) & 1u;
  if (on_chip) {
    int w[BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) w[j] = last_of(j);
    put(st.a_last + b0, w, n_in);
#pragma unroll
    for (int j = 0; j < BPT; ++j) w[j] = start_of(j);
    put(st.a_start + b0, w, n_in);
  }
  if (gb == 0 && tid == 0 && !is_a) {
    const Tally& t = *s_tally;
    Scalars out;
    out.hidx = hidx;
    out.prim = prim;
    out.sq_count = sq_count;
    out.g_run = g_run;
    out.burst_id = burst_id;
    out.n_tagged = t.n_tagged;
    out.dropped = t.dropped;
    out.waits = t.waits;
    out.peak = t.peak;
    out.pad = 0;
    if (is_b) sx.slot[(frame + 1) & 1] = out;
    if (whole || frame == p.n_act - 1) {
      st.sc[0] = hidx;
      st.sc[1] = prim;
      st.sc[2] = (int)burst_id;
      st.sc[3] = sq_count;
      st.sc[4] = (int)t.n_tagged;
      st.sc[5] = (int)t.dropped;
      st.sc[6] = (int)t.waits;
      st.sc[7] = min(g_run, p.G);
      st.scf[0] = t.peak;
    }
  }
  // no block leaves while another may still read its shared memory
  if constexpr (kClu) cluster_sync();
}

// ---- the plan ----

// The dynamic shared memory of a block (the kernel's carving)
size_t shared_bytes(int FB, int T, int BPT) {
  const bool wide = BPT >= 16;
  const size_t stages = BPT <= 16 ? 2 : 0, ev_bufs = wide ? 1 : 2;
  const size_t RW = (size_t)((FB + 7) & ~3);
  return 64 * sizeof(Hdr) + 2 * sizeof(Frame) + sizeof(Seam) +
         sizeof(Tally) + 4 * sizeof(unsigned long long) +
         stages * RW * sizeof(float) +
         ev_bufs * (size_t)T * BPT * sizeof(float) +
         2 * (size_t)T * sizeof(unsigned) +
         (wide ? 0 : 2 * (size_t)T * BPT * sizeof(int));
}

// Whether the plan is one the kernel runs (dsp/detect_fast.py `plan`)
bool valid_plan(const Params& p) {
  const int T = p.threads, B = p.bpt, C = p.clusters;
  // every bin a thread's; the first cluster's blocks each hold bins (a
  // grid's last blocks may not)
  if (p.FL <= 0 || p.blocks < 1 || C < 1 || T < 32 || T > kMaxThreads ||
      T % 32 || p.block_bins != T * B ||
      (long long)p.blocks * p.block_bins < p.FL ||
      (long long)(C - 1) * p.block_bins >= p.FL)
    return false;
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return false;
  if (p.blocks % C) return false;
  if (C == 1) {
    if (p.blocks != 1 || (B != 1 && B != 2 && B != 4 && B != 8))
      return false;
  } else if (B != 8 && B != 16 && !(B == 32 && C == 2 && p.blocks > C)) {
    // 32 bins a thread only in a grid of clusters of 2
    return false;
  }
  if (p.block_bins >
      (B == 32 ? kDeepBins : B == 16 ? kWideBins : kRingBins))
    return false;
  if (shared_bytes(p.block_bins, T, B) > kMaxShared) return false;
  if (p.seg != 1 && p.seg != 4 && p.seg != 8 && p.seg != 16) return false;
  if (p.FL % p.seg || p.block_bins % p.seg) return false;
  if (p.k_create < 1 || p.k_create > kMaxCreate || p.H < 2 || p.G < 0 ||
      p.hb < 0 || p.n_act < 0 || p.id_stride < 1)
    return false;
  return p.n_act == 0 || (long long)(p.n_act - 1) * p.F <= INT_MAX;
}

// fn(kernel) for the plan's instantiation (valid_plan holds)
template <typename Fn>
cudaError_t dispatch(const Params& p, Fn&& fn) {
  if (p.clusters == 1) {
    switch (p.bpt) {
      case 1: return fn(detect_fast_kernel<1, false, false>);
      case 2: return fn(detect_fast_kernel<2, false, false>);
      case 4: return fn(detect_fast_kernel<4, false, false>);
      default: return fn(detect_fast_kernel<8, false, false>);
    }
  }
  if (p.blocks == p.clusters)
    return p.bpt == 8 ? fn(detect_fast_kernel<8, true, false>)
                      : fn(detect_fast_kernel<16, true, false>);
  switch (p.bpt) {
    case 8: return fn(detect_fast_kernel<8, true, true>);
    case 16: return fn(detect_fast_kernel<16, true, true>);
    default: return fn(detect_fast_kernel<32, true, true>);
  }
}

using KernelFn = void (*)(const State, const Params, int, int);

// Every instantiation's attributes: the most dynamic shared memory, and
// clusters above the portable 8 blocks; set once, before any launch or
// graph capture (`detect_fast_init`)
cudaError_t set_attributes(KernelFn kern, bool cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxShared);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// A plan of `blocks` blocks in clusters of `clusters`, `bpt` bins a
// thread: enough to pick an instantiation
Params shape(int blocks, int clusters, int bpt) {
  Params p{};
  p.blocks = blocks;
  p.clusters = clusters;
  p.bpt = bpt;
  return p;
}

cudaLaunchConfig_t launch_config(const Params& p, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, bool coop) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes(p.block_bins, p.threads, p.bpt);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (p.clusters > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.clusters;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  if (coop) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeCooperative;
    attr[cfg.numAttrs].val.cooperative = 1;
    ++cfg.numAttrs;
  }
  return cfg;
}

// How many clusters of the plan's blocks the card holds at once, asked
// once per (device, kernel, cluster, threads, shared memory) and kept
cudaError_t resident_clusters(KernelFn kern, const Params& p, int* fit) {
  struct Entry {
    KernelFn kern;
    int dev, clusters, threads;
    size_t smem;
    int fit;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t smem = shared_bytes(p.block_bins, p.threads, p.bpt);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.kern == kern && e.dev == dev && e.clusters == p.clusters &&
        e.threads == p.threads && e.smem == smem) {
      *fit = e.fit;
      return cudaSuccess;
    }
  }
  cudaLaunchAttribute attr[2];
  Params one = p;
  one.blocks = p.clusters;
  const cudaLaunchConfig_t cfg = launch_config(one, 0, attr, false);
  err = cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (n_cache < 64)
    cache[n_cache++] = Entry{kern, dev, p.clusters, p.threads, smem, *fit};
  return cudaSuccess;
}

// A block's arguments, as `detect_fast_args` packs them for
// `detect_fast`: a launch then costs a call of four arguments
struct Packed {
  State st;
  Params p;
  bool split;  // the split's scratch (else the one launch's)
};
constexpr int kPackedBytes = 512;  // dsp/detect_fast.py PACKED_BYTES
static_assert(sizeof(Packed) <= kPackedBytes, "Packed layout");

}  // namespace

// Every instantiation's attributes, set when the library is loaded (before
// any graph capture)
extern "C" int detect_fast_init() {
  const Params ps[] = {shape(1, 1, 1), shape(1, 1, 2), shape(1, 1, 4),
                       shape(1, 1, 8), shape(2, 2, 8), shape(2, 2, 16),
                       shape(4, 2, 8), shape(4, 2, 16), shape(4, 2, 32)};
  for (const Params& p : ps) {
    const cudaError_t err = dispatch(p, [&](KernelFn k) {
      return set_attributes(k, p.clusters > 1);
    });
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One block of `n_frames` frames of FL local bins (global bins bin_lo +
// i; bursts centred outside [own_lo, own_hi) are tracked, not emitted),
// of which the first n_act run (dsp/detect_fast.py `active_frames`), on
// the output state's tensors (the wrapper's clone of the input state,
// gone table zeroed), checked and packed into `out` (`out_bytes` >=
// kPackedBytes) for `detect_fast`. `scratch`: `scratch_words` 32-bit
// words, zeroed: the one launch's (dsp/detect_fast.py
// `Plan.scratch_words`) or, with `split`, the split's (`Plan.split_words`).
// The plan: `blocks` blocks in clusters of `clusters`, of `threads`
// threads, `block_bins` = threads x `bins_per_thread` bins a block,
// segments of `seg` bins (1: every bin). A plan the kernel does not run, a
// scratch of another size, |X|^2 off a 16-byte boundary, or a grid of more
// clusters than the card holds at once
// (cudaErrorCooperativeLaunchTooLarge, 720) is refused before anything
// runs.
extern "C" int detect_fast_args(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf,
    unsigned* scratch, int F, int FL, int n_act, int H, int G, int half_bw,
    int k_create, int max_bursts, int max_burst_len, int post_len,
    int pre_len, int id_stride, int bin_lo, int own_lo, int own_hi,
    float threshold, float hist_f, float enbw, float f2, float bin_width,
    int blocks, int clusters, int block_bins, int threads,
    int bins_per_thread, int seg, long long scratch_words, int split,
    void* out, int out_bytes) {
  if (out_bytes < kPackedBytes) return (int)cudaErrorInvalidValue;
  Packed a;
  a.st = State{mag2,  hist,  bsum,   a_valid, a_id,    a_start, a_last,
               a_mag, a_noise, mask_count, g_id, g_start, g_stop, g_last,
               g_bin, g_mag, g_noise, sc, scf, scratch};
  a.p = Params{F,         FL,        n_act,      H,         G,
               half_bw,   k_create,  max_bursts, max_burst_len, post_len,
               pre_len,   id_stride, bin_lo,     own_lo,    own_hi,
               threshold, hist_f,    enbw,       f2,        bin_width,
               blocks,    clusters,  block_bins, threads,   bins_per_thread,
               seg};
  a.split = split != 0;
  if (!valid_plan(a.p) || ((uintptr_t)mag2 & 15u) ||
      scratch_words != (a.split ? split_words(a.p) : one_words(a.p)))
    return (int)cudaErrorInvalidValue;
  if (blocks > clusters) {
    // a grid spins at its barriers: every cluster resident at once
    int fit = 0;
    const cudaError_t err = dispatch(a.p, [&](KernelFn k) {
      return resident_clusters(k, a.p, &fit);
    });
    if (err != cudaSuccess) return (int)err;
    if (fit < blocks / clusters)
      return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  *static_cast<Packed*>(out) = a;
  return (int)cudaSuccess;
}

// A launch from `detect_fast_args`' packing: the whole block (`mode` 0,
// `frame` 0; a one-launch packing), or launch A (1) or B (2) of frame
// `frame` < n_act of the split (the file's header; a split packing).
// Anything else is refused (cudaErrorInvalidValue) before anything runs.
extern "C" int detect_fast(const void* args, int mode, int frame,
                           cudaStream_t stream) {
  const Packed& a = *static_cast<const Packed*>(args);
  const bool ok =
      a.split ? (mode == kModeA || mode == kModeB) && frame >= 0 &&
                    frame < a.p.n_act
              : mode == kModeWhole && frame == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(a.p, stream, attr, a.p.blocks > a.p.clusters);
  const cudaError_t err = dispatch(a.p, [&](KernelFn k) {
    return cudaLaunchKernelEx(&cfg, k, a.st, a.p, mode, frame);
  });
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* detect_fast_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
