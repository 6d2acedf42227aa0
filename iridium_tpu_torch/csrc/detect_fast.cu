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
// bytes: 134 MB for a 1,024 x 32,768 block, 40 us at 3.35 TB/s) and the
// state is read and written once; but frame f + 1 depends on the state
// frame f leaves, and every frame couples all bins twice (the creation
// candidates and the active count are band-wide), so the frames run one
// after another and the time goes to each frame's barriers and chain of
// dependent steps, not to bytes.
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
// entry refuses any other): `blocks` blocks of `threads` threads, thread
// t of block b owning the BPT contiguous local bins from (b T + t) BPT
// (bins past FL idle), one block up to 8,192 bins, else a cooperative
// grid of 1024-thread blocks (at most one an SM). A frame has two
// barriers: the block's __syncthreads, and in a grid an arrival counter
// in device memory besides (red.release / ld.acquire at gpu scope; a wait
// over ~17 s traps instead of hanging the card). Every branch around a
// barrier depends only on values every block computes alike.
//   - phase A: each thread walks its bins; a candidate is a 64-bit key
//     (bits of relm, then the bin reversed, then the bin's active flag
//     after deletion; keys are unique), each segment's largest key goes
//     into the thread's sorted list of 8; the warp merges its lanes'
//     lists, the block its warps', and publishes its 8 keys with its
//     counts (owned deletions, all deletions, owned active bins, any
//     long burst) in its `Partial`; each thread writes its deletion flags
//     as one word (bit j: its bin j);
//   - barrier 1; the seam: warp 0 of every block merges every block's 8
//     keys into the same 8 (exact: the keys are unique), walks the greedy
//     acceptance, and sums the counts: the coupling pair, and for its own
//     block the emission ranks of the lower blocks (the exclusive prefix
//     of their owned deletions, and of their owned active bins that the
//     squelch would emit, which the taken candidates' flags give);
//     binshard's all_reduce of the pair goes at this seam (`couple`: the
//     identity in the one launch, the cut in the split);
//   - phase B: each thread updates its own bins; a frame's rows go
//     straight into the gone table at the running count (ascending bin:
//     block prefix, then a block scan of the threads' counts); the mask
//     release counts the flag bits within +-half_bw (words of other
//     blocks read from L2), only in blocks that a deletion is near;
//   - barrier 2.
// The scalar chain (hist_idx, primed, burst_id, squelch_count, the
// counters, the peak, the gone count) is computed alike by every thread;
// thread 0 of block 0 writes it at the end. The state lives in the output
// state's tensors (the wrapper clones the input state and zeroes the gone
// table), the grid's meeting place in a scratch the wrapper zeroes per
// launch.
//
// The split (dsp/detect_fast.py `SplitScan`, binshard): frame f of the
// block is two launches of the same plan around the caller's all_reduce,
// on one stream, over one scratch the wrapper zeroes once a block:
//   - launch A (`detect_fast_a`): phase A, barrier 1 (in a grid the
//     cooperative grid barrier, whose arrival counter counts on across the
//     frames), the seam; each block stores its Seam in the scratch, and
//     thread 0 of block 0 the frame's pair [any_long, n_own_post] as two
//     int64 (every block computes the same pair);
//   - the caller sums the pair over the bin ranges in place (`all_reduce`;
//     one range: leaves it);
//   - launch B (`detect_fast_b`): each block loads its Seam, reads the
//     summed pair where `couple` sits in the one launch, forms force and
//     squelch from it, and runs phase B. The end of B is the frame's
//     barrier 2.
// The seam runs in A after a grid barrier, not in a one-warp launch of its
// own with B recomputing every block's Seam from the Partials: that is a
// third launch a frame on the host's path between the all_reduce and B,
// where this takes a store and a load of 23 words a block. Binshard's
// ranges are one block at every width but 10 MHz at world size 1 (8,258
// bins), so the grid barrier runs on that shape alone.
// What a launch does not carry to the next, and how the split handles it:
//   - the scalar chain: in the one launch every thread reads it once
//     before frame 0 and block 0 writes it after the last frame, and each
//     frame's barriers keep that safe. Across launches a block of B that
//     starts after block 0 has finished would read scalars block 0 had
//     already advanced. So `Scalars` cross frames in two slots of the
//     scratch: frame f's launches read slot f % 2 (A of frame 0 reads the
//     state's scalars and block 0 stores them in slot 0), and block 0 of B
//     writes slot (f + 1) % 2, which no block of frame f reads; B of the
//     last frame writes the state's scalars, which only A of frame 0 read;
//   - a thread's deletion bits for the emissions (phase A's `emit_bits`, a
//     register): B recomputes them from its flag word and the ownership of
//     its bins;
//   - the Partials and flag words: A of frame f + 1 rewrites what B of
//     frame f reads (the flag words; A's seam read the Partials), and
//     launch order on the stream alone keeps it from starting before B of
//     frame f has ended. The same holds for the Seams and the pair.
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
constexpr int kLineWords = 32;     // the arrival counter's line
constexpr int kPartialWords = 20;  // sizeof(Partial) / 4
constexpr int kPairWords = 4;      // the split's pair: two int64
constexpr int kScalarWords = 9;    // sizeof(Scalars) / 4
constexpr int kSeamWords = 23;     // sizeof(Seam) / 4
// `detect_fast`'s modes: the whole block in one launch; launch A or B of
// one frame of the split
constexpr int kModeWhole = 0, kModeA = 1, kModeB = 2;
constexpr unsigned kFull = 0xffffffffu;
// a grid barrier's longest wait, ~17 s at the H100's 1.98 GHz: far above
// any frame's, and a fault instead of a hang where a block never arrives
constexpr long long kSpinCycles = 1ll << 35;

struct Params {
  int F, FL, n_act, H, G, hb, k_create, max_bursts, max_burst_len, post_len,
      pre_len, id_stride, bin_lo, own_lo, own_hi;
  float thr, hist_f, enbw, f2, bin_width;
  int blocks, block_bins, threads, bpt, seg;
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
  unsigned* scratch;  // [line | Partial x blocks | flag word x threads],
                      // the split's after it (`split_of`)
};

// A block's share of a frame, published for the seam
struct Partial {
  unsigned long long keys[kList];  // its largest candidate keys,
                                   // descending, 0-padded
  int n_emit;       // owned bins deleted
  int n_flags;      // bins deleted, owned or not (mask releases)
  int n_own_valid;  // owned bins active after the deletions
  int any_long;     // a long burst among its bins
};
static_assert(sizeof(Partial) == 4 * kPartialWords, "Partial layout");

// The frame's seam, as warp 0 leaves it for its block
struct Seam {
  int take_bin[kMaxCreate];  // the taken candidates, in acceptance order
  float take_val[kMaxCreate];
  int take_valid[kMaxCreate];  // the bin was active after deletion
  int n_acc, more;
  int any_long, n_own_post;  // the coupling pair, this bin range's
  int my_emit, del_pre, n_del;  // this block's, the lower blocks', all
  int my_sq, sq_pre, n_sq;      // squelch rows, the same
  int flags_near;  // deletions within half_bw of this block's bins
};
static_assert(sizeof(Seam) == 4 * kSeamWords, "Seam layout");

struct Shared {
  unsigned long long wl[32][kList];  // each warp's keys
  int wc[32][4];                     // each warp's counts
  int scan[32];
  Seam seam;
};

// The scalar chain, alike in every thread
struct Scalars {
  int hidx, prim, sq_count, g_run;
  unsigned burst_id, n_tagged, dropped, waits;
  float peak;
};
static_assert(sizeof(Scalars) == 4 * kScalarWords, "Scalars layout");

// The scalars at the start of the block (the gone table starts empty)
__device__ __forceinline__ Scalars load_scalars(const State& st) {
  Scalars sc;
  sc.hidx = st.sc[0];
  sc.prim = st.sc[1];
  sc.burst_id = (unsigned)st.sc[2];
  sc.sq_count = st.sc[3];
  sc.n_tagged = (unsigned)st.sc[4];
  sc.dropped = (unsigned)st.sc[5];
  sc.waits = (unsigned)st.sc[6];
  sc.g_run = 0;
  sc.peak = st.scf[0];
  return sc;
}

// The state's scalars after the last frame (one thread)
__device__ __forceinline__ void store_scalars(const State& st,
                                              const Scalars& sc, int G) {
  st.sc[0] = sc.hidx;
  st.sc[1] = sc.prim;
  st.sc[2] = (int)sc.burst_id;
  st.sc[3] = sc.sq_count;
  st.sc[4] = (int)sc.n_tagged;
  st.sc[5] = (int)sc.dropped;
  st.sc[6] = (int)sc.waits;
  st.sc[7] = min(sc.g_run, G);
  st.scf[0] = sc.peak;
}

// Scratch words of the one launch: [line | Partial x blocks | flag word x
// thread]; the split's follow: [pair | Scalars x 2 | Seam x blocks]. The
// one launch's count is even (32 + 20 blocks + blocks x whole warps), so
// the pair's int64 are aligned.
__host__ __device__ __forceinline__ long long one_words(int blocks,
                                                        int threads) {
  return kLineWords + (long long)kPartialWords * blocks +
         (long long)blocks * threads;
}

__host__ __device__ __forceinline__ long long split_words(int blocks,
                                                          int threads) {
  return one_words(blocks, threads) + kPairWords + 2 * kScalarWords +
         (long long)kSeamWords * blocks;
}

// The split's part of the scratch
struct Split {
  long long* pair;  // [any_long, n_own_post]: this range's, then summed
  Scalars* slot;    // [2]: the scalars at the start of frame f in f % 2
  Seam* seams;      // [blocks]
};

__device__ __forceinline__ Split split_of(unsigned* scratch,
                                          const Params& p) {
  unsigned* base = scratch + one_words(p.blocks, p.threads);
  Split s;
  s.pair = reinterpret_cast<long long*>(base);
  s.slot = reinterpret_cast<Scalars*>(base + kPairWords);
  s.seams = reinterpret_cast<Seam*>(base + kPairWords + 2 * kScalarWords);
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

// Every thread of the launch: what any of them wrote before it is seen by
// any of them after it. One block: the block's barrier. A grid: thread 0
// arrives for its block (its release carries what the block barrier
// ordered before it) and waits until every block has arrived `gen` times.
__device__ __forceinline__ void all_sync(unsigned* count, int blocks,
                                         unsigned& gen) {
  __syncthreads();
  if (blocks > 1) {
    ++gen;
    if (threadIdx.x == 0) {
      __threadfence();
      red_release(count, 1u);
      const unsigned want = gen * (unsigned)blocks;
      const long long t0 = clock64();
      while (ld_acquire(count) < want) {
        // a block that never arrives fails the launch instead of hanging
        // the card
        if (clock64() - t0 > kSpinCycles) __trap();
      }
      __threadfence();
    }
    __syncthreads();
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

// k into the descending list l (kept if among its kList largest)
__device__ __forceinline__ void insert(unsigned long long (&l)[kList],
                                       unsigned long long k) {
  if (k <= l[kList - 1]) return;
#pragma unroll
  for (int j = 0; j < kList; ++j) {
    if (k > l[j]) {
      const unsigned long long t = l[j];
      l[j] = k;
      k = t;
    }
  }
}

// The kList largest keys of the warp's lanes' descending lists, into
// `out` in every lane (0-padded); `l` is consumed
__device__ __forceinline__ void warp_top(unsigned long long (&l)[kList],
                                         unsigned long long (&out)[kList]) {
#pragma unroll
  for (int r = 0; r < kList; ++r) {
    const unsigned long long m = warp_max64(l[0]);
    out[r] = m;
    if (m != 0 && l[0] == m) {
#pragma unroll
      for (int j = 0; j < kList - 1; ++j) l[j] = l[j + 1];
      l[kList - 1] = 0;
    }
  }
}

__device__ __forceinline__ float rel_of(float mag, float sum) {
  return sum > 0.0f ? mag / sum : 0.0f;
}

// Global bin g clear of the band edges and the DC notch
__device__ __forceinline__ bool eligible(int g, const Params& p) {
  const int dc = p.F / 2;
  return g >= p.hb && g < p.F - p.hb && !(g >= dc - 3 && g <= dc + 3);
}

__device__ __forceinline__ bool owned(int g, const Params& p) {
  return g >= p.own_lo && g < p.own_hi;
}

// rel > threshold at local bin k (false off the range); k may be another
// thread's or block's bin, whose sum it wrote before the last barrier
__device__ __forceinline__ bool above_at(const State& st, const Params& p,
                                         const float* mag, int k) {
  if (k < 0 || k >= p.FL) return false;
  return rel_of(mag[k], __ldcg(st.bsum + k)) > p.thr;
}

__device__ __forceinline__ int next_slot(int h, int H) {
  return h + 1 == H ? 0 : h + 1;
}

// ---- phase A: extension, deletion, candidates; the block's Partial ----
template <int BPT>
__device__ void phase_a(const State& st, const Params& p, const Scalars& sc,
                        int idx, const float* mag, Partial* part,
                        unsigned* flagw, Shared& sh, unsigned& emit_bits) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * p.block_bins + tid * BPT;
  const bool primed = sc.prim >= p.H;
  unsigned long long l[kList];
#pragma unroll
  for (int j = 0; j < kList; ++j) l[j] = 0;
  unsigned long long seg_best = 0;
  unsigned flag_bits = 0;
  int n_emit = 0, n_flags = 0, n_own_valid = 0, any_long = 0;
  emit_bits = 0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int i = b0 + j;
    unsigned long long key = 0;
    if (i < p.FL) {
      const float rel = rel_of(mag[i], st.bsum[i]);
      const int g = p.bin_lo + i;
      const bool own = owned(g, p);
      bool active = st.a_valid[i] != 0;
      if (active) {
        // extend last_active (burst_detect.c:458-469)
        int last = st.a_last[i];
        if (primed && (rel > p.thr || above_at(st, p, mag, i - 1) ||
                       above_at(st, p, mag, i + 1))) {
          last = idx;
          st.a_last[i] = idx;
        }
        // gone bursts (burst_detect.c:490-518)
        const bool lng =
            (int)((unsigned)last - (unsigned)st.a_start[i]) > p.max_burst_len;
        const bool gone =
            (int)((unsigned)last + (unsigned)p.post_len) <= idx || lng;
        any_long |= lng;
        if (gone && primed) {
          st.a_valid[i] = 0;
          active = false;
          flag_bits |= 1u << j;
          ++n_flags;
          if (own) {
            emit_bits |= 1u << j;
            ++n_emit;
          }
        }
      }
      if (active && own) ++n_own_valid;
      // peaks under the carried mask
      if (rel > p.thr && st.mask[i] == 0 && eligible(g, p))
        key = cand_key(rel, i, active);
    }
    seg_best = key > seg_best ? key : seg_best;
    if (p.seg <= BPT && ((j + 1) & (p.seg - 1)) == 0) {
      insert(l, seg_best);
      seg_best = 0;
    }
  }
  if (p.seg > BPT) {
    // a segment spans seg / BPT lanes
    const int w = p.seg / BPT;
    for (int o = 1; o < w; o <<= 1) {
      const unsigned long long t = __shfl_xor_sync(kFull, seg_best, o);
      seg_best = t > seg_best ? t : seg_best;
    }
    if ((lane & (w - 1)) == 0) insert(l, seg_best);
  }
  flagw[blockIdx.x * blockDim.x + tid] = flag_bits;

  // the warp's 8 keys and counts, then the block's
  if (__any_sync(kFull, l[0] != 0)) {
    unsigned long long w[kList];
    warp_top(l, w);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kList; ++r) sh.wl[warp][r] = w[r];
    }
  } else if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kList; ++r) sh.wl[warp][r] = 0;
  }
  n_emit = warp_sum(n_emit);
  n_flags = warp_sum(n_flags);
  n_own_valid = warp_sum(n_own_valid);
  any_long = warp_sum(any_long);
  if (lane == 0) {
    sh.wc[warp][0] = n_emit;
    sh.wc[warp][1] = n_flags;
    sh.wc[warp][2] = n_own_valid;
    sh.wc[warp][3] = any_long;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned long long m[kList], top[kList];
#pragma unroll
    for (int r = 0; r < kList; ++r) m[r] = lane < nw ? sh.wl[lane][r] : 0;
    if (__any_sync(kFull, m[0] != 0)) {
      warp_top(m, top);
    } else {
#pragma unroll
      for (int r = 0; r < kList; ++r) top[r] = 0;
    }
    int c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] = warp_sum(lane < nw ? sh.wc[lane][q] : 0);
    if (lane == 0) {
      Partial* mine = part + blockIdx.x;
#pragma unroll
      for (int r = 0; r < kList; ++r) mine->keys[r] = top[r];
      mine->n_emit = c[0];
      mine->n_flags = c[1];
      mine->n_own_valid = c[2];
      mine->any_long = c[3] > 0;
    }
  }
}

// ---- the seam: every block's keys and counts, alike in every block ----
// Warp 0 merges the blocks' keys into the range's K_TOP candidates, walks
// the greedy acceptance (detect_fast.py:349-361) and sums the counts into
// the block's Seam; the coupling pair [any_long, n_own_post] is this bin
// range's.
__device__ void seam_warp(const Params& p, const Scalars& sc,
                          const Partial* part, Seam& s) {
  const int lane = threadIdx.x & 31;
  unsigned long long l[kList], top[kList];
#pragma unroll
  for (int j = 0; j < kList; ++j) l[j] = 0;
  for (int b = lane; b < p.blocks; b += 32) {
    for (int r = 0; r < kList; ++r) {
      const unsigned long long k = __ldcg(&part[b].keys[r]);
      if (k <= l[kList - 1]) break;  // the block's keys descend
      insert(l, k);
    }
  }
  if (__any_sync(kFull, l[0] != 0)) {
    warp_top(l, top);
  } else {
#pragma unroll
    for (int j = 0; j < kList; ++j) top[j] = 0;
  }
  if (lane == 0) {
    // a candidate within half_bw of an accepted one is skipped; the first
    // k_create accepted are taken, the rest retry next frame
    const bool primed = sc.prim >= p.H;
    const int k_top = 2 * p.k_create;
    int bins[kList];
    bool acc[kList];
    int n_acc = 0, n_accepted = 0;
#pragma unroll
    for (int j = 0; j < kList; ++j) {
      bins[j] = key_bin(top[j]);
      bool a = j < k_top && primed && top[j] != 0 && key_val(top[j]) > p.thr;
#pragma unroll
      for (int k = 0; k < j; ++k)
        if (acc[k] && abs(bins[j] - bins[k]) <= p.hb) a = false;
      acc[j] = a;
      if (a) {
        if (n_accepted < p.k_create) {
          s.take_bin[n_acc] = bins[j];
          s.take_val[n_acc] = key_val(top[j]);
          s.take_valid[n_acc] = (int)(top[j] & 1ull);
          ++n_acc;
        }
        ++n_accepted;
      }
    }
    s.n_acc = n_acc;
    s.more = n_accepted > p.k_create;
  }
  __syncwarp();
  // the counts: totals, the lower blocks' prefixes, this block's own
  const int me = blockIdx.x, BB = p.block_bins, n_acc = s.n_acc;
  const int lo = me * BB, hi = min(lo + BB, p.FL);
  const int near_lo = max(lo - p.hb, 0) / BB;
  const int near_hi = min(hi - 1 + p.hb, p.FL - 1) / BB;
  int t_emit = 0, pre_emit = 0, my_emit = 0, t_own = 0, t_sq = 0, pre_sq = 0,
      my_sq = 0, near = 0, lng = 0;
  for (int b = lane; b < p.blocks; b += 32) {
    const Partial* q = part + b;
    const int ne = __ldcg(&q->n_emit), nf = __ldcg(&q->n_flags);
    const int nv = __ldcg(&q->n_own_valid), al = __ldcg(&q->any_long);
    // the squelch would emit the block's owned active bins, less those
    // the frame creates at again
    int ns = nv;
    for (int k = 0; k < n_acc; ++k) {
      const int tb = s.take_bin[k];
      if (tb / BB == b && s.take_valid[k] && owned(p.bin_lo + tb, p)) --ns;
    }
    t_emit += ne;
    t_own += nv;
    t_sq += ns;
    lng |= al;
    if (b < me) {
      pre_emit += ne;
      pre_sq += ns;
    }
    if (b == me) {
      my_emit = ne;
      my_sq = ns;
    }
    if (b >= near_lo && b <= near_hi) near += nf;
  }
  t_emit = warp_sum(t_emit);
  pre_emit = warp_sum(pre_emit);
  my_emit = warp_sum(my_emit);
  t_own = warp_sum(t_own);
  t_sq = warp_sum(t_sq);
  pre_sq = warp_sum(pre_sq);
  my_sq = warp_sum(my_sq);
  near = warp_sum(near);
  lng = warp_sum(lng);
  if (lane == 0) {
    // post-creation owned active count: the active bins, and the taken
    // bins that were not
    int n_post = t_own;
    for (int k = 0; k < n_acc; ++k)
      if (!s.take_valid[k] && owned(p.bin_lo + s.take_bin[k], p)) ++n_post;
    s.any_long = lng > 0;
    s.n_own_post = n_post;
    s.my_emit = my_emit;
    s.del_pre = pre_emit;
    s.n_del = t_emit;
    s.my_sq = my_sq;
    s.sq_pre = pre_sq;
    s.n_sq = t_sq;
    s.flags_near = near > 0;
  }
}

__device__ void seam(const Params& p, const Scalars& sc, const Partial* part,
                     Shared& sh) {
  if (threadIdx.x < 32) seam_warp(p, sc, part, sh.seam);
  __syncthreads();
}

// The coupling of the frame's pair over every bin range: the one launch's
// range is all of them. Binshard's all_reduce goes here: the split ends
// launch A after the seam and reads the summed pair at the start of B.
__device__ __forceinline__ void couple(int& /*any_long*/,
                                       int& /*n_active*/) {}

// Rows of the gone table for the bins set in `bits` (bit j: the thread's
// bin b0 + j), ranked in ascending bin order after the `pre` rows of the
// lower blocks: row rank r goes to base + r while r < cap and base + r < G.
// A block-wide call (two block barriers).
template <int BPT>
__device__ void emit_rows(const State& st, const Params& p, Shared& sh,
                          unsigned bits, int b0, int idx, int pre, int cap,
                          int base) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int cnt = __popc(bits);
  const int incl = warp_incl_scan(cnt);
  if (lane == 31) sh.scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nw ? sh.scan[lane] : 0;
    const int x = warp_incl_scan(v);
    if (lane < nw) sh.scan[lane] = x - v;
  }
  __syncthreads();
  int r = pre + sh.scan[warp] + incl - cnt;
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const int i = b0 + j, pos = base + r;
    if (r < cap && pos < p.G) {
      st.g_id[pos] = st.a_id[i];
      st.g_start[pos] = st.a_start[i];
      st.g_stop[pos] = idx;
      st.g_last[pos] = st.a_last[i];
      st.g_bin[pos] = p.bin_lo + i;
      st.g_mag[pos] = st.a_mag[i];
      st.g_noise[pos] = st.a_noise[i];
    }
    ++r;
  }
  __syncthreads();
}

// Deleted bins within +-half_bw of local bin i, clipped at the range's
// edges, from the flag words (bit j of word w: bin w BPT + j)
template <int BPT>
__device__ __forceinline__ int flags_near(const Params& p,
                                          const unsigned* flagw, int i) {
  const int lo = max(i - p.hb, 0), hi = min(i + p.hb, p.FL - 1);
  int n = 0;
  for (int w = lo / BPT; w <= hi / BPT; ++w) {
    const int a = max(lo - w * BPT, 0), b = min(hi - w * BPT, BPT - 1);
    const unsigned m = ((2u << b) - 1u) & ~((1u << a) - 1u);
    n += __popc(__ldcg(flagw + w) & m);
  }
  return n;
}

// ---- phase B: rows, creations, noise, mask, squelch, per bin ----
template <int BPT>
__device__ void phase_b(const State& st, const Params& p, Scalars& sc,
                        int idx, const float* mag, const unsigned* flagw,
                        Shared& sh, unsigned emit_bits, bool force,
                        int n_active, bool squelch) {
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * p.block_bins + tid * BPT;
  const Seam& s = sh.seam;
  const int n_acc = s.n_acc;

  // the deletion rows, before a creation can overwrite the bin's burst
  const int n_del_rows = min(s.n_del, kEDel);
  if (s.my_emit > 0 && s.del_pre < kEDel && sc.g_run + s.del_pre < p.G)
    emit_rows<BPT>(st, p, sh, emit_bits, b0, idx, s.del_pre, kEDel,
                   sc.g_run);

  // creations (burst_detect.c:556-632): each from its bin's sum before
  // the forced noise update, with that update applied in the twin's
  // float order (detect_fast.py:385-401)
  float* row = st.hist + (size_t)sc.hidx * p.FL;
  const float live = sc.prim >= p.H ? 1.0f : 0.0f;
  const int start = (int)((unsigned)idx - (unsigned)p.pre_len);
  for (int k = 0; k < n_acc; ++k) {
    const float mag_db =
        10.0f * log10f(fmaxf(s.take_val[k] * p.hist_f * p.enbw, 1e-30f));
    sc.peak = fmaxf(sc.peak, mag_db);
    const int i = s.take_bin[k];
    if ((unsigned)(i - b0) < (unsigned)BPT) {
      const float m = mag[i];
      const float base_at = st.bsum[i];
      const float old_at = row[i] * live;
      const float base_eff = force ? (base_at - old_at) + m : base_at;
      // the twin divides by Python scalars, which PyTorch's CUDA division
      // computes as a product with the scalar's f32 reciprocal
      const float noise_db = 10.0f * log10f(fmaxf(
          base_eff * (1.0f / p.hist_f) * (1.0f / p.f2) * (1.0f / p.enbw) *
              (1.0f / p.bin_width),
          1e-30f));
      st.a_id[i] =
          (int)(sc.burst_id + 10u * (unsigned)p.id_stride * (unsigned)k);
      st.a_start[i] = start;
      st.a_last[i] = start;
      st.a_mag[i] = mag_db;
      st.a_noise[i] = noise_db;
      st.a_valid[i] = 1;
    }
  }

  // the forced noise update (a long-burst deletion, burst_detect.c:516)
  if (force) {
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int i = b0 + j;
      if (i < p.FL) {
        const float m = mag[i];
        st.bsum[i] = (st.bsum[i] - row[i] * live) + m;
        row[i] = m;
      }
    }
    sc.prim = min(sc.prim + 1, p.H);
    sc.hidx = next_slot(sc.hidx, p.H);
  }

  // one mask update: the creations added, the deletions released
  if (!squelch && (n_acc > 0 || s.flags_near)) {
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int i = b0 + j;
      if (i >= p.FL) continue;
      int d = 0;
      for (int k = 0; k < n_acc; ++k)
        if (abs(i - s.take_bin[k]) <= p.hb) ++d;
      if (s.flags_near) d -= flags_near<BPT>(p, flagw, i);
      if (d != 0) st.mask[i] += d;
    }
  }
  sc.burst_id += 10u * (unsigned)p.id_stride * (unsigned)n_acc;
  sc.waits += (unsigned)s.more;

  // squelch (burst_detect.c:594-631) on the coupled count: its rows (the
  // active owned bins the frame did not create at), then every burst and
  // the mask cleared
  const int n_sq = squelch ? s.n_sq : 0;
  if (squelch && s.my_sq > 0 && s.sq_pre < kESq &&
      sc.g_run + n_del_rows + s.sq_pre < p.G) {
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int i = b0 + j;
      if (i >= p.FL || !st.a_valid[i] || !owned(p.bin_lo + i, p)) continue;
      bool created = false;
      for (int k = 0; k < n_acc; ++k) created |= s.take_bin[k] == i;
      if (!created) bits |= 1u << j;
    }
    emit_rows<BPT>(st, p, sh, bits, b0, idx, s.sq_pre, kESq,
                   sc.g_run + n_del_rows);
  }
  if (squelch) {
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int i = b0 + j;
      if (i < p.FL) {
        st.a_valid[i] = 0;
        st.mask[i] = 0;
      }
    }
  }
  sc.g_run += n_del_rows + min(n_sq, kESq);
  sc.n_tagged += (unsigned)(s.n_del + n_sq);
  sc.dropped += (unsigned)(max(s.n_del - kEDel, 0) + max(n_sq - kESq, 0));
  sc.sq_count = squelch ? sc.sq_count + 3 : max(sc.sq_count - 1, 0);

  // the noise reset after repeated squelch (the ring's slots continue),
  // then the final noise update when no burst is active (:698)
  const bool reset = sc.sq_count >= 10;
  if (reset) {
    sc.prim = 0;
    sc.sq_count = 0;
  }
  const bool do1 = (squelch ? 0 : n_active) == 0;
  if (reset || do1) {
    float* row2 = st.hist + (size_t)sc.hidx * p.FL;
    const float live2 = sc.prim >= p.H ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int i = b0 + j;
      if (i >= p.FL) continue;
      float v = reset ? 0.0f : st.bsum[i];
      if (do1) {
        const float m = mag[i];
        v = (v - row2[i] * live2) + m;
        row2[i] = m;
      }
      st.bsum[i] = v;
    }
    if (do1) {
      sc.prim = min(sc.prim + 1, p.H);
      sc.hidx = next_slot(sc.hidx, p.H);
    }
  }
}

template <int BPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    detect_fast_kernel(const State st, const Params p) {
  __shared__ Shared sh;
  Scalars sc = load_scalars(st);
  unsigned* count = st.scratch;
  Partial* part = reinterpret_cast<Partial*>(st.scratch + kLineWords);
  unsigned* flagw = st.scratch + kLineWords + kPartialWords * p.blocks;
  unsigned gen = 0;
  // every thread reads the scalars before block 0 can write them: each
  // frame has a barrier, and without a frame nothing changes
  for (int f = 0; f < p.n_act; ++f) {
    const int idx = f * p.F;
    const float* mag = st.mag2 + (size_t)f * p.FL;
    unsigned emit_bits;
    phase_a<BPT>(st, p, sc, idx, mag, part, flagw, sh, emit_bits);
    all_sync(count, p.blocks, gen);
    seam(p, sc, part, sh);
    int any_long = sh.seam.any_long, n_active = sh.seam.n_own_post;
    couple(any_long, n_active);
    const bool primed = sc.prim >= p.H;
    const bool force = any_long > 0 && primed;
    const bool squelch =
        p.max_bursts > 0 && primed && n_active > p.max_bursts;
    phase_b<BPT>(st, p, sc, idx, mag, flagw, sh, emit_bits, force, n_active,
                 squelch);
    all_sync(count, p.blocks, gen);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) store_scalars(st, sc, p.G);
}

// ---- the split: launch A of frame f (phase A, barrier 1, the seam) ----
template <int BPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    detect_fast_a(const State st, const Params p, int f) {
  __shared__ Shared sh;
  const Split sp = split_of(st.scratch, p);
  // the scalar chain at frame f (the file's header: two slots)
  const Scalars sc = f == 0 ? load_scalars(st) : sp.slot[f & 1];
  if (f == 0 && blockIdx.x == 0 && threadIdx.x == 0) sp.slot[0] = sc;
  unsigned* count = st.scratch;
  Partial* part = reinterpret_cast<Partial*>(st.scratch + kLineWords);
  unsigned* flagw = st.scratch + kLineWords + kPartialWords * p.blocks;
  unsigned emit_bits;  // dies with the launch: B recomputes it
  phase_a<BPT>(st, p, sc, f * p.F, st.mag2 + (size_t)f * p.FL, part, flagw,
               sh, emit_bits);
  // the counter counts every A launch of the block's frames: this is the
  // grid's (f + 1)-th arrival
  unsigned gen = (unsigned)f;
  all_sync(count, p.blocks, gen);
  seam(p, sc, part, sh);
  if (threadIdx.x == 0) {
    sp.seams[blockIdx.x] = sh.seam;
    if (blockIdx.x == 0) {
      sp.pair[0] = sh.seam.any_long;
      sp.pair[1] = sh.seam.n_own_post;
    }
  }
}

// ---- the split: launch B of frame f (the summed pair, phase B) ----
template <int BPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    detect_fast_b(const State st, const Params p, int f) {
  __shared__ Shared sh;
  const Split sp = split_of(st.scratch, p);
  Scalars sc = sp.slot[f & 1];
  const unsigned* flagw = st.scratch + kLineWords + kPartialWords * p.blocks;
  const int tid = threadIdx.x;
  if (tid == 0) sh.seam = sp.seams[blockIdx.x];
  // phase A's emit_bits: the thread's deleted bins that it owns
  const int b0 = blockIdx.x * p.block_bins + tid * BPT;
  const unsigned flag_bits = flagw[blockIdx.x * blockDim.x + tid];
  unsigned emit_bits = 0;
#pragma unroll
  for (int j = 0; j < BPT; ++j)
    if (((flag_bits >> j) & 1u) && owned(p.bin_lo + b0 + j, p))
      emit_bits |= 1u << j;
  // the pair as the caller's sum over the bin ranges left it (`couple`)
  const long long any_long = sp.pair[0], n_active = sp.pair[1];
  __syncthreads();
  const bool primed = sc.prim >= p.H;
  const bool force = any_long > 0 && primed;
  const bool squelch = p.max_bursts > 0 && primed && n_active > p.max_bursts;
  phase_b<BPT>(st, p, sc, f * p.F, st.mag2 + (size_t)f * p.FL, flagw, sh,
               emit_bits, force, (int)n_active, squelch);
  if (blockIdx.x == 0 && tid == 0) {
    sp.slot[(f + 1) & 1] = sc;
    if (f == p.n_act - 1) store_scalars(st, sc, p.G);
  }
}

// Whether the plan is one the kernel runs (dsp/detect_fast.py `plan`)
bool valid_plan(const Params& p) {
  const int T = p.threads, B = p.bpt;
  if (p.FL <= 0 || p.blocks < 1 || T < 32 || T > kMaxThreads || T % 32 ||
      (B != 1 && B != 2 && B != 4 && B != 8 && B != 16 && B != 32) ||
      p.block_bins != T * B ||
      (long long)p.blocks * p.block_bins < p.FL ||
      (long long)(p.blocks - 1) * p.block_bins >= p.FL)
    return false;
  if (p.seg != 1 && p.seg != 4 && p.seg != 8 && p.seg != 16) return false;
  if (p.FL % p.seg || p.block_bins % p.seg) return false;
  if (p.k_create < 1 || p.k_create > kMaxCreate || p.H < 2 || p.G < 0 ||
      p.hb < 0 || p.n_act < 0 || p.id_stride < 1)
    return false;
  return p.n_act == 0 || (long long)(p.n_act - 1) * p.F <= INT_MAX;
}

// Blocks of `threads` threads of `kern` the card holds at once, asked once
// per (device, kernel, threads) and kept: the split asks before every
// launch A of a grid, once a frame
cudaError_t resident_blocks(const void* kern, int threads, long long* fit) {
  struct Entry {
    const void* kern;
    int dev, threads;
    long long fit;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    if (cache[i].kern == kern && cache[i].dev == dev &&
        cache[i].threads == threads) {
      *fit = cache[i].fit;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  *fit = (long long)per_sm * sms;
  if (n_cache < 64) cache[n_cache++] = Entry{kern, dev, threads, *fit};
  return cudaSuccess;
}

// A launch of `kern` in the plan's layout; a grid spins at its barriers,
// so every block must be resident at once: a cooperative launch after the
// occupancy check
cudaError_t launch_grid(const void* kern, const Params& p, void** args,
                        bool barriers, cudaStream_t stream) {
  cudaError_t err;
  if (p.blocks > 1 && barriers) {
    long long fit = 0;
    err = resident_blocks(kern, p.threads, &fit);
    if (err != cudaSuccess) return err;
    if (fit < p.blocks) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel(kern, p.blocks, p.threads, args, 0,
                                      stream);
  } else {
    err = cudaLaunchKernel(kern, p.blocks, p.threads, args, 0, stream);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing behind
    return err;
  }
  return cudaGetLastError();
}

template <int BPT>
cudaError_t launch(const State& st, const Params& p, int mode, int frame,
                   cudaStream_t stream) {
  State s = st;
  Params q = p;
  int f = frame;
  void* args[] = {&s, &q, &f};
  switch (mode) {
    case kModeA:
      return launch_grid((const void*)detect_fast_a<BPT>, p, args, true,
                         stream);
    case kModeB:  // no barrier across blocks: a plain launch
      return launch_grid((const void*)detect_fast_b<BPT>, p, args, false,
                         stream);
    default:
      return launch_grid((const void*)detect_fast_kernel<BPT>, p, args, true,
                         stream);
  }
}

cudaError_t launch_mode(const State& st, const Params& p, int mode,
                        int frame, cudaStream_t stream) {
  switch (p.bpt) {
    case 1: return launch<1>(st, p, mode, frame, stream);
    case 2: return launch<2>(st, p, mode, frame, stream);
    case 4: return launch<4>(st, p, mode, frame, stream);
    case 8: return launch<8>(st, p, mode, frame, stream);
    case 16: return launch<16>(st, p, mode, frame, stream);
    default: return launch<32>(st, p, mode, frame, stream);
  }
}

// A block's arguments, as `detect_fast_args` packs them for
// `detect_fast`: a launch then costs a call of four arguments, the
// split's two a frame too
struct Packed {
  State st;
  Params p;
  bool split;  // the split's scratch (else the one launch's)
};
constexpr int kPackedBytes = 512;  // dsp/detect_fast.py PACKED_BYTES
static_assert(sizeof(Packed) <= kPackedBytes, "Packed layout");

}  // namespace

// One block of `n_frames` frames of FL local bins (global bins bin_lo +
// i; bursts centred outside [own_lo, own_hi) are tracked, not emitted),
// of which the first n_act run (dsp/detect_fast.py `active_frames`), on
// the output state's tensors (the wrapper's clone of the input state,
// gone table zeroed), checked and packed into `out` (`out_bytes` >=
// kPackedBytes) for `detect_fast`. `scratch`: `scratch_words` 32-bit
// words, zeroed: the one launch's (dsp/detect_fast.py
// `Plan.scratch_words`) or, with `split`, the split's (`Plan.split_words`).
// The plan: `blocks` blocks of `threads` threads, `block_bins` = threads
// x `bins_per_thread` bins a block, segments of `seg` bins (1: every
// bin). A plan the kernel does not run, or a scratch of another size, is
// refused (cudaErrorInvalidValue) before anything runs.
extern "C" int detect_fast_args(
    const float* mag2, float* hist, float* bsum, unsigned char* a_valid,
    int* a_id, int* a_start, int* a_last, float* a_mag, float* a_noise,
    int* mask_count, int* g_id, int* g_start, int* g_stop, int* g_last,
    int* g_bin, float* g_mag, float* g_noise, int* sc, float* scf,
    unsigned* scratch, int F, int FL, int n_act, int H, int G, int half_bw,
    int k_create, int max_bursts, int max_burst_len, int post_len,
    int pre_len, int id_stride, int bin_lo, int own_lo, int own_hi,
    float threshold, float hist_f, float enbw, float f2, float bin_width,
    int blocks, int block_bins, int threads, int bins_per_thread, int seg,
    long long scratch_words, int split, void* out, int out_bytes) {
  if (out_bytes < kPackedBytes) return (int)cudaErrorInvalidValue;
  Packed a;
  a.st = State{mag2,  hist,  bsum,   a_valid, a_id,    a_start, a_last,
               a_mag, a_noise, mask_count, g_id, g_start, g_stop, g_last,
               g_bin, g_mag, g_noise, sc, scf, scratch};
  a.p = Params{F,         FL,        n_act,      H,         G,
               half_bw,   k_create,  max_bursts, max_burst_len, post_len,
               pre_len,   id_stride, bin_lo,     own_lo,    own_hi,
               threshold, hist_f,    enbw,       f2,        bin_width,
               blocks,    block_bins, threads,   bins_per_thread, seg};
  a.split = split != 0;
  const long long words =
      a.split ? split_words(blocks, threads) : one_words(blocks, threads);
  if (!valid_plan(a.p) || scratch_words != words)
    return (int)cudaErrorInvalidValue;
  *static_cast<Packed*>(out) = a;
  return (int)cudaSuccess;
}

// A launch from `detect_fast_args`' packing: the whole block (`mode` 0,
// `frame` 0; a one-launch packing), or launch A (1) or B (2) of frame
// `frame` < n_act of the split (the file's header; a split packing).
// Anything else is refused (cudaErrorInvalidValue), a grid the card cannot
// hold at once too (cudaErrorCooperativeLaunchTooLarge, 720), before
// anything runs.
extern "C" int detect_fast(const void* args, int mode, int frame,
                           cudaStream_t stream) {
  const Packed& a = *static_cast<const Packed*>(args);
  const bool ok =
      a.split ? (mode == kModeA || mode == kModeB) && frame >= 0 &&
                    frame < a.p.n_act
              : mode == kModeWhole && frame == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)launch_mode(a.st, a.p, mode, frame, stream);
}

extern "C" const char* detect_fast_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
