// The demod loop kernel's plan: bursts a block, the samples of each
// burst's row ring in shared memory, the samples a bulk copy brings, the
// threads and the dynamic shared memory. dsp/demod.py `plan` computes the
// same plan, and the C entry (demod_loop.cu) refuses any other; plain C++
// so that the CPU tests can compile it (tests/test_torch_demod_plan.py).

#pragma once

namespace demod_plan {

constexpr long long kSmemBytes = 232448;  // the H100's shared memory a block
constexpr int kSms = 132;                 // the H100's SMs
constexpr int kSteps = 32;                // symbol steps a handover chunk
constexpr int kChunk = 512;               // samples a bulk copy (ring slot)
constexpr int kMaxRing = 8192;            // samples of a burst's ring
constexpr int kMinRing = 2048;            // the smallest ring: 4 slots
constexpr int kThreads = 64;              // a producer warp, a PLL warp
constexpr int kMaxBursts = 32;            // a lane of each warp a burst

struct Plan {
  int bursts, ring, chunk, threads;
  long long smem;
};

// the rows' rings first (16-byte aligned), then two buffers of kSteps
// steps' symbols and flags, a lane stride of bursts | 1 (odd: no bank
// conflict when a burst's steps are read across lanes), then an mbarrier a
// ring slot
inline long long shared_bytes(int bursts, int ring, int chunk) {
  const long long pad = bursts | 1;
  const long long slots = ring ? ring / chunk : 0;
  return 8LL * bursts * ring + 2LL * kSteps * pad * 8 + 8LL * bursts * slots +
         2LL * kSteps * pad;
}

inline int pow2_at_least(long long n) {
  int p = 1;
  while (p < n && p < (1 << 30)) p *= 2;
  return p;
}

// B bursts of L samples (L >= 4), S symbols. --no-gardner stages no row.
inline Plan plan(int B, long long L, int S, bool gardner) {
  (void)S;
  int bursts = (B + kSms - 1) / kSms;
  bursts = bursts < 1 ? 1 : (bursts > kMaxBursts ? kMaxBursts : bursts);
  int ring = 0, chunk = 0;
  if (gardner) {
    ring = L < kMaxRing ? pow2_at_least(L) : kMaxRing;
    chunk = ring < kChunk ? ring : kChunk;
  }
  while (shared_bytes(bursts, ring, chunk) > kSmemBytes) {
    if (ring > kMinRing)
      ring /= 2;
    else
      bursts /= 2;
  }
  return {bursts, ring, chunk, kThreads, shared_bytes(bursts, ring, chunk)};
}

}  // namespace demod_plan
