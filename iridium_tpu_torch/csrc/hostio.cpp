// Native host ingest: a reader thread that reads IQ blocks from a file and
// converts them straight into buffers the caller owns.
//
// Port of native/hostio.cpp (the JAX package's engine, the counterpart of
// the reference's spewer thread main.c:223-284, its int8 -> float
// conversion simd_generic.c:147-153 and its blocking queue). The
// difference: the JAX engine converts into a ring of its own and the
// caller copies each block out; here the caller hands in its buffers (on
// the card, pinned host tensors that the device copies from), so a block
// is converted once, into the memory the upload reads. cf32 blocks are
// read into the buffer with no conversion at all.
//
// C API (ctypes):
//   hostio_open(path, fmt, block_samples) -> handle | NULL
//   hostio_give(handle, buf)   -- hand a buffer of 2 * block_samples
//                                 floats to the reader, to be filled
//   hostio_next(handle, &buf)  -> n_valid samples of the next filled
//                                 buffer in the order they were given
//                                 (0 at EOF, -1 on a read error); the
//                                 buffer is the caller's again
//   hostio_close(handle)
//
// fmt: 0 = ci8 (int8 IQ / 128), 1 = ci16 (>> 8, then / 128: the
// reference's lossy path, main.c:239-249), 2 = cf32. A block past the end
// of the file is zero-filled after its last sample; the first block with
// fewer than block_samples samples is the last.
//
// Build: g++ -O3 -shared -fPIC -pthread (io/native.py does it at first
// use).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct HostIO {
  FILE* f = nullptr;
  int fmt = 0;
  long block_samples = 0;

  std::mutex mu;
  std::condition_variable cv_reader;    // a buffer was given, or closing
  std::condition_variable cv_consumer;  // a buffer was filled, or an error
  std::deque<float*> free_bufs;         // given, not filled yet
  std::deque<std::pair<float*, long>> filled;
  bool done = false;                    // the last block is read
  bool error = false;
  bool closing = false;
  std::thread reader;

  std::vector<int8_t> raw8;
  std::vector<int16_t> raw16;
};

long read_block(HostIO* h, float* out) {
  const long want = h->block_samples;
  long got = 0;
  switch (h->fmt) {
    case 0:
      got = (long)fread(h->raw8.data(), 2 * sizeof(int8_t), want, h->f);
      for (long i = 0; i < 2 * got; i++) out[i] = h->raw8[i] * (1.0f / 128.0f);
      break;
    case 1:
      got = (long)fread(h->raw16.data(), 2 * sizeof(int16_t), want, h->f);
      for (long i = 0; i < 2 * got; i++)
        out[i] = (float)(int8_t)(h->raw16[i] >> 8) * (1.0f / 128.0f);
      break;
    default:
      got = (long)fread(out, 2 * sizeof(float), want, h->f);
      break;
  }
  if (ferror(h->f)) return -1;
  if (got < want) memset(out + 2 * got, 0, sizeof(float) * 2 * (want - got));
  return got;
}

void reader_main(HostIO* h) {
  for (;;) {
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_reader.wait(lk, [&] { return h->closing || !h->free_bufs.empty(); });
    if (h->closing) return;
    float* buf = h->free_bufs.front();
    h->free_bufs.pop_front();
    lk.unlock();

    const long got = read_block(h, buf);

    lk.lock();
    if (got < 0) {
      h->error = true;
    } else {
      h->filled.emplace_back(buf, got);
      if (got < h->block_samples) h->done = true;
    }
    h->cv_consumer.notify_all();
    if (got < h->block_samples) return;
  }
}

}  // namespace

extern "C" {

void* hostio_open(const char* path, int fmt, long block_samples) {
  if (block_samples <= 0 || fmt < 0 || fmt > 2) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new HostIO();
  h->f = f;
  h->fmt = fmt;
  h->block_samples = block_samples;
  if (fmt == 0)
    h->raw8.resize(2 * block_samples);
  else if (fmt == 1)
    h->raw16.resize(2 * block_samples);
  h->reader = std::thread(reader_main, h);
  return h;
}

void hostio_give(void* handle, float* buf) {
  auto* h = static_cast<HostIO*>(handle);
  std::lock_guard<std::mutex> lk(h->mu);
  h->free_bufs.push_back(buf);
  h->cv_reader.notify_all();
}

long hostio_next(void* handle, float** out) {
  auto* h = static_cast<HostIO*>(handle);
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv_consumer.wait(
      lk, [&] { return !h->filled.empty() || h->error || h->done; });
  if (!h->filled.empty()) {
    *out = h->filled.front().first;
    const long n = h->filled.front().second;
    h->filled.pop_front();
    return n;
  }
  return h->error ? -1 : 0;
}

void hostio_close(void* handle) {
  auto* h = static_cast<HostIO*>(handle);
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->closing = true;
    h->cv_reader.notify_all();
  }
  if (h->reader.joinable()) h->reader.join();
  fclose(h->f);
  delete h;
}

}  // extern "C"
