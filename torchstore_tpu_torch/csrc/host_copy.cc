// Host-side copies of the store's data path, bound with ctypes.
//
// The same entry points as the JAX package's native library, for the
// PyTorch port: a multi-threaded memcpy for large contiguous landings, a
// strided row-block copy, a multi-threaded page prefault of fresh buffers
// and a batched scatter memcpy (one GIL-free call for many independent
// copies). Host code only: it runs on the CPU, not on the card.
//
// Built at first use by torchstore_tpu_torch/native.py:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread host_copy.cc -o _build/...

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <thread>
#include <vector>

namespace {

constexpr size_t kMinPerThread = 4u << 20;  // 4 MiB per thread at least
constexpr size_t kMaxThreads = 16;
constexpr uint64_t kPage = 4096;

size_t hw_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 4 : hw;
}

// Threads for ``total`` bytes: the request (or every core), at most one per
// kMinPerThread bytes and at most kMaxThreads.
size_t pick_threads(int nthreads, uint64_t total) {
  size_t want = nthreads > 0 ? static_cast<size_t>(nthreads) : hw_threads();
  size_t by_size = std::max<uint64_t>(1, total / kMinPerThread);
  return std::min(std::min(want, by_size), kMaxThreads);
}

}  // namespace

extern "C" {

// Multi-threaded memcpy of n bytes; nthreads <= 0 picks by size.
void ts_parallel_memcpy(void* dst, const void* src, uint64_t n, int nthreads) {
  if (n == 0) return;
  size_t threads = pick_threads(nthreads, n);
  if (threads <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  uint64_t chunk = n / threads;
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (size_t i = 0; i + 1 < threads; ++i) {
    pool.emplace_back([=] { std::memcpy(d + i * chunk, s + i * chunk, chunk); });
  }
  uint64_t last = (threads - 1) * chunk;
  std::memcpy(d + last, s + last, n - last);
  for (auto& t : pool) t.join();
}

// Strided 2D copy: ``rows`` rows of ``row_bytes`` from src (pitch
// src_stride bytes) to dst (pitch dst_stride bytes), split over rows.
void ts_copy_2d(void* dst, uint64_t dst_stride, const void* src,
                uint64_t src_stride, uint64_t row_bytes, uint64_t rows,
                int nthreads) {
  if (rows == 0 || row_bytes == 0) return;
  size_t threads = std::min<uint64_t>(pick_threads(nthreads, rows * row_bytes), rows);
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  auto worker = [=](uint64_t lo, uint64_t hi) {
    for (uint64_t r = lo; r < hi; ++r) {
      std::memcpy(d + r * dst_stride, s + r * src_stride, row_bytes);
    }
  };
  if (threads <= 1) {
    worker(0, rows);
    return;
  }
  uint64_t per = rows / threads;
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (size_t i = 0; i + 1 < threads; ++i) {
    pool.emplace_back(worker, i * per, (i + 1) * per);
  }
  worker((threads - 1) * per, rows);
  for (auto& t : pool) t.join();
}

// Multi-threaded prefault of a writable mapping: one write per page, so a
// fresh buffer's pages are allocated before the hot copy reaches them
// (writing allocates a tmpfs or anonymous page; a read would map the zero
// page and fault again on the write). nthreads <= 0: one thread per 16 MiB.
// Returns 0.
int ts_prefault(void* addr, uint64_t len, int nthreads) {
  if (len == 0) return 0;
  madvise(addr, len, MADV_WILLNEED);  // advisory; the writes below do the work
  size_t threads = nthreads > 0
                       ? static_cast<size_t>(nthreads)
                       : std::min<uint64_t>(hw_threads(),
                                            std::max<uint64_t>(1, len / (4 * kMinPerThread)));
  threads = std::min<uint64_t>(std::min(threads, kMaxThreads), (len + kPage - 1) / kPage);
  volatile char* base = static_cast<volatile char*>(addr);
  auto worker = [=](uint64_t lo, uint64_t hi) {
    for (uint64_t off = lo; off < hi; off += kPage) base[off] = 0;
  };
  if (threads <= 1) {
    worker(0, len);
    return 0;
  }
  uint64_t per = ((len + kPage - 1) / kPage / threads) * kPage;
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (size_t i = 0; i + 1 < threads; ++i) {
    pool.emplace_back(worker, i * per, (i + 1) * per);
  }
  worker((threads - 1) * per, len);
  for (auto& t : pool) t.join();
  return 0;
}

// Batched scatter memcpy: ``count`` independent (dst, src, len) copies in
// one call, split byte-balanced across threads (pairs stay whole). The
// pointers ride as uint64 arrays; overlapping ranges are the caller's bug.
void ts_copy_batch(const uint64_t* dsts, const uint64_t* srcs,
                   const uint64_t* lens, uint64_t count, int nthreads) {
  if (count == 0) return;
  uint64_t total = 0;
  for (uint64_t i = 0; i < count; ++i) total += lens[i];
  if (total == 0) return;
  size_t threads = std::min<uint64_t>(pick_threads(nthreads, total), count);
  auto run = [=](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(reinterpret_cast<void*>(dsts[i]),
                  reinterpret_cast<const void*>(srcs[i]), lens[i]);
    }
  };
  if (threads <= 1) {
    run(0, count);
    return;
  }
  // Pair i goes to the thread whose byte range holds its cumulative start.
  std::vector<uint64_t> bounds(threads + 1, count);
  bounds[0] = 0;
  uint64_t per = total / threads, acc = 0, t = 1;
  for (uint64_t i = 0; i < count && t < threads; ++i) {
    acc += lens[i];
    if (acc >= per * t) bounds[t++] = i + 1;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (size_t i = 0; i + 1 < threads; ++i) {
    pool.emplace_back(run, bounds[i], bounds[i + 1]);
  }
  run(bounds[threads - 1], bounds[threads]);
  for (auto& th : pool) th.join();
}

// The entry points above, as the JAX package's library numbers them: 3 has
// the threaded prefault and the batched scatter memcpy.
uint32_t ts_version() { return 3; }

}  // extern "C"
