// xpack_loader: native host-side batch loader for fixed-shape feature packs.
//
// A pack (xggm_tpu_torch/data/xpack.py) lays every image's (feats, boxes,
// adj) record out contiguously in one binary file, and this library serves
// batch gathers:
//
//   * mmap the pack (zero-copy page-cached reads, no per-item syscalls)
//   * xp_gather: scatter-gather N records into one contiguous batch buffer,
//     parallelized over a std::thread pool
//   * xp_submit/xp_wait: asynchronous gathers, so that batch assembly
//     overlaps other work
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Built on first use by xggm_tpu_torch/data/xpack.py::ensure_native:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared -o libxpack.so xpack_loader.cpp

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  int64_t n_items = 0;
  int64_t item_bytes = 0;
};

struct Job {
  const Pack* pack;
  std::vector<int64_t> indices;
  uint8_t* out;
  std::atomic<int64_t> remaining{0};
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
};

class ThreadPool {
 public:
  explicit ThreadPool(int n_threads) {
    if (n_threads <= 0) {
      n_threads = static_cast<int>(std::thread::hardware_concurrency());
      if (n_threads <= 0) n_threads = 1;
    }
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { Run(); });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        fn = std::move(queue_.front());
        queue_.pop();
      }
      fn();
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* g_pool = nullptr;
std::mutex g_pool_mu;

ThreadPool* pool() {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (g_pool == nullptr) g_pool = new ThreadPool(0);
  return g_pool;
}

void gather_range(const Pack* p, const int64_t* indices, int64_t lo,
                  int64_t hi, uint8_t* out) {
  const int64_t ib = p->item_bytes;
  for (int64_t k = lo; k < hi; ++k) {
    const int64_t idx = indices[k];
    std::memcpy(out + k * ib, p->base + idx * ib, ib);
  }
}

}  // namespace

extern "C" {

// Open a pack file of n_items records, item_bytes each. Returns an opaque
// handle (or null on failure / size mismatch).
void* xp_open(const char* path, int64_t n_items, int64_t item_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      st.st_size < static_cast<off_t>(n_items * item_bytes)) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                      MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, static_cast<size_t>(st.st_size), MADV_WILLNEED);
  Pack* p = new Pack();
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(base);
  p->file_bytes = static_cast<size_t>(st.st_size);
  p->n_items = n_items;
  p->item_bytes = item_bytes;
  return p;
}

void xp_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  if (p == nullptr) return;
  ::munmap(const_cast<uint8_t*>(p->base), p->file_bytes);
  ::close(p->fd);
  delete p;
}

// Synchronous batch gather: copy records indices[0..n) into `out`
// (n * item_bytes). Splits across the pool when n is large.
int xp_gather(void* handle, const int64_t* indices, int64_t n, uint8_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  if (p == nullptr || out == nullptr) return -1;
  for (int64_t k = 0; k < n; ++k) {
    if (indices[k] < 0 || indices[k] >= p->n_items) return -2;
  }
  const int64_t kChunk = 16;
  if (n <= kChunk) {
    gather_range(p, indices, 0, n, out);
    return 0;
  }
  std::atomic<int64_t> remaining((n + kChunk - 1) / kChunk);
  std::mutex mu;
  std::condition_variable cv;
  for (int64_t lo = 0; lo < n; lo += kChunk) {
    const int64_t hi = std::min(lo + kChunk, n);
    pool()->Submit([=, &remaining, &mu, &cv] {
      gather_range(p, indices, lo, hi, out);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return remaining.load() == 0; });
  return 0;
}

// ---- asynchronous prefetch ------------------------------------------------

void* xp_submit(void* handle, const int64_t* indices, int64_t n,
                uint8_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  if (p == nullptr) return nullptr;
  Job* job = new Job();
  job->pack = p;
  job->indices.assign(indices, indices + n);
  job->out = out;
  pool()->Submit([job] {
    gather_range(job->pack, job->indices.data(), 0,
                 static_cast<int64_t>(job->indices.size()), job->out);
    std::lock_guard<std::mutex> lk(job->mu);
    job->done = true;
    job->cv.notify_all();
  });
  return job;
}

int xp_wait(void* job_handle) {
  Job* job = static_cast<Job*>(job_handle);
  if (job == nullptr) return -1;
  {
    std::unique_lock<std::mutex> lk(job->mu);
    job->cv.wait(lk, [&] { return job->done; });
  }
  delete job;
  return 0;
}

int64_t xp_n_items(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  return p ? p->n_items : -1;
}

}  // extern "C"
