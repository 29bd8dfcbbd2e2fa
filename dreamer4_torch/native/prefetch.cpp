// Native data-plane: threaded gather/convert engine for host-side batch
// assembly.
//
// A copy of dreamer4_tpu/native/prefetch.cpp, built for the port by
// dreamer4_torch/data/prefetch.py. The reference framework reaches native
// code for its data loading through torch's DataLoader worker processes
// (trainers.py:649-653); this is a C++ worker pool that executes flat
// lists of copy / zero-fill / uint8->float32 descriptors against memmapped
// replay-buffer fields (or decoded video frames), fully off the GIL, so batch
// assembly for step N+1 overlaps the device execution of step N.
//
// ABI (ctypes, see dreamer4_torch/data/prefetch.py):
//   pf_create(num_workers)                       -> handle
//   pf_submit(handle, descs, n)                  -> ticket (>=0) | -1
//   pf_wait(handle, ticket)                      -> 0
//   pf_destroy(handle)
//
// A descriptor is {op, src, dst, nbytes}:
//   op 0: memcpy(dst, src, nbytes)
//   op 1: uint8 -> float32, scaled by 1/255 (nbytes = element count)
//   op 2: memset(dst, 0, nbytes)

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

struct PfDesc {
  int64_t op;
  const void* src;
  void* dst;
  int64_t nbytes;
};

}  // extern "C"

namespace {

struct Job {
  int64_t ticket;
  std::shared_ptr<std::vector<PfDesc>> descs;
  size_t begin;
  size_t end;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;        // workers wait for jobs
  std::condition_variable done_cv;   // pf_wait waits for ticket completion
  std::unordered_map<int64_t, int64_t> pending;  // ticket -> outstanding chunks
  int64_t next_ticket = 0;
  bool stopping = false;

  explicit Pool(int num_workers) {
    for (int i = 0; i < num_workers; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }

  static void execute(const PfDesc& d) {
    switch (d.op) {
      case 0:
        std::memcpy(d.dst, d.src, static_cast<size_t>(d.nbytes));
        break;
      case 1: {
        const uint8_t* src = static_cast<const uint8_t*>(d.src);
        float* dst = static_cast<float*>(d.dst);
        const int64_t n = d.nbytes;
        constexpr float kScale = 1.0f / 255.0f;
        for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * kScale;
        break;
      }
      case 2:
        std::memset(d.dst, 0, static_cast<size_t>(d.nbytes));
        break;
      default:
        break;
    }
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      for (size_t i = job.begin; i < job.end; ++i) execute((*job.descs)[i]);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (--pending[job.ticket] == 0) {
          pending.erase(job.ticket);
          done_cv.notify_all();
        }
      }
    }
  }

  int64_t submit(const PfDesc* descs, int64_t n) {
    if (n < 0) return -1;
    auto copy = std::make_shared<std::vector<PfDesc>>(descs, descs + n);
    const size_t num_workers = workers.size();
    const size_t chunk = std::max<size_t>(1, (n + num_workers - 1) / std::max<size_t>(1, num_workers));
    int64_t ticket;
    {
      std::lock_guard<std::mutex> lk(mu);
      ticket = next_ticket++;
      int64_t chunks = 0;
      for (size_t b = 0; b < static_cast<size_t>(n); b += chunk) {
        Job job;
        job.ticket = ticket;
        job.descs = copy;  // shared content, distinct ranges
        job.begin = b;
        job.end = std::min<size_t>(b + chunk, n);
        queue.push_back(std::move(job));
        ++chunks;
      }
      if (chunks == 0) chunks = 0;
      pending[ticket] = chunks;
      if (chunks == 0) pending.erase(ticket);
    }
    cv.notify_all();
    return ticket;
  }

  void wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this, ticket] { return pending.find(ticket) == pending.end(); });
  }
};

}  // namespace

extern "C" {

void* pf_create(int num_workers) {
  if (num_workers < 1) num_workers = 1;
  return new Pool(num_workers);
}

int64_t pf_submit(void* handle, const PfDesc* descs, int64_t n) {
  return static_cast<Pool*>(handle)->submit(descs, n);
}

int pf_wait(void* handle, int64_t ticket) {
  static_cast<Pool*>(handle)->wait(ticket);
  return 0;
}

void pf_destroy(void* handle) { delete static_cast<Pool*>(handle); }

}  // extern "C"
