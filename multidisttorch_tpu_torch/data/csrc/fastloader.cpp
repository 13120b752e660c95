// fastloader: background-threaded batch gather for the host data path.
//
// The port's own copy of the JAX package's gatherer (the same C ABI and
// the same code below this header). The equivalent of the native layer
// under the reference's torch.utils.data.DataLoader: a C++ prefetch thread
// gathers permuted rows into a small ring of buffers while the Python
// driver and the card consume earlier batches. Determinism is preserved by
// taking the epoch permutation FROM the caller (numpy computes it
// identically for the native and pure-Python paths); this library owns
// only the memory-bound gather and its overlap with device compute: no
// GIL, no per-batch Python allocation. fl_next_batch copies a batch into
// the caller's buffer, which the port points at pinned host memory.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -Wall, at first use,
// into build/ under a hash of source and flags (ops/_build.py).
// ABI: plain C, consumed via ctypes (multidisttorch_tpu_torch/data/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kRingSlots = 4;

struct Slot {
  std::vector<float> images;
  std::vector<int32_t> labels;
  int64_t rows = 0;
  bool ready = false;
};

struct Loader {
  const float* images = nullptr;   // (n, dim) row-major, borrowed
  const int32_t* labels = nullptr; // (n,) borrowed, may be null
  int64_t n = 0;
  int64_t dim = 0;

  // epoch state
  std::vector<int64_t> perm;
  int64_t batch_size = 0;
  int64_t num_batches = 0;

  // ring buffer between producer thread and consumer
  Slot ring[kRingSlots];
  int64_t produced = 0;
  int64_t consumed = 0;
  std::mutex mu;
  std::condition_variable cv_produce;
  std::condition_variable cv_consume;
  std::thread worker;
  std::atomic<bool> stop{false};

  void join_worker() {
    if (worker.joinable()) {
      {
        // stop must be set under mu: otherwise the producer can read
        // stop=false in its wait predicate, lose this notify, and block
        // forever (deadlocking the join below).
        std::lock_guard<std::mutex> lk(mu);
        stop.store(true);
      }
      cv_produce.notify_all();
      worker.join();
      stop.store(false);
    }
  }

  void produce_loop() {
    for (int64_t b = 0; b < num_batches; ++b) {
      Slot* slot = &ring[b % kRingSlots];
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() || b - consumed < kRingSlots;
        });
        if (stop.load()) return;
      }
      const int64_t* idx = perm.data() + b * batch_size;
      slot->images.resize(batch_size * dim);
      slot->rows = batch_size;
      for (int64_t r = 0; r < batch_size; ++r) {
        std::memcpy(slot->images.data() + r * dim,
                    images + idx[r] * dim,
                    sizeof(float) * dim);
      }
      if (labels != nullptr) {
        slot->labels.resize(batch_size);
        for (int64_t r = 0; r < batch_size; ++r) {
          slot->labels[r] = labels[idx[r]];
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->ready = true;
        produced = b + 1;
      }
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Create a loader borrowing the dataset arrays (caller keeps them alive).
// labels may be null.
void* fl_create(const float* images, int64_t n, int64_t dim,
                const int32_t* labels) {
  if (images == nullptr || n <= 0 || dim <= 0) return nullptr;
  Loader* L = new Loader();
  L->images = images;
  L->labels = labels;
  L->n = n;
  L->dim = dim;
  return L;
}

// Begin an epoch: takes the caller-computed permutation (length n_perm,
// every value in [0, n)), fixed batch size; trailing remainder dropped.
// Returns the number of batches, or -1 on error.
int64_t fl_start_epoch(void* handle, const int64_t* perm, int64_t n_perm,
                       int64_t batch_size) {
  Loader* L = static_cast<Loader*>(handle);
  if (L == nullptr || perm == nullptr || batch_size <= 0) return -1;
  for (int64_t i = 0; i < n_perm; ++i) {
    if (perm[i] < 0 || perm[i] >= L->n) return -1;
  }
  L->join_worker();
  L->perm.assign(perm, perm + n_perm);
  L->batch_size = batch_size;
  L->num_batches = n_perm / batch_size;
  L->produced = 0;
  L->consumed = 0;
  for (auto& s : L->ring) s.ready = false;
  L->worker = std::thread([L] { L->produce_loop(); });
  return L->num_batches;
}

// Copy the next batch into caller buffers (out_images: batch*dim floats;
// out_labels: batch int32s, may be null). Blocks until the prefetch
// thread has it. Returns rows copied, 0 at epoch end, -1 on error.
int64_t fl_next_batch(void* handle, float* out_images, int32_t* out_labels) {
  Loader* L = static_cast<Loader*>(handle);
  if (L == nullptr || out_images == nullptr) return -1;
  if (L->consumed >= L->num_batches) return 0;
  int64_t b = L->consumed;
  Slot* slot = &L->ring[b % kRingSlots];
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_consume.wait(lk, [&] { return slot->ready; });
  }
  std::memcpy(out_images, slot->images.data(),
              sizeof(float) * slot->rows * L->dim);
  if (out_labels != nullptr && L->labels != nullptr) {
    std::memcpy(out_labels, slot->labels.data(),
                sizeof(int32_t) * slot->rows);
  }
  int64_t rows = slot->rows;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    slot->ready = false;
    L->consumed = b + 1;
  }
  L->cv_produce.notify_one();
  return rows;
}

void fl_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (L == nullptr) return;
  L->join_worker();
  delete L;
}

}  // extern "C"
