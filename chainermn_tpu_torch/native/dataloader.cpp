// dataloader — native threaded batch assembler / prefetcher.
//
// The native half of the port's PrefetchIterator, a copy of the JAX
// package's _native/dataloader.cpp: the counterpart of the reference's
// multiprocess data loading (the ImageNet example's Chainer
// MultiprocessIterator, SURVEY.md §2.9).  Worker threads gather dataset
// rows into preallocated slot buffers while the card computes, so the host
// never stalls the step loop on batch assembly.  Python wraps it through
// ctypes (a plain C interface) and copies each slot into pinned staging
// memory for the host-to-device copy.
//
// Model: the dataset is F feature arrays (row-major, contiguous, arbitrary
// row strides) living in caller-owned memory.  The loader owns a ring of
// `depth` slots, each holding one assembled batch per feature.  Workers pull
// batch index-lists from a work queue, memcpy rows, and publish slots;
// `next_batch` blocks for the oldest published slot; `release` recycles it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Feature {
  const uint8_t* base = nullptr;
  uint64_t row_bytes = 0;  // bytes per row (dense)
  uint64_t stride = 0;     // bytes between consecutive rows
};

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // one per feature
  uint64_t seq = 0;
  bool ready = false;
};

struct Work {
  std::vector<int64_t> indices;
  uint64_t seq;
};

struct Loader {
  std::vector<Feature> features;
  uint64_t batch = 0;
  int depth = 0;
  std::vector<Slot> slots;
  std::deque<Work> work;
  std::deque<int> free_slots;
  uint64_t next_submit_seq = 0;
  uint64_t next_consume_seq = 0;
  uint64_t next_slot_seq = 0;  // next seq allowed to claim a free slot
  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for work
  std::condition_variable cv_ready;  // consumer waits for published slots
  std::condition_variable cv_free;   // submitter waits for free slots
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
};

void worker_loop(Loader* L) {
  for (;;) {
    Work w;
    int slot = -1;
    {
      // Slot acquisition happens HERE, not at submit time: the consumer may
      // hold one slot (zero-copy views) while `depth` batches are queued, so
      // a submit-side wait could deadlock against a consumer that only
      // releases on its next call.
      //
      // Slots are granted in SUBMISSION-SEQ order (next_slot_seq): workers
      // pop work FIFO but can wake in arbitrary order, and if a later-seq
      // batch took the last free slot ahead of the earliest-seq one, a
      // consumer calling loader_next before loader_release (allowed by the
      // "at most depth in flight" contract) would block on the starved
      // lowest seq while holding a slot — deadlock.  Because pops are FIFO,
      // the popped-but-unslotted seqs are contiguous, so the worker holding
      // next_slot_seq always exists and always gets the next free slot.
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_work.wait(lk, [&] { return L->stop || !L->work.empty(); });
      if (L->stop) return;
      w = std::move(L->work.front());
      L->work.pop_front();
      L->cv_free.wait(lk, [&] {
        return L->stop ||
               (!L->free_slots.empty() && w.seq == L->next_slot_seq);
      });
      if (L->stop) return;
      slot = L->free_slots.front();
      L->free_slots.pop_front();
      L->next_slot_seq++;
      L->slots[slot].ready = false;
    }
    // Other workers may be waiting for their seq's turn on cv_free.
    L->cv_free.notify_all();
    Slot& s = L->slots[slot];
    for (size_t f = 0; f < L->features.size(); ++f) {
      const Feature& ft = L->features[f];
      uint8_t* out = s.buffers[f].data();
      for (size_t i = 0; i < w.indices.size(); ++i) {
        std::memcpy(out + i * ft.row_bytes,
                    ft.base + static_cast<uint64_t>(w.indices[i]) * ft.stride,
                    ft.row_bytes);
      }
    }
    {
      std::lock_guard<std::mutex> lk(L->mu);
      s.seq = w.seq;
      s.ready = true;
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

// bases/row_bytes/strides: arrays of length n_features describing the source
// arrays.  batch: rows per batch.  depth: ring size.  n_workers: threads.
void* loader_create(const void** bases, const uint64_t* row_bytes,
                    const uint64_t* strides, int n_features, uint64_t batch,
                    int depth, int n_workers) {
  if (n_features <= 0 || batch == 0 || depth <= 0 || n_workers <= 0)
    return nullptr;
  auto L = std::make_unique<Loader>();
  L->batch = batch;
  L->depth = depth;
  for (int f = 0; f < n_features; ++f) {
    Feature ft;
    ft.base = static_cast<const uint8_t*>(bases[f]);
    ft.row_bytes = row_bytes[f];
    ft.stride = strides[f];
    L->features.push_back(ft);
  }
  L->slots.resize(depth);
  for (int s = 0; s < depth; ++s) {
    for (int f = 0; f < n_features; ++f)
      L->slots[s].buffers.emplace_back(batch * row_bytes[f]);
    L->free_slots.push_back(s);
  }
  for (int w = 0; w < n_workers; ++w) L->workers.emplace_back(worker_loop, L.get());
  return L.release();
}

// Queue one batch of row indices for assembly.  Never blocks — workers wait
// for free slots; the caller provides backpressure by submitting at most
// ring-depth batches ahead of consumption.  Returns the sequence number.
int64_t loader_submit(void* handle, const int64_t* indices, uint64_t n) {
  auto* L = static_cast<Loader*>(handle);
  if (n != L->batch) return -2;
  Work w;
  w.indices.assign(indices, indices + n);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->stop) return -1;
    w.seq = L->next_submit_seq++;
    L->work.push_back(std::move(w));
  }
  L->cv_work.notify_one();
  return static_cast<int64_t>(L->next_submit_seq - 1);
}

// Wait for the next batch IN SUBMISSION ORDER; returns its slot id, whose
// buffers the caller reads via loader_slot_ptr.  -1 after destroy.
int loader_next(void* handle, int timeout_ms) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  auto ready = [&] {
    if (L->stop) return true;
    for (auto& s : L->slots)
      if (s.ready && s.seq == L->next_consume_seq) return true;
    return false;
  };
  if (timeout_ms < 0) {
    L->cv_ready.wait(lk, ready);
  } else if (!L->cv_ready.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
    return -2;
  }
  if (L->stop) return -1;
  for (int s = 0; s < L->depth; ++s)
    if (L->slots[s].ready && L->slots[s].seq == L->next_consume_seq) {
      L->next_consume_seq++;
      return s;
    }
  return -1;  // unreachable
}

const void* loader_slot_ptr(void* handle, int slot, int feature) {
  auto* L = static_cast<Loader*>(handle);
  return L->slots[slot].buffers[feature].data();
}

// Recycle a slot after its data has been consumed (copied out).
void loader_release(void* handle, int slot) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->slots[slot].ready = false;
    L->free_slots.push_back(slot);
  }
  L->cv_free.notify_all();
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop = true;
  L->cv_work.notify_all();
  L->cv_ready.notify_all();
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
