// Native telemetry sink: lock-free SPSC ring buffer + background writer.
//
// The port's copy of the JAX package's sink (tpu_dialmpc/native/
// telemetry_sink.cpp), unchanged below this comment: host C++ with no
// framework code.  The producer (the Python telemetry writer, through
// ctypes) memcpys a record into a preallocated ring slot and returns at
// once; a writer thread drains the ring to a JSONL file.  Overflow drops
// records rather than stall the control loop.
//
// C ABI (ctypes-friendly):
//   void* ts_create(const char* path, int capacity)
//   int   ts_push(void* h, const char* line, int len)   // 1 = accepted
//   long  ts_accepted(void* h)  / ts_dropped(void* h)
//   void  ts_close(void* h)                              // flush + join
//
// Build: dynamics/_build.py's host build (g++ -pthread), at first use, by
// tpu_dialmpc_torch/telemetry/native.py, into build/kernels/.

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxLine = 4096;

struct Slot {
  int len = 0;
  char data[kMaxLine];
};

class Sink {
 public:
  Sink(const char* path, int capacity)
      : slots_(static_cast<size_t>(capacity)),
        file_(std::fopen(path, "w")),
        writer_([this] { Drain(); }) {}

  ~Sink() { Close(); }

  bool Push(const char* line, int len) {
    if (len <= 0 || len >= kMaxLine) return false;
    const uint64_t head = head_.load(std::memory_order_relaxed);
    const uint64_t tail = tail_.load(std::memory_order_acquire);
    if (head - tail >= slots_.size()) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return false;  // full: drop, never stall the control loop
    }
    Slot& s = slots_[head % slots_.size()];
    std::memcpy(s.data, line, static_cast<size_t>(len));
    s.len = len;
    head_.store(head + 1, std::memory_order_release);
    accepted_.fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  long Accepted() const { return accepted_.load(std::memory_order_relaxed); }
  long Dropped() const { return dropped_.load(std::memory_order_relaxed); }

  void Close() {
    bool expected = false;
    if (!closing_.compare_exchange_strong(expected, true)) return;
    if (writer_.joinable()) writer_.join();
    if (file_) {
      std::fflush(file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

 private:
  void Drain() {
    for (;;) {
      uint64_t tail = tail_.load(std::memory_order_relaxed);
      const uint64_t head = head_.load(std::memory_order_acquire);
      if (tail == head) {
        if (closing_.load(std::memory_order_acquire)) return;
        std::this_thread::sleep_for(std::chrono::milliseconds(2));
        continue;
      }
      while (tail != head) {
        Slot& s = slots_[tail % slots_.size()];
        if (file_) {
          std::fwrite(s.data, 1, static_cast<size_t>(s.len), file_);
          std::fputc('\n', file_);
        }
        ++tail;
      }
      tail_.store(tail, std::memory_order_release);
      if (file_) std::fflush(file_);
    }
  }

  std::vector<Slot> slots_;
  std::FILE* file_;
  std::atomic<uint64_t> head_{0};
  std::atomic<uint64_t> tail_{0};
  std::atomic<long> accepted_{0};
  std::atomic<long> dropped_{0};
  std::atomic<bool> closing_{false};
  std::thread writer_;
};

}  // namespace

extern "C" {

void* ts_create(const char* path, int capacity) {
  if (capacity < 2) capacity = 2;
  return new Sink(path, capacity);
}

int ts_push(void* h, const char* line, int len) {
  return static_cast<Sink*>(h)->Push(line, len) ? 1 : 0;
}

long ts_accepted(void* h) { return static_cast<Sink*>(h)->Accepted(); }
long ts_dropped(void* h) { return static_cast<Sink*>(h)->Dropped(); }

void ts_close(void* h) {
  Sink* s = static_cast<Sink*>(h);
  s->Close();
  delete s;
}

}  // extern "C"
