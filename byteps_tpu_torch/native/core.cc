// byteps_tpu_torch native core -- C ABI, loaded via ctypes.
//
// The priority/credit chunk queue that feeds the engine's dispatch loop,
// copied from the scheduler part of byteps_tpu/native/core.cc (the
// reference's scheduled_queue.cc in C++).  Only the ordering state lives
// here (task id, priority, key, bytes, the credit window); Python keeps
// the task objects.  A blocking pop waits on a condition variable with
// the interpreter lock released (ctypes drops it around the call).
//
// The Elias-delta coder of dithering's host wire frame
// (compression/elias.py), bps_elias_encode / bps_elias_decode, is
// copied from the same file.
//
// The host reducers bps_reduce_sum_{f32,f64,i32,i64,bf16} (the async
// parameter server's sum on arrival, server/kv_store.py and
// server/engine.py) and bps_crc32c (the integrity envelope's checksum,
// common/integrity.py) are copied from the same file (ABI 3).
//
// Not copied: the partition arithmetic and key packing (the port's Python
// versions are the ones it uses) and the scaled f32 reducer, which no
// ported module calls.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Task {
  int64_t task_id;
  int64_t priority;
  uint64_t key;
  int64_t nbytes;
  int64_t seq;
};

// Priority desc, then key asc, then FIFO (reference scheduled_queue.cc:82-102
// sorts by priority then key; seq keeps equal entries stable).
struct TaskLess {
  bool operator()(const Task& a, const Task& b) const {
    if (a.priority != b.priority) return a.priority < b.priority;  // max-heap
    if (a.key != b.key) return a.key > b.key;
    return a.seq > b.seq;
  }
};

struct Scheduler {
  std::priority_queue<Task, std::vector<Task>, TaskLess> heap;
  std::mutex mu;
  std::condition_variable cv;
  int64_t credit_limit;
  int64_t in_flight = 0;
  int64_t seq = 0;
  int64_t interrupts = 0;  // one-shot wake tokens (pause handshake)
  bool shutdown = false;

  bool eligible() const {
    if (heap.empty()) return false;
    if (credit_limit <= 0) return true;
    // always let one oversized task through (reference clamps oversized
    // partitions into the window, scheduled_queue.cc:136-150)
    return in_flight == 0 || in_flight + heap.top().nbytes <= credit_limit;
  }
};

}  // namespace

extern "C" {

void* bps_sched_create(int64_t credit_bytes) {
  auto* s = new Scheduler();
  s->credit_limit = credit_bytes;
  return s;
}

void bps_sched_destroy(void* p) { delete static_cast<Scheduler*>(p); }

void bps_sched_add(void* p, int64_t task_id, int64_t priority, uint64_t key,
                   int64_t nbytes) {
  auto* s = static_cast<Scheduler*>(p);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->heap.push(Task{task_id, priority, key, nbytes, s->seq++});
  }
  s->cv.notify_one();
}

// Pop the best eligible task.  Returns task_id, or -1 when none is eligible
// within the timeout.  timeout_s < 0 with block means wait forever.
int64_t bps_sched_get(void* p, int block, double timeout_s,
                      int64_t* out_nbytes) {
  auto* s = static_cast<Scheduler*>(p);
  std::unique_lock<std::mutex> lk(s->mu);
  auto pred = [s] {
    return s->shutdown || s->interrupts > 0 || s->eligible();
  };
  if (block) {
    if (timeout_s < 0) {
      s->cv.wait(lk, pred);
    } else {
      s->cv.wait_for(lk, std::chrono::duration<double>(timeout_s), pred);
    }
    if (s->interrupts > 0) --s->interrupts;
  }
  if (!s->eligible()) return -1;
  Task t = s->heap.top();
  s->heap.pop();
  s->in_flight += t.nbytes;
  if (out_nbytes) *out_nbytes = t.nbytes;
  return t.task_id;
}

void bps_sched_report_finish(void* p, int64_t nbytes) {
  auto* s = static_cast<Scheduler*>(p);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->in_flight = std::max<int64_t>(0, s->in_flight - nbytes);
  }
  s->cv.notify_all();
}

// One-shot wakeup: the next (or currently blocked) bps_sched_get returns
// promptly even with nothing eligible -- the engine's pause-dispatch
// handshake, resumable unlike the shutdown latch below.
void bps_sched_interrupt(void* p) {
  auto* s = static_cast<Scheduler*>(p);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    ++s->interrupts;
  }
  s->cv.notify_all();
}

// Retarget the credit window in place (the auto-tuned planner's value); a
// wider window can make queued tasks eligible, so waiters are notified.
void bps_sched_set_credit(void* p, int64_t credit_bytes) {
  auto* s = static_cast<Scheduler*>(p);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->credit_limit = credit_bytes;
  }
  s->cv.notify_all();
}

int64_t bps_sched_get_credit(void* p) {
  auto* s = static_cast<Scheduler*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->credit_limit;
}

// Wake every blocked bps_sched_get (shutdown path); queue contents survive
// for drain.
void bps_sched_wake(void* p) {
  auto* s = static_cast<Scheduler*>(p);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->shutdown = true;
  }
  s->cv.notify_all();
}

int64_t bps_sched_pending(void* p) {
  auto* s = static_cast<Scheduler*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  return static_cast<int64_t>(s->heap.size());
}

int64_t bps_sched_in_flight(void* p) {
  auto* s = static_cast<Scheduler*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->in_flight;
}

// Pop everything in priority order regardless of credit; returns count.
int64_t bps_sched_drain(void* p, int64_t* out_ids, int64_t cap) {
  auto* s = static_cast<Scheduler*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  int64_t n = 0;
  while (!s->heap.empty() && n < cap) {
    out_ids[n++] = s->heap.top().task_id;
    s->heap.pop();
  }
  return n;
}

int bps_native_abi_version() { return 3; }

}  // extern "C"

// ------------------------------------------------------- elias-delta coder
// Host-side entropy coding of dithering's codes: per nonzero element, the
// gap to the previous one (Elias-delta), a sign bit and |level|
// (Elias-delta), LSB-first within each uint32 word -- the JAX package's
// frame, bit for bit.  Sequential by nature, so it runs on the host; the
// device layouts (dense int8, sparse index + code) keep static shapes.

namespace {

struct BitCursor {
  uint32_t* words;
  int64_t cap_bits;
  int64_t pos = 0;
  bool overflow = false;

  void put(uint32_t bit) {
    if (pos >= cap_bits) {
      overflow = true;
      return;
    }
    if (bit)
      words[pos >> 5] |= (1u << (pos & 31));
    pos++;
  }
};

struct BitReaderC {
  const uint32_t* words;
  int64_t nbits;
  int64_t pos = 0;
  bool fail = false;

  uint32_t get() {
    if (pos >= nbits) {
      fail = true;
      return 0;
    }
    uint32_t b = (words[pos >> 5] >> (pos & 31)) & 1u;
    pos++;
    return b;
  }
};

inline int bitlen_u64(uint64_t x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 1;
  }
  return n;
}

// x >= 1.  N = bitlen(x); L = bitlen(N): L-1 zeros, N's L bits (MSB
// first), then x's low N-1 bits (MSB first).
void elias_put(BitCursor& w, uint64_t x) {
  int n = bitlen_u64(x);
  int l = bitlen_u64(static_cast<uint64_t>(n));
  for (int i = 0; i < l - 1; ++i) w.put(0);
  for (int i = l - 1; i >= 0; --i) w.put((n >> i) & 1);
  for (int i = n - 2; i >= 0; --i) w.put((x >> i) & 1);
}

uint64_t elias_get(BitReaderC& r) {
  int zeros = 0;
  while (!r.fail && r.get() == 0) {
    // valid value bit-lengths are <= 64, so L = bitlen(N) <= 7 and at
    // most 6 leading zeros can occur; more is a forged/corrupt stream
    if (++zeros > 6) {
      r.fail = true;
      return 0;
    }
  }
  if (r.fail) return 0;
  uint64_t n = 1;
  for (int i = 0; i < zeros; ++i) n = (n << 1) | r.get();
  if (r.fail || n > 64) {  // bound BEFORE the value loop: a crafted
    r.fail = true;         // length must not run 2^63 iterations
    return 0;
  }
  uint64_t x = 1;
  for (uint64_t i = 1; i < n && !r.fail; ++i) x = (x << 1) | r.get();
  return r.fail ? 0 : x;
}

}  // namespace

extern "C" {

// Encode signed int8 level codes.  Returns the bit count, or -2 when
// cap_words is too small (caller re-allocates).  out must be zeroed by the
// caller (bits are OR-ed in).
int64_t bps_elias_encode(const int8_t* codes, int64_t n, uint32_t* out,
                         int64_t cap_words) {
  BitCursor w{out, cap_words * 32};
  int64_t last = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (codes[i] == 0) continue;
    elias_put(w, static_cast<uint64_t>(i - last));
    w.put(codes[i] < 0 ? 1u : 0u);
    int mag = codes[i] < 0 ? -static_cast<int>(codes[i])
                           : static_cast<int>(codes[i]);
    elias_put(w, static_cast<uint64_t>(mag));
    last = i;
  }
  return w.overflow ? -2 : w.pos;
}

// Decode into a zeroed int8 buffer of n elements.  Returns 0, or -1 on a
// malformed/truncated stream (out may be partially filled).
int64_t bps_elias_decode(const uint32_t* words, int64_t nbits,
                         int8_t* out, int64_t n) {
  BitReaderC r{words, nbits};
  int64_t pos = -1;
  while (r.pos < nbits) {
    uint64_t gap = elias_get(r);
    // bound-check in unsigned space BEFORE any cast: a forged gap
    // >= 2^63 would wrap negative as int64 and index before the buffer
    if (r.fail || gap == 0 ||
        gap > static_cast<uint64_t>(n - 1 - pos))
      return -1;
    uint32_t sign = r.get();
    uint64_t mag = elias_get(r);
    if (r.fail || mag == 0 || mag > 127) return -1;
    pos += static_cast<int64_t>(gap);
    out[pos] = static_cast<int8_t>(sign ? -static_cast<int>(mag)
                                        : static_cast<int>(mag));
  }
  return 0;
}

}  // extern "C"

// -------------------------------------------------------------- cpu reducer
// dst += src (reference CpuReducer::sum, cpu_reducer.cc -- OpenMP there,
// std::thread fan-out here).  Each element is one IEEE add of the two
// operands, whichever thread does it, so the result has the bits of a
// sequential numpy add.

namespace {

template <typename T>
void add_range(T* dst, const T* src, int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) dst[i] += src[i];
}

inline float bf16_to_f32(uint16_t v) {
  uint32_t u = static_cast<uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  // round-to-nearest-even on the truncated 16 bits
  uint32_t rounding = 0x7fff + ((u >> 16) & 1);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

// Split [0, n) across up to nthreads workers; tiny inputs stay inline --
// thread spawn costs ~10us, worth it only for multi-MB buffers.
template <typename Fn>
void parallel_for(int64_t n, int nthreads, Fn fn) {
  const int64_t kMinPerThread = 1 << 18;  // 256k elements
  int workers = static_cast<int>(std::min<int64_t>(
      nthreads, (n + kMinPerThread - 1) / kMinPerThread));
  if (workers <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(workers);
  int64_t per = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    int64_t b = w * per, e = std::min<int64_t>(n, b + per);
    if (b >= e) break;
    ts.emplace_back([=] { fn(b, e); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void bps_reduce_sum_f32(float* dst, const float* src, int64_t n,
                        int nthreads) {
  parallel_for(n, nthreads,
               [=](int64_t b, int64_t e) { add_range(dst, src, b, e); });
}

void bps_reduce_sum_f64(double* dst, const double* src, int64_t n,
                        int nthreads) {
  parallel_for(n, nthreads,
               [=](int64_t b, int64_t e) { add_range(dst, src, b, e); });
}

void bps_reduce_sum_i32(int32_t* dst, const int32_t* src, int64_t n,
                        int nthreads) {
  parallel_for(n, nthreads,
               [=](int64_t b, int64_t e) { add_range(dst, src, b, e); });
}

void bps_reduce_sum_i64(int64_t* dst, const int64_t* src, int64_t n,
                        int nthreads) {
  parallel_for(n, nthreads,
               [=](int64_t b, int64_t e) { add_range(dst, src, b, e); });
}

// bf16 sum in f32 precision with round-to-nearest-even writeback (the
// reference's software half_t serves the same purpose for its CUDA-less
// server, half.h).
void bps_reduce_sum_bf16(uint16_t* dst, const uint16_t* src, int64_t n,
                         int nthreads) {
  parallel_for(n, nthreads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i)
      dst[i] = f32_to_bf16(bf16_to_f32(dst[i]) + bf16_to_f32(src[i]));
  });
}

}  // extern "C"

// ------------------------------------------------------------------ crc32c
// CRC32C (Castagnoli) for the integrity envelopes (common/integrity.py):
// every sealed frame is verified with this checksum.  Slice-by-8 software
// implementation with no ISA dependency (no SSE4.2 requirement).

namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    const uint32_t kPoly = 0x82f63b78u;  // reflected Castagnoli
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (kPoly ^ (c >> 1)) : (c >> 1);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; ++s) {
        c = t[0][c & 0xff] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};

const Crc32cTables kCrc;

inline uint32_t crc32c_byte(uint32_t crc, uint8_t b) {
  return kCrc.t[0][(crc ^ b) & 0xff] ^ (crc >> 8);
}

inline bool host_is_little_endian() {
  const uint16_t probe = 1;
  uint8_t low;
  std::memcpy(&low, &probe, 1);
  return low == 1;
}

}  // namespace

extern "C" {

// Continue `crc` (0 to start) over n bytes; returns the finalized value.
uint32_t bps_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  crc = ~crc;
  if (host_is_little_endian()) {
    while (n > 0 && (reinterpret_cast<uintptr_t>(p) & 7)) {
      crc = crc32c_byte(crc, *p++);
      --n;
    }
    while (n >= 8) {
      uint64_t v;
      std::memcpy(&v, p, 8);
      v ^= crc;
      crc = kCrc.t[7][v & 0xff] ^ kCrc.t[6][(v >> 8) & 0xff] ^
            kCrc.t[5][(v >> 16) & 0xff] ^ kCrc.t[4][(v >> 24) & 0xff] ^
            kCrc.t[3][(v >> 32) & 0xff] ^ kCrc.t[2][(v >> 40) & 0xff] ^
            kCrc.t[1][(v >> 48) & 0xff] ^ kCrc.t[0][(v >> 56) & 0xff];
      p += 8;
      n -= 8;
    }
  }
  while (n > 0) {
    crc = crc32c_byte(crc, *p++);
    --n;
  }
  return ~crc;
}

}  // extern "C"
