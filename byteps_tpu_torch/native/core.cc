// byteps_tpu_torch native scheduler -- C ABI, loaded via ctypes.
//
// The priority/credit chunk queue that feeds the engine's dispatch loop,
// copied from the scheduler part of byteps_tpu/native/core.cc (the
// reference's scheduled_queue.cc in C++).  Only the ordering state lives
// here (task id, priority, key, bytes, the credit window); Python keeps
// the task objects.  A blocking pop waits on a condition variable with
// the interpreter lock released (ctypes drops it around the call).
//
// Not copied: the partition arithmetic and key packing (the port's Python
// versions are the ones it uses) and the host reducers, Elias coding and
// CRC32C, which belong to planes not ported yet.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>
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

int bps_native_abi_version() { return 1; }

}  // extern "C"
