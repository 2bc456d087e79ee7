// Real-time executor + sensor ring buffer for the single-scenario path.
//
// The native runtime of the reference's L5 layer (SURVEY.md §1):
//  - MainGazebo/MainHardware spawn two std::threads at fixed 2.5 ms periods,
//    the hardware variant compensating sleep by the measured solve time
//    (MainHardware.cpp:85-87, 127-130);
//  - HardwareA1ROS runs a dedicated 500 Hz UDP receive thread feeding the
//    shared blackboard (HardwareA1ROS.cpp:89, 245-378).
//
// The control math runs in PyTorch, called from Python on the card; this
// library supplies the native runtime around it:
//  - a lock-free single-producer/single-consumer ring buffer for fixed-size
//    float sensor frames (the ingestion seam: UDP/serial/shared-memory
//    producers on one side, the control loop consumer on the other);
//  - a periodic executor with deadline scheduling, solve-time compensation
//    and jitter/miss accounting, driving a user callback (a ctypes-wrapped
//    Python function) at the requested rate.
//
// Built at first use by runtime/native.py (g++ -O3 -std=c++17 -fPIC
// -pthread -shared) into build/native/<hash>/ at the repository root.
// C API only (bound from Python with ctypes).

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// SPSC ring buffer of fixed-size float frames.
// ---------------------------------------------------------------------------

struct Ring {
  std::vector<float> data;
  size_t frame_len;
  size_t capacity;  // number of frames (power of two)
  std::atomic<uint64_t> head{0};  // next write seq
  std::atomic<uint64_t> tail{0};  // next read seq
  std::atomic<uint64_t> dropped{0};
};

// ---------------------------------------------------------------------------
// Periodic executor.
// ---------------------------------------------------------------------------

typedef void (*rt_callback)(void* ctx, int64_t tick);

struct LoopStats {
  std::atomic<uint64_t> iterations{0};
  std::atomic<uint64_t> missed_deadlines{0};
  std::atomic<int64_t> last_work_ns{0};
  std::atomic<int64_t> max_work_ns{0};
  std::atomic<int64_t> total_work_ns{0};
  // jitter: deviation of actual wake time from the scheduled deadline
  std::atomic<int64_t> max_jitter_ns{0};
  std::atomic<int64_t> total_jitter_ns{0};
};

struct Loop {
  int64_t period_ns;
  rt_callback cb;
  void* ctx;
  std::atomic<bool> running{false};
  std::thread thread;
  LoopStats stats;
  bool compensate;  // subtract work time from sleep (hardware-main style)
};

void loop_body(Loop* loop) {
  int64_t next = now_ns() + loop->period_ns;
  int64_t tick = 0;
  while (loop->running.load(std::memory_order_relaxed)) {
    // sleep until the deadline (coarse sleep + short spin for precision)
    int64_t t = now_ns();
    if (next - t > 200000) {
      std::this_thread::sleep_for(
          std::chrono::nanoseconds(next - t - 100000));
    }
    while ((t = now_ns()) < next &&
           loop->running.load(std::memory_order_relaxed)) {
      // spin
    }
    if (!loop->running.load(std::memory_order_relaxed)) break;

    int64_t jitter = t - next;
    if (jitter > loop->stats.max_jitter_ns.load()) {
      loop->stats.max_jitter_ns.store(jitter);
    }
    loop->stats.total_jitter_ns.fetch_add(jitter);

    int64_t w0 = now_ns();
    loop->cb(loop->ctx, tick);
    int64_t work = now_ns() - w0;

    loop->stats.iterations.fetch_add(1);
    loop->stats.last_work_ns.store(work);
    loop->stats.total_work_ns.fetch_add(work);
    if (work > loop->stats.max_work_ns.load()) {
      loop->stats.max_work_ns.store(work);
    }
    if (work > loop->period_ns) {
      loop->stats.missed_deadlines.fetch_add(1);
    }

    if (loop->compensate) {
      // MainHardware.cpp:85-87: sleep = period - elapsed work, so the
      // *start-to-start* interval stays at one period even as solve time
      // varies.
      next = w0 + loop->period_ns;
    } else {
      // sim mains: fixed schedule regardless of work time
      next += loop->period_ns;
    }
    // never accumulate backlog: when overrunning, skip the missed
    // deadlines instead of running flat-out (which would starve the
    // other loops of CPU/GIL/device time)
    int64_t tnow = now_ns();
    if (next < tnow) next = tnow + loop->period_ns;
    ++tick;
  }
}

}  // namespace

extern "C" {

// ---- ring buffer ----------------------------------------------------------

void* rt_ring_create(size_t frame_len, size_t capacity_pow2) {
  Ring* r = new Ring();
  r->frame_len = frame_len;
  r->capacity = size_t(1) << capacity_pow2;
  r->data.resize(r->frame_len * r->capacity);
  return r;
}

void rt_ring_destroy(void* ring) { delete static_cast<Ring*>(ring); }

// producer: always succeeds; overwrites the oldest frame when full
void rt_ring_push(void* ring, const float* frame) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) {
    // overwrite: advance tail (consumer will skip the lost frame)
    r->tail.store(tail + 1, std::memory_order_release);
    r->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  std::memcpy(&r->data[(head & (r->capacity - 1)) * r->frame_len], frame,
              r->frame_len * sizeof(float));
  r->head.store(head + 1, std::memory_order_release);
}

// consumer: drain to the LATEST frame (the control loop wants freshest
// sensors, like the reference's callbacks overwriting the blackboard).
// Returns number of frames skipped + 1 if a frame was read, 0 if empty.
int rt_ring_pop_latest(void* ring, float* out) {
  Ring* r = static_cast<Ring*>(ring);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  if (head == tail) return 0;
  uint64_t latest = head - 1;
  std::memcpy(out, &r->data[(latest & (r->capacity - 1)) * r->frame_len],
              r->frame_len * sizeof(float));
  r->tail.store(head, std::memory_order_release);
  return int(head - tail);
}

uint64_t rt_ring_dropped(void* ring) {
  return static_cast<Ring*>(ring)->dropped.load();
}

// ---- periodic executor ----------------------------------------------------

void* rt_loop_create(int64_t period_ns, rt_callback cb, void* ctx,
                     int compensate) {
  Loop* loop = new Loop();
  loop->period_ns = period_ns;
  loop->cb = cb;
  loop->ctx = ctx;
  loop->compensate = compensate != 0;
  return loop;
}

void rt_loop_start(void* l) {
  Loop* loop = static_cast<Loop*>(l);
  loop->running.store(true);
  loop->thread = std::thread(loop_body, loop);
}

void rt_loop_stop(void* l) {
  Loop* loop = static_cast<Loop*>(l);
  loop->running.store(false);
  if (loop->thread.joinable()) loop->thread.join();
}

void rt_loop_destroy(void* l) {
  Loop* loop = static_cast<Loop*>(l);
  if (loop->running.load()) rt_loop_stop(l);
  delete loop;
}

// stats: [iterations, missed, last_work_ns, max_work_ns, mean_work_ns,
//         max_jitter_ns, mean_jitter_ns]
void rt_loop_stats(void* l, double* out7) {
  Loop* loop = static_cast<Loop*>(l);
  uint64_t n = loop->stats.iterations.load();
  out7[0] = double(n);
  out7[1] = double(loop->stats.missed_deadlines.load());
  out7[2] = double(loop->stats.last_work_ns.load());
  out7[3] = double(loop->stats.max_work_ns.load());
  out7[4] = n ? double(loop->stats.total_work_ns.load()) / double(n) : 0.0;
  out7[5] = double(loop->stats.max_jitter_ns.load());
  out7[6] = n ? double(loop->stats.total_jitter_ns.load()) / double(n) : 0.0;
}

}  // extern "C"
