// Native SPSC ring buffer for host-side IQ staging.
//
// C++ twin of fxtpu/runtime/ringbuffer.py (same slot/seq/drop semantics),
// for ingest rates where the Python condition-variable lock becomes the
// bottleneck (>=100 MS/s sustained streaming).  The
// reference consumed its native buffering through cuSignal pinned memory +
// multiprocessing queues (/root/reference/effex/effex.py:105-110); this is
// the in-tree host equivalent.
//
// Single producer / single consumer, lock-free indices (acquire/release
// atomics), preallocated slots, memcpy in, zero-copy view out
// (peek/release).  Exposed as a plain C ABI for ctypes binding
// (fxtpu/runtime/native.py).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>

namespace {

struct RingBuffer {
    int64_t capacity;
    int64_t block_bytes;
    char* slots;
    int64_t* seqs;
    std::atomic<int64_t> head{0};   // total blocks written
    std::atomic<int64_t> tail{0};   // total blocks consumed
    std::atomic<int64_t> drops{0};
    std::atomic<int64_t> total_put{0};
    std::atomic<bool> closed{false};
};

inline double now_s() {
    using namespace std::chrono;
    return duration<double>(steady_clock::now().time_since_epoch()).count();
}

inline void backoff(int& spins) {
    if (spins < 64) {
        ++spins;
    } else {
        std::this_thread::sleep_for(std::chrono::microseconds(20));
    }
}

}  // namespace

extern "C" {

RingBuffer* rb_create(int64_t capacity, int64_t block_bytes) {
    if (capacity < 1 || block_bytes < 1) return nullptr;
    auto* rb = new (std::nothrow) RingBuffer();
    if (!rb) return nullptr;
    rb->capacity = capacity;
    rb->block_bytes = block_bytes;
    rb->slots = new (std::nothrow) char[capacity * block_bytes];
    rb->seqs = new (std::nothrow) int64_t[capacity];
    if (!rb->slots || !rb->seqs) {
        delete[] rb->slots;
        delete[] rb->seqs;
        delete rb;
        return nullptr;
    }
    return rb;
}

void rb_destroy(RingBuffer* rb) {
    if (!rb) return;
    delete[] rb->slots;
    delete[] rb->seqs;
    delete rb;
}

int64_t rb_size(RingBuffer* rb) {
    return rb->head.load(std::memory_order_acquire)
         - rb->tail.load(std::memory_order_acquire);
}

int64_t rb_drops(RingBuffer* rb) { return rb->drops.load(); }
int64_t rb_total_put(RingBuffer* rb) { return rb->total_put.load(); }
void rb_close(RingBuffer* rb) { rb->closed.store(true); }
int rb_closed(RingBuffer* rb) { return rb->closed.load() ? 1 : 0; }

// Copy a block in.  nbytes may be < block_bytes (short block: zero-padded).
// Returns 0 on success, -1 on timeout (block dropped + counted), -2 closed.
int rb_put(RingBuffer* rb, const void* data, int64_t nbytes, int64_t seq,
           double timeout_s) {
    if (rb->closed.load(std::memory_order_acquire)) return -2;
    const double deadline = now_s() + timeout_s;
    int spins = 0;
    while (rb_size(rb) >= rb->capacity) {
        if (rb->closed.load(std::memory_order_acquire)) return -2;
        if (now_s() > deadline) {
            rb->drops.fetch_add(1);
            return -1;
        }
        backoff(spins);
    }
    const int64_t h = rb->head.load(std::memory_order_relaxed);
    char* dst = rb->slots + (h % rb->capacity) * rb->block_bytes;
    const int64_t n = nbytes < rb->block_bytes ? nbytes : rb->block_bytes;
    std::memcpy(dst, data, static_cast<size_t>(n));
    if (n < rb->block_bytes) std::memset(dst + n, 0,
                                         static_cast<size_t>(rb->block_bytes - n));
    rb->seqs[h % rb->capacity] = seq;
    rb->total_put.fetch_add(1);
    rb->head.store(h + 1, std::memory_order_release);
    return 0;
}

// Zero-copy producer: wait for a free slot and return its pointer — the
// source's read (or the native quantizer) then writes the block DIRECTLY
// into ring memory, deleting the staging copy rb_put would do.  The slot
// is invisible to the consumer until rb_commit publishes it.  SPSC: only
// the single producer thread may call reserve/commit (and must not
// interleave rb_put between them).  Returns 0 ok, -1 timeout (counted as
// a drop), -2 closed.
int rb_reserve(RingBuffer* rb, void** data, double timeout_s) {
    if (rb->closed.load(std::memory_order_acquire)) return -2;
    const double deadline = now_s() + timeout_s;
    int spins = 0;
    while (rb_size(rb) >= rb->capacity) {
        if (rb->closed.load(std::memory_order_acquire)) return -2;
        if (now_s() > deadline) {
            rb->drops.fetch_add(1);
            return -1;
        }
        backoff(spins);
    }
    const int64_t h = rb->head.load(std::memory_order_relaxed);
    *data = rb->slots + (h % rb->capacity) * rb->block_bytes;
    return 0;
}

// Publish the slot returned by the last rb_reserve under ``seq``.
void rb_commit(RingBuffer* rb, int64_t seq) {
    const int64_t h = rb->head.load(std::memory_order_relaxed);
    rb->seqs[h % rb->capacity] = seq;
    rb->total_put.fetch_add(1);
    rb->head.store(h + 1, std::memory_order_release);
}

// Zero-copy consumer view of the oldest block.  On success returns 0 and
// sets *data/*seq; the slot stays owned by the consumer until
// rb_release().  Returns -1 on timeout, -2 closed-and-drained.
int rb_peek(RingBuffer* rb, void** data, int64_t* seq, double timeout_s) {
    const double deadline = now_s() + timeout_s;
    int spins = 0;
    while (rb_size(rb) == 0) {
        if (rb->closed.load(std::memory_order_acquire) && rb_size(rb) == 0)
            return -2;
        if (now_s() > deadline) return -1;
        backoff(spins);
    }
    const int64_t t = rb->tail.load(std::memory_order_relaxed);
    *data = rb->slots + (t % rb->capacity) * rb->block_bytes;
    *seq = rb->seqs[t % rb->capacity];
    return 0;
}

void rb_release(RingBuffer* rb) {
    rb->tail.fetch_add(1, std::memory_order_release);
}

// Copy-out get (peek + memcpy + release).  Same return codes as rb_peek.
int rb_get(RingBuffer* rb, void* out, int64_t* seq, double timeout_s) {
    void* src = nullptr;
    const int rc = rb_peek(rb, &src, seq, timeout_s);
    if (rc != 0) return rc;
    std::memcpy(out, src, static_cast<size_t>(rb->block_bytes));
    rb_release(rb);
    return 0;
}

}  // extern "C"
