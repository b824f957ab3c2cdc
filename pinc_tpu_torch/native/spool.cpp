// Async snapshot spooler — the native IO runtime component.
//
// The reference writes every field and the whole population to HDF5
// *synchronously inside the time loop* via collective MPI-IO
// (src/main.c:228,269-273) — IO time is step time.  Here snapshots are
// handed to a background C++ writer thread: the producer memcpy's the
// buffer into a queue slot and returns immediately, the worker appends
// tagged records to a spool file, and pinc_tpu_torch.spool converts spools
// to the standard PINC .h5 layout after (or during) the run.
//
// Record format (little endian):
//   magic  u32  0x50494e43 ("PINC")
//   nlen   u32, name bytes
//   step   f64
//   dtype  u32  (0=f32, 1=f64, 2=i32, 3=u8)
//   ndim   u32, dims u64[ndim]
//   payload bytes
//
// Plain C ABI for ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
    std::string name;
    double step;
    uint32_t dtype;
    std::vector<uint64_t> dims;
    std::vector<uint8_t> payload;
};

struct Spool {
    FILE* f = nullptr;
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<Record> queue;
    bool closing = false;
    uint64_t max_queue_bytes = 1ull << 30;   // 1 GiB backpressure cap
    uint64_t queued_bytes = 0;
    uint64_t written_records = 0;

    void run() {
        for (;;) {
            Record rec;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return closing || !queue.empty(); });
                if (queue.empty()) {
                    if (closing) return;
                    continue;
                }
                rec = std::move(queue.front());
                queue.pop_front();
                queued_bytes -= rec.payload.size();
                cv.notify_all();   // wake producers blocked on backpressure
            }
            write_record(rec);
        }
    }

    void write_record(const Record& rec) {
        uint32_t magic = 0x50494e43;
        uint32_t nlen = static_cast<uint32_t>(rec.name.size());
        uint32_t ndim = static_cast<uint32_t>(rec.dims.size());
        fwrite(&magic, 4, 1, f);
        fwrite(&nlen, 4, 1, f);
        fwrite(rec.name.data(), 1, nlen, f);
        fwrite(&rec.step, 8, 1, f);
        fwrite(&rec.dtype, 4, 1, f);
        fwrite(&ndim, 4, 1, f);
        fwrite(rec.dims.data(), 8, ndim, f);
        fwrite(rec.payload.data(), 1, rec.payload.size(), f);
        written_records++;
    }
};

}  // namespace

extern "C" {

void* pinc_spool_open(const char* path) {
    auto* s = new Spool();
    s->f = std::fopen(path, "wb");
    if (!s->f) {
        delete s;
        return nullptr;
    }
    s->worker = std::thread([s] { s->run(); });
    return s;
}

// Enqueue one snapshot; copies the buffer and returns immediately (blocks
// only if more than max_queue_bytes are already in flight).
int pinc_spool_write(void* handle, const char* name, double step,
                     uint32_t dtype, uint32_t ndim, const uint64_t* dims,
                     const void* data, uint64_t nbytes) {
    auto* s = static_cast<Spool*>(handle);
    Record rec;
    rec.name = name;
    rec.step = step;
    rec.dtype = dtype;
    rec.dims.assign(dims, dims + ndim);
    rec.payload.resize(nbytes);
    std::memcpy(rec.payload.data(), data, nbytes);
    {
        std::unique_lock<std::mutex> lk(s->mu);
        s->cv.wait(lk, [&] {
            return s->queued_bytes + nbytes <= s->max_queue_bytes;
        });
        s->queued_bytes += nbytes;
        s->queue.push_back(std::move(rec));
    }
    s->cv.notify_all();
    return 0;
}

uint64_t pinc_spool_pending(void* handle) {
    auto* s = static_cast<Spool*>(handle);
    std::lock_guard<std::mutex> lk(s->mu);
    return s->queue.size();
}

uint64_t pinc_spool_close(void* handle) {
    auto* s = static_cast<Spool*>(handle);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->closing = true;
    }
    s->cv.notify_all();
    s->worker.join();
    std::fclose(s->f);
    uint64_t n = s->written_records;
    delete s;
    return n;
}

}  // extern "C"
