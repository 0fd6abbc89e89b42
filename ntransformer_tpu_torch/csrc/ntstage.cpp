// ntstage: native host-side staging engine for the tiered layer streamer.
//
// The port's own copy of ntransformer_tpu/csrc/ntstage.cpp (the port builds
// nothing of the JAX package), with one addition: ntstage_is_direct, so the
// streamer can count which of its tier-C reads bypassed the page cache.
//
// A thread pool with a condition-variable job queue that fills staging
// buffers from files: a layer read is split into N chunked preads issued in
// parallel, which saturates both page-cache memcpy and direct NVMe reads,
// and a memcpy can be split the same way. Each job's subtasks share one id;
// ntstage_wait returns that job's own error.
//
// Exposed as a C ABI consumed via ctypes (memory/native.py); pure standard
// C++17 + POSIX, no Python or CUDA headers. Built with g++ at first use.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Job {
    std::function<int()> fn;  // returns 0 or errno
    uint64_t id;
};

class Pool {
  public:
    explicit Pool(int n_threads) : stop_(false), next_id_(1) {
        for (int i = 0; i < n_threads; i++) {
            threads_.emplace_back([this] { run(); });
        }
    }

    ~Pool() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto &t : threads_) t.join();
    }

    // Submit a group of subtasks under one job id; wait() returns when all
    // subtasks of the id are done (the double-buffer slot handshake,
    // ref streamer.cu:1161-1190 staging_ready_).
    uint64_t submit(std::vector<std::function<int()>> subtasks) {
        uint64_t id;
        {
            std::unique_lock<std::mutex> lk(mu_);
            id = next_id_++;
            pending_[id] = subtasks.size();
            for (auto &fn : subtasks) {
                queue_.push_back(Job{std::move(fn), id});
            }
        }
        cv_.notify_all();
        return id;
    }

    // Waits for all subtasks of `id`; returns the job's OWN error (0 if
    // none). Errors are tracked per job id so a failed read cannot be
    // absorbed by an unrelated wait.
    int wait(uint64_t id) {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [&] {
            auto it = pending_.find(id);
            return it == pending_.end() || it->second == 0;
        });
        pending_.erase(id);
        auto eit = errors_.find(id);
        int e = (eit == errors_.end()) ? 0 : eit->second;
        errors_.erase(id);
        return e;
    }

  private:
    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                job = std::move(queue_.front());
                queue_.pop_front();
            }
            int err = job.fn();
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (err) errors_[job.id] = err;
                if (--pending_[job.id] == 0) done_cv_.notify_all();
            }
        }
    }

    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    std::deque<Job> queue_;
    std::unordered_map<uint64_t, int> pending_;
    std::unordered_map<uint64_t, int> errors_;
    std::vector<std::thread> threads_;
    bool stop_;
    uint64_t next_id_;
};

ssize_t pread_full(int fd, void *dst, size_t size, uint64_t off) {
    char *p = static_cast<char *>(dst);
    size_t left = size;
    while (left > 0) {
        ssize_t n = ::pread(fd, p, left, off);
        if (n < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        if (n == 0) break;  // EOF
        p += n;
        off += n;
        left -= n;
    }
    return size - left;
}

}  // namespace

extern "C" {

void *ntstage_create(int n_threads) { return new Pool(n_threads); }

void ntstage_destroy(void *pool) { delete static_cast<Pool *>(pool); }

int ntstage_open(const char *path, int direct) {
    int flags = O_RDONLY;
#ifdef O_DIRECT
    if (direct) flags |= O_DIRECT;
#endif
    int fd = ::open(path, flags);
#ifdef O_DIRECT
    if (fd < 0 && direct) fd = ::open(path, O_RDONLY);  // fallback chain
#endif
    return fd;
}

void ntstage_close(int fd) { ::close(fd); }

// 1 if fd bypasses the page cache (opened with O_DIRECT and not reopened
// buffered by ntstage_open's fallback), else 0.
int ntstage_is_direct(int fd) {
#ifdef O_DIRECT
    const int fl = ::fcntl(fd, F_GETFL);
    return fl >= 0 && (fl & O_DIRECT) ? 1 : 0;
#else
    return 0;
#endif
}

// Parallel chunked read: file[off, off+size) -> dest, split over n_chunks
// subtasks. Returns a job id to pass to ntstage_wait.
uint64_t ntstage_submit_read(void *pool_, int fd, uint64_t off, uint64_t size,
                             void *dest, int n_chunks) {
    Pool *pool = static_cast<Pool *>(pool_);
    if (n_chunks < 1) n_chunks = 1;
    uint64_t chunk = (size + n_chunks - 1) / n_chunks;
    chunk = (chunk + 4095) / 4096 * 4096;  // 4 KiB-aligned chunk boundaries
    std::vector<std::function<int()>> tasks;
    for (uint64_t c = 0; c < size; c += chunk) {
        uint64_t len = std::min(chunk, size - c);
        char *d = static_cast<char *>(dest) + c;
        uint64_t o = off + c;
        tasks.push_back([fd, d, len, o]() -> int {
            if (pread_full(fd, d, len, o) != (ssize_t)len) {
                return errno ? errno : EIO;
            }
            return 0;
        });
    }
    return pool->submit(std::move(tasks));
}

// Parallel memcpy (tier-B RAM blob -> staging, or scatter assembly).
uint64_t ntstage_submit_copy(void *pool_, const void *src, void *dest,
                             uint64_t size, int n_chunks) {
    Pool *pool = static_cast<Pool *>(pool_);
    if (n_chunks < 1) n_chunks = 1;
    uint64_t chunk = (size + n_chunks - 1) / n_chunks;
    std::vector<std::function<int()>> tasks;
    for (uint64_t c = 0; c < size; c += chunk) {
        uint64_t len = std::min(chunk, size - c);
        const char *s = static_cast<const char *>(src) + c;
        char *d = static_cast<char *>(dest) + c;
        tasks.push_back([s, d, len]() -> int { ::memcpy(d, s, len); return 0; });
    }
    return pool->submit(std::move(tasks));
}

// Wait for all subtasks of a job; returns 0 on success, or the errno of
// THIS job's failed subtask (per-job attribution).
int ntstage_wait(void *pool_, uint64_t id) {
    return static_cast<Pool *>(pool_)->wait(id);
}

}  // extern "C"
