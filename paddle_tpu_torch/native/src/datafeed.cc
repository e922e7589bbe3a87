// Native data-feed runtime: blocking queue + multi-threaded file feeder.
//
// The port's copy of the JAX package's native input pipeline, after the
// reference's C++ one (ref: paddle/fluid/framework/data_feed.h:117
// DataFeed / MultiSlotDataFeed, framework/channel.h, and
// operators/reader/lod_tensor_blocking_queue.h LoDTensorBlockingQueue /
// buffered_reader.cc BufferedReader). Same architecture: reader threads
// parse file shards and push ready batches through a bounded blocking
// channel; the consumer (the python Dataset, then the executor's copy to
// the device) pops without holding the GIL. Exposed as a C ABI for
// ctypes.
//
// Build (paddle_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o libdatafeed.so datafeed.cc

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// BlockingQueue: bounded MPMC channel of byte buffers
// (ref: lod_tensor_blocking_queue.h BlockingQueue semantics: Push blocks
// when full, Pop blocks when empty, Close releases both sides)
// ---------------------------------------------------------------------------
struct Buffer {
  char* data;
  size_t len;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t capacity) : capacity_(capacity) {}

  ~BlockingQueue() {
    Close();
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& b : q_) std::free(b.data);
    q_.clear();
  }

  // returns 0 ok, -1 closed, -2 timeout
  int Push(const char* data, size_t len, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!WaitFor(lk, timeout_ms, [&] { return q_.size() < capacity_; }))
      return closed_ ? -1 : -2;
    if (closed_) return -1;
    Buffer b;
    b.data = static_cast<char*>(std::malloc(len));
    b.len = len;
    std::memcpy(b.data, data, len);
    q_.push_back(b);
    cv_any_.notify_all();
    return 0;
  }

  // returns len >= 0 ok (caller owns *out), -1 closed+drained, -2 timeout
  int64_t Pop(char** out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!WaitFor(lk, timeout_ms, [&] { return !q_.empty(); }))
      return (closed_ && q_.empty()) ? -1 : -2;
    if (q_.empty()) return -1;  // closed
    Buffer b = q_.front();
    q_.pop_front();
    cv_any_.notify_all();
    *out = b.data;
    return static_cast<int64_t>(b.len);
  }

  // lock-free fast check for reader hot loops
  bool ClosedFast() const { return closed_fast_.load(std::memory_order_relaxed); }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    closed_fast_.store(true, std::memory_order_relaxed);
    cv_any_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

  bool Closed() {
    std::lock_guard<std::mutex> lk(mu_);
    return closed_;
  }

 private:
  // wait until pred() or closed_; returns pred() at exit.
  // One shared condvar: every state change notifies all (producer and
  // consumer wakeups are rare relative to batch cost).
  template <typename Pred>
  bool WaitFor(std::unique_lock<std::mutex>& lk, int timeout_ms, Pred pred) {
    auto cond = [&] { return closed_ || pred(); };
    if (timeout_ms < 0) {
      cv_any_.wait(lk, cond);
      return pred();
    }
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    if (!cv_any_.wait_until(lk, deadline, cond)) return false;  // timeout
    return pred();
  }

  size_t capacity_;
  std::deque<Buffer> q_;
  std::mutex mu_;
  std::condition_variable cv_any_;
  bool closed_ = false;
  std::atomic<bool> closed_fast_{false};
};

// ---------------------------------------------------------------------------
// MultiSlot file feeder (ref: data_feed.h MultiSlotDataFeed): N reader
// threads share a file list; each parses whitespace-separated lines
// "label v0 v1 ... v_{D-1}" and pushes float32 batches into the queue.
// ---------------------------------------------------------------------------
struct Batch {
  std::vector<float> feats;
  std::vector<int64_t> labels;
  int rows = 0;
};

class FileFeeder {
 public:
  FileFeeder(std::vector<std::string> files, int batch_size, int dim,
             int nthreads, size_t queue_cap)
      : files_(std::move(files)),
        batch_size_(batch_size),
        dim_(dim),
        queue_(queue_cap) {
    running_ = static_cast<int>(nthreads);
    for (int i = 0; i < nthreads; ++i)
      threads_.emplace_back([this] { ReadLoop(); });
  }

  ~FileFeeder() {
    queue_.Close();
    for (auto& t : threads_) t.join();
    if (drain_thread_.joinable()) drain_thread_.join();
  }

  // out_feats: [batch_size * dim] float32; out_labels: [batch_size]
  // returns rows in batch (may be < batch_size at tail), 0 drained,
  // -2 timeout, -4 a file failed to open (never silently skipped)
  int Next(float* out_feats, int64_t* out_labels, int timeout_ms) {
    if (open_error_.load()) return -4;
    char* data = nullptr;
    int64_t len = queue_.Pop(&data, timeout_ms);
    if (len == -1) return open_error_.load() ? -4 : 0;
    if (len == -2) return -2;
    int rows;
    std::memcpy(&rows, data, sizeof(int));
    const char* p = data + sizeof(int);
    std::memcpy(out_feats, p, sizeof(float) * rows * dim_);
    p += sizeof(float) * rows * dim_;
    std::memcpy(out_labels, p, sizeof(int64_t) * rows);
    std::free(data);
    return rows;
  }

 private:
  void PushBatch(Batch& b) {
    if (b.rows == 0) return;
    std::vector<char> buf(sizeof(int) + sizeof(float) * b.feats.size() +
                          sizeof(int64_t) * b.labels.size());
    char* p = buf.data();
    std::memcpy(p, &b.rows, sizeof(int));
    p += sizeof(int);
    std::memcpy(p, b.feats.data(), sizeof(float) * b.feats.size());
    p += sizeof(float) * b.feats.size();
    std::memcpy(p, b.labels.data(), sizeof(int64_t) * b.labels.size());
    queue_.Push(buf.data(), buf.size(), -1);
    b.feats.clear();
    b.labels.clear();
    b.rows = 0;
  }

  void ReadLoop() {
    Batch batch;
    batch.feats.reserve(static_cast<size_t>(batch_size_) * dim_);
    for (;;) {
      if (open_error_.load() || queue_.ClosedFast()) break;
      size_t idx = next_file_.fetch_add(1);
      if (idx >= files_.size()) break;
      FILE* f = std::fopen(files_[idx].c_str(), "r");
      if (!f) {
        open_error_.store(true);  // surface, don't silently skip
        break;
      }
      // getline: no line-length cap — a fixed fgets buffer would split
      // a >buffer line mid-record and parse the continuation fragment
      // as a fresh row (its first token becoming the label)
      char* line = nullptr;
      size_t line_cap = 0;
      while (getline(&line, &line_cap, f) != -1) {
        char* save = nullptr;
        char* tok = strtok_r(line, " \t\n", &save);
        if (!tok) continue;
        batch.labels.push_back(std::strtoll(tok, nullptr, 10));
        int got = 0;
        while (got < dim_ && (tok = strtok_r(nullptr, " \t\n", &save))) {
          batch.feats.push_back(std::strtof(tok, nullptr));
          ++got;
        }
        for (; got < dim_; ++got) batch.feats.push_back(0.f);  // ragged pad
        if (++batch.rows == batch_size_) PushBatch(batch);
      }
      std::free(line);
      std::fclose(f);
    }
    PushBatch(batch);  // tail
    if (running_.fetch_sub(1) == 1) {
      // last reader out: close once consumers drained the tail batches
      // (joined in the destructor — never outlives the feeder)
      drain_thread_ = std::thread([this] {
        while (queue_.Size() > 0 && !queue_.Closed())
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
        queue_.Close();
      });
    }
  }

  std::vector<std::string> files_;
  int batch_size_;
  int dim_;
  BlockingQueue queue_;
  std::vector<std::thread> threads_;
  std::atomic<size_t> next_file_{0};
  std::atomic<int> running_{0};
  std::atomic<bool> open_error_{false};
  std::thread drain_thread_;
};

// ---------------------------------------------------------------------------
// MultiSlotFeeder: the general MultiSlot-format parser
// (ref: data_feed.cc MultiSlotDataFeed::ParseOneInstance). Each line
// holds, per slot, "<n> v1 ... vn" — float values for dense float32
// slots, integer feasigns for sparse int64 slots. Reader threads shard
// the file list and emit serialized batches:
//   int32 rows | per slot: dense → rows*dim f32
//                          sparse → rows*dim i64 (0-padded) + rows i64 lens
// Dense slots REQUIRE n == dim (the reference enforces slot
// consistency); a violation poisons the feeder and surfaces as -3.
// ---------------------------------------------------------------------------
// strict numeric token parsing: trailing garbage or an empty parse is a
// malformed record, never a silent zero (the python parser's int()/
// float() contract)
inline bool ParseLong(const char* tok, long* out) {
  char* end = nullptr;
  *out = std::strtol(tok, &end, 10);
  return end != tok && *end == '\0';
}
inline bool ParseI64(const char* tok, int64_t* out) {
  char* end = nullptr;
  *out = std::strtoll(tok, &end, 10);
  return end != tok && *end == '\0';
}
inline bool ParseF32(const char* tok, float* out) {
  char* end = nullptr;
  *out = std::strtof(tok, &end);
  return end != tok && *end == '\0';
}

class MultiSlotFeeder {
 public:
  MultiSlotFeeder(std::vector<std::string> files, int batch_size,
                  std::vector<int> dtypes, std::vector<int> dims,
                  int nthreads, size_t queue_cap)
      : files_(std::move(files)),
        batch_size_(batch_size),
        dtypes_(std::move(dtypes)),
        dims_(std::move(dims)),
        queue_(queue_cap) {
    row_bytes_ = 0;
    for (size_t s = 0; s < dims_.size(); ++s)
      row_bytes_ += dtypes_[s] == 0
                        ? sizeof(float) * dims_[s]
                        : sizeof(int64_t) * (dims_[s] + 1);
    running_ = nthreads;
    for (int i = 0; i < nthreads; ++i)
      threads_.emplace_back([this] { ReadLoop(); });
  }

  ~MultiSlotFeeder() {
    queue_.Close();
    for (auto& t : threads_) t.join();
    if (drain_thread_.joinable()) drain_thread_.join();
  }

  size_t BatchBytes() const {
    return sizeof(int) + static_cast<size_t>(batch_size_) * row_bytes_;
  }

  // Copies one serialized batch into out (caller sizes it BatchBytes()).
  // Returns rows, 0 drained, -2 timeout, -3 parse error, -4 open error.
  int Next(char* out, int timeout_ms) {
    if (open_error_.load()) return -4;
    if (error_.load()) return -3;
    char* data = nullptr;
    int64_t len = queue_.Pop(&data, timeout_ms);
    if (len == -1)
      return open_error_.load() ? -4 : (error_.load() ? -3 : 0);
    if (len == -2) return -2;
    int rows;
    std::memcpy(&rows, data, sizeof(int));
    std::memcpy(out, data, static_cast<size_t>(len));
    std::free(data);
    return rows;
  }

 private:
  struct Columns {
    // per-slot column stores for the batch under construction
    std::vector<std::vector<float>> f;
    std::vector<std::vector<int64_t>> i;
    std::vector<std::vector<int64_t>> lens;
    int rows = 0;
  };

  void InitColumns(Columns& c) {
    c.f.assign(dims_.size(), {});
    c.i.assign(dims_.size(), {});
    c.lens.assign(dims_.size(), {});
    c.rows = 0;
  }

  void PushBatch(Columns& c) {
    if (c.rows == 0) return;
    std::vector<char> buf(sizeof(int) +
                          static_cast<size_t>(c.rows) * row_bytes_);
    char* p = buf.data();
    std::memcpy(p, &c.rows, sizeof(int));
    p += sizeof(int);
    for (size_t s = 0; s < dims_.size(); ++s) {
      if (dtypes_[s] == 0) {
        size_t nb = sizeof(float) * c.f[s].size();
        std::memcpy(p, c.f[s].data(), nb);
        p += nb;
      } else {
        size_t nb = sizeof(int64_t) * c.i[s].size();
        std::memcpy(p, c.i[s].data(), nb);
        p += nb;
        nb = sizeof(int64_t) * c.lens[s].size();
        std::memcpy(p, c.lens[s].data(), nb);
        p += nb;
      }
    }
    queue_.Push(buf.data(), buf.size(), -1);
    InitColumns(c);
  }

  // 1 = row parsed, 0 = blank line, -1 = malformed
  int ParseLine(char* line, Columns& c) {
    char* save = nullptr;
    char* tok = strtok_r(line, " \t\n", &save);
    if (!tok) return 0;  // blank line
    for (size_t s = 0; s < dims_.size(); ++s) {
      if (tok == nullptr) return -1;
      long n;
      if (!ParseLong(tok, &n) || n < 0) return -1;
      const int dim = dims_[s];
      if (dtypes_[s] == 0) {
        if (n != dim) return -1;  // dense slot arity is a contract
        for (long k = 0; k < n; ++k) {
          tok = strtok_r(nullptr, " \t\n", &save);
          float v;
          if (!tok || !ParseF32(tok, &v)) return -1;
          c.f[s].push_back(v);
        }
      } else {
        long kept = n < dim ? n : dim;
        for (long k = 0; k < n; ++k) {
          tok = strtok_r(nullptr, " \t\n", &save);
          int64_t v;
          if (!tok || !ParseI64(tok, &v)) return -1;
          if (k < kept) c.i[s].push_back(v);
        }
        for (long k = kept; k < dim; ++k) c.i[s].push_back(0);
        c.lens[s].push_back(kept);
      }
      tok = strtok_r(nullptr, " \t\n", &save);
    }
    return 1;
  }

  void ReadLoop() {
    Columns batch;
    InitColumns(batch);
    char* line = nullptr;          // getline-managed: no line-length cap
    size_t line_cap = 0;
    for (;;) {
      if (error_.load() || open_error_.load() || queue_.ClosedFast())
        break;
      size_t idx = next_file_.fetch_add(1);
      if (idx >= files_.size()) break;
      FILE* f = std::fopen(files_[idx].c_str(), "r");
      if (!f) {
        open_error_.store(true);   // distinct from a parse error
        break;
      }
      while (getline(&line, &line_cap, f) != -1) {
        if (queue_.ClosedFast()) break;  // consumer went away: stop
        int r = ParseLine(line, batch);
        if (r < 0) {
          error_.store(true);
          break;
        }
        if (r == 1 && ++batch.rows == batch_size_) PushBatch(batch);
      }
      std::fclose(f);
      if (error_.load() || queue_.ClosedFast()) break;
    }
    std::free(line);
    if (!error_.load() && !open_error_.load())
      PushBatch(batch);  // a malformed line leaves the columns ragged
    if (running_.fetch_sub(1) == 1) {
      drain_thread_ = std::thread([this] {
        while (queue_.Size() > 0 && !queue_.Closed())
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
        queue_.Close();
      });
    }
  }

  std::vector<std::string> files_;
  int batch_size_;
  std::vector<int> dtypes_;  // 0 = float32 dense, 1 = int64 sparse
  std::vector<int> dims_;
  size_t row_bytes_;
  BlockingQueue queue_;
  std::vector<std::thread> threads_;
  std::atomic<size_t> next_file_{0};
  std::atomic<int> running_{0};
  std::atomic<bool> error_{false};
  std::atomic<bool> open_error_{false};
  std::thread drain_thread_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

void* ptq_create(size_t capacity) { return new BlockingQueue(capacity); }

void ptq_destroy(void* q) { delete static_cast<BlockingQueue*>(q); }

int ptq_push(void* q, const char* data, size_t len, int timeout_ms) {
  return static_cast<BlockingQueue*>(q)->Push(data, len, timeout_ms);
}

int64_t ptq_pop(void* q, char** out, int timeout_ms) {
  return static_cast<BlockingQueue*>(q)->Pop(out, timeout_ms);
}

void ptq_free(char* p) { std::free(p); }

void ptq_close(void* q) { static_cast<BlockingQueue*>(q)->Close(); }

size_t ptq_size(void* q) { return static_cast<BlockingQueue*>(q)->Size(); }

void* ptf_create(const char** files, int nfiles, int batch_size, int dim,
                 int nthreads, size_t queue_cap) {
  std::vector<std::string> fs(files, files + nfiles);
  return new FileFeeder(std::move(fs), batch_size, dim, nthreads, queue_cap);
}

int ptf_next(void* f, float* out_feats, int64_t* out_labels,
             int timeout_ms) {
  return static_cast<FileFeeder*>(f)->Next(out_feats, out_labels, timeout_ms);
}

void ptf_destroy(void* f) { delete static_cast<FileFeeder*>(f); }

void* ptm_create(const char** files, int nfiles, int batch_size,
                 const int* dtypes, const int* dims, int nslots,
                 int nthreads, size_t queue_cap) {
  std::vector<std::string> fs(files, files + nfiles);
  return new MultiSlotFeeder(std::move(fs), batch_size,
                             std::vector<int>(dtypes, dtypes + nslots),
                             std::vector<int>(dims, dims + nslots),
                             nthreads, queue_cap);
}

size_t ptm_batch_bytes(void* m) {
  return static_cast<MultiSlotFeeder*>(m)->BatchBytes();
}

int ptm_next(void* m, char* out, int timeout_ms) {
  return static_cast<MultiSlotFeeder*>(m)->Next(out, timeout_ms);
}

void ptm_destroy(void* m) { delete static_cast<MultiSlotFeeder*>(m); }

}  // extern "C"
