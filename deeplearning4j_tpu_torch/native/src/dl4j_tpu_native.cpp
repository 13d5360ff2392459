// dl4j_tpu_native — native (C++) runtime core, the PyTorch port's own copy
// (built by deeplearning4j_tpu_torch/native/loader.py with g++).
//
// Role: the host-side ETL / IO / memory-management layer that the reference
// delegates to native code (libnd4j host ops + DataVec record readers +
// the AsyncDataSetIterator prefetch machinery,
// reference: deeplearning4j-nn/.../iterator/AsyncDataSetIterator.java:36-76,
// deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java,
// deeplearning4j-core/.../datasets/mnist/MnistManager.java).
//
// The compute path is PyTorch on the card; everything here runs on the host
// CPU and feeds it: CSV/IDX record parsing, multithreaded minibatch gather, an async
// double-buffered batch pipeline with a reusable buffer pool (the allocator),
// and a binary DataSet container format (the batch-and-export analog of
// spark/data/BatchAndExportDataSetsFunction.java).
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : n;
}

// Split [0, n) into roughly equal [begin, end) ranges, one per worker.
void parallel_for(long n, int n_threads, const std::function<void(long, long)>& fn) {
  if (n <= 0) return;
  int workers = n_threads > 0 ? n_threads : (int)hw_threads();
  if (workers > n) workers = (int)n;
  if (workers <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  long chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    long b = w * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    pool.emplace_back([&fn, b, e] { fn(b, e); });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

int dl4j_native_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// CSV parsing (DataVec CSVRecordReader analog, numeric fast path)
// ---------------------------------------------------------------------------

// Record line start offsets after skipping `skip_lines`; returns row count.
// Blank lines are ignored.
static long csv_line_offsets(const char* buf, long len, long skip_lines,
                             std::vector<long>& offsets) {
  long pos = 0;
  for (long s = 0; s < skip_lines && pos < len; ++s) {
    const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
    if (!nl) return 0;
    pos = (nl - buf) + 1;
  }
  while (pos < len) {
    // skip blank lines
    long line_end = len;
    const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
    if (nl) line_end = nl - buf;
    bool blank = true;
    for (long i = pos; i < line_end; ++i) {
      if (!isspace((unsigned char)buf[i])) { blank = false; break; }
    }
    if (!blank) offsets.push_back(pos);
    pos = line_end + 1;
  }
  return (long)offsets.size();
}

long csv_dims(const char* buf, long len, char delim, long skip_lines,
              long* n_cols) {
  std::vector<long> offsets;
  long rows = csv_line_offsets(buf, len, skip_lines, offsets);
  if (rows == 0) { *n_cols = 0; return 0; }
  long p = offsets[0];
  long cols = 1;
  while (p < len && buf[p] != '\n') {
    if (buf[p] == delim) ++cols;
    ++p;
  }
  *n_cols = cols;
  return rows;
}

// Parse numeric CSV into row-major float32. Returns rows parsed or -1 if a
// field fails to parse (the Python layer falls back to its own reader then).
long csv_parse(const char* buf, long len, char delim, long skip_lines,
               float* out, long max_rows, long n_cols, int n_threads) {
  std::vector<long> offsets;
  long rows = csv_line_offsets(buf, len, skip_lines, offsets);
  if (rows > max_rows) rows = max_rows;
  std::atomic<bool> ok{true};
  parallel_for(rows, n_threads, [&](long b, long e) {
    for (long r = b; r < e && ok.load(std::memory_order_relaxed); ++r) {
      const char* p = buf + offsets[r];
      const char* end = buf + len;
      for (long c = 0; c < n_cols; ++c) {
        char* after = nullptr;
        double v = strtod(p, &after);
        if (after == p) { ok.store(false); return; }
        out[r * n_cols + c] = (float)v;
        p = after;
        // only whitespace may follow the number inside a field ('1.5abc'
        // must fail, matching the Python fallback's float() ValueError)
        while (p < end && *p != delim && *p != '\n') {
          if (*p != ' ' && *p != '\t' && *p != '\r') { ok.store(false); return; }
          ++p;
        }
        if (c + 1 < n_cols) {
          if (p >= end || *p != delim) { ok.store(false); return; }
          ++p;
        } else if (p < end && *p == delim) {
          // ragged row with MORE fields than the first row: refuse rather
          // than silently dropping data (parity with the Python fallback)
          ok.store(false);
          return;
        }
      }
    }
  });
  return ok.load() ? rows : -1;
}

// ---------------------------------------------------------------------------
// IDX (MNIST ubyte) parsing — MnistManager/MnistImageFile analog
// ---------------------------------------------------------------------------

static uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// images: magic 0x803, n, rows, cols, then n*rows*cols ubyte. Output
// float32 normalized to [0,1]: each byte b becomes the float32 quotient
// b / 255.0f, as numpy's ``astype(float32) / 255.0`` computes it (a
// product with 1.0f / 255.0f would round 126 of the 256 values one ulp
// away), read from a 256-entry table. Returns item count or -1 on bad
// magic or a short buffer.
long idx_images(const uint8_t* buf, long len, float* out, long max_items,
                int n_threads) {
  if (len < 16 || be32(buf) != 0x00000803) return -1;
  long n = be32(buf + 4), rows = be32(buf + 8), cols = be32(buf + 12);
  if (n > max_items) n = max_items;
  long item = rows * cols;
  if (16 + n * item > len) return -1;
  const uint8_t* data = buf + 16;
  float scale[256];
  for (int v = 0; v < 256; ++v) scale[v] = (float)v / 255.0f;
  parallel_for(n * item, n_threads, [&](long b, long e) {
    for (long i = b; i < e; ++i) out[i] = scale[data[i]];
  });
  return n;
}

// labels: magic 0x801, n, then n ubyte. One-hot float32 output.
long idx_labels(const uint8_t* buf, long len, float* out_onehot,
                long n_classes, long max_items) {
  if (len < 8 || be32(buf) != 0x00000801) return -1;
  long n = be32(buf + 4);
  if (n > max_items) n = max_items;
  if (8 + n > len) return -1;
  memset(out_onehot, 0, sizeof(float) * (size_t)(n * n_classes));
  for (long i = 0; i < n; ++i) {
    long c = buf[8 + i];
    if (c < n_classes) out_onehot[i * n_classes + c] = 1.0f;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Multithreaded minibatch gather (the batch-assembly hot loop)
// ---------------------------------------------------------------------------

void gather_rows_f32(const float* src, long row_elems, const int64_t* idx,
                     long n_idx, float* dst, int n_threads) {
  parallel_for(n_idx, n_threads, [&](long b, long e) {
    for (long i = b; i < e; ++i) {
      memcpy(dst + i * row_elems, src + idx[i] * row_elems,
             sizeof(float) * (size_t)row_elems);
    }
  });
}

// ---------------------------------------------------------------------------
// Async batch pipeline — AsyncDataSetIterator.java:36-76 redesigned in C++:
// a producer thread assembles shuffled minibatches into buffers drawn from a
// fixed pool (the memory-management piece: buffers are reused, never
// reallocated) and hands them over a bounded queue; the consumer (Python)
// copies out and recycles the buffer.
// ---------------------------------------------------------------------------

namespace {

struct Batch {
  float* feat;
  float* lab;
  long n_valid;
};

struct Batcher {
  const float* features;
  const float* labels;
  long n, feat_elems, lab_elems, batch_size;
  bool shuffle, drop_last;
  int gather_threads;

  std::vector<int64_t> perm;
  std::vector<std::vector<float>> feat_pool, lab_pool;

  std::queue<Batch> ready;
  std::queue<int> free_bufs;
  std::vector<Batch> slots;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool done = false, stop = false;
  std::thread producer;
  uint64_t seed;

  void make_perm(uint64_t s) {
    perm.resize(n);
    for (long i = 0; i < n; ++i) perm[i] = i;
    if (shuffle) {
      // xorshift64* Fisher-Yates — deterministic given the seed
      uint64_t x = s ? s : 0x9E3779B97F4A7C15ull;
      for (long i = n - 1; i > 0; --i) {
        x ^= x >> 12; x ^= x << 25; x ^= x >> 27;
        uint64_t r = x * 0x2545F4914F6CDD1Dull;
        long j = (long)(r % (uint64_t)(i + 1));
        std::swap(perm[i], perm[j]);
      }
    }
  }

  void run() {
    long n_batches = drop_last ? n / batch_size
                               : (n + batch_size - 1) / batch_size;
    for (long b = 0; b < n_batches; ++b) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_bufs.empty(); });
        if (stop) return;
        slot = free_bufs.front();
        free_bufs.pop();
      }
      long begin = b * batch_size;
      long count = std::min(batch_size, n - begin);
      gather_rows_f32(features, feat_elems, perm.data() + begin, count,
                      slots[slot].feat, gather_threads);
      if (labels) {
        gather_rows_f32(labels, lab_elems, perm.data() + begin, count,
                        slots[slot].lab, gather_threads);
      }
      if (count < batch_size) {
        memset(slots[slot].feat + count * feat_elems, 0,
               sizeof(float) * (size_t)((batch_size - count) * feat_elems));
        if (labels)
          memset(slots[slot].lab + count * lab_elems, 0,
                 sizeof(float) * (size_t)((batch_size - count) * lab_elems));
      }
      slots[slot].n_valid = count;
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(slots[slot]);
      }
      cv_ready.notify_one();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    }
    cv_ready.notify_all();
  }
};

}  // namespace

void* batcher_create(const float* features, const float* labels, long n,
                     long feat_elems, long lab_elems, long batch_size,
                     int shuffle, uint64_t seed, int gather_threads,
                     int queue_cap, int drop_last) {
  auto* b = new Batcher();
  b->features = features;
  b->labels = labels;
  b->n = n;
  b->feat_elems = feat_elems;
  b->lab_elems = lab_elems;
  b->batch_size = batch_size;
  b->shuffle = shuffle != 0;
  b->drop_last = drop_last != 0;
  b->gather_threads = gather_threads;
  b->seed = seed;
  b->make_perm(seed);
  int n_slots = queue_cap + 1;
  b->feat_pool.resize(n_slots);
  b->lab_pool.resize(n_slots);
  b->slots.resize(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    b->feat_pool[i].resize((size_t)batch_size * feat_elems);
    b->lab_pool[i].resize(labels ? (size_t)batch_size * lab_elems : 0);
    b->slots[i] = {b->feat_pool[i].data(),
                   labels ? b->lab_pool[i].data() : nullptr, 0};
    b->free_bufs.push(i);
  }
  b->producer = std::thread([b] { b->run(); });
  return b;
}

int batcher_next(void* handle, float* feat_out, float* lab_out,
                 long* n_valid) {
  auto* b = (Batcher*)handle;
  Batch batch;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_ready.wait(lk, [&] { return b->done || !b->ready.empty(); });
    if (b->ready.empty()) return 0;
    batch = b->ready.front();
    b->ready.pop();
  }
  memcpy(feat_out, batch.feat,
         sizeof(float) * (size_t)(b->batch_size * b->feat_elems));
  if (b->labels && lab_out)
    memcpy(lab_out, batch.lab,
           sizeof(float) * (size_t)(b->batch_size * b->lab_elems));
  *n_valid = batch.n_valid;
  // recycle the buffer
  for (size_t i = 0; i < b->slots.size(); ++i) {
    if (b->slots[i].feat == batch.feat) {
      std::lock_guard<std::mutex> lk(b->mu);
      b->free_bufs.push((int)i);
      break;
    }
  }
  b->cv_free.notify_one();
  return 1;
}

static void batcher_join(Batcher* b) {
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->stop = true;
  }
  b->cv_free.notify_all();
  if (b->producer.joinable()) b->producer.join();
  b->stop = false;
}

void batcher_reset(void* handle, uint64_t seed) {
  auto* b = (Batcher*)handle;
  batcher_join(b);
  std::queue<Batch>().swap(b->ready);
  std::queue<int>().swap(b->free_bufs);
  for (size_t i = 0; i < b->slots.size(); ++i) b->free_bufs.push((int)i);
  b->done = false;
  b->make_perm(seed);
  b->producer = std::thread([b] { b->run(); });
}

void batcher_destroy(void* handle) {
  auto* b = (Batcher*)handle;
  batcher_join(b);
  delete b;
}

// ---------------------------------------------------------------------------
// Binary DataSet container — batch-and-export / portable-iterator analog
// (spark/data/BatchAndExportDataSetsFunction.java + spark/iterator/*).
// Layout: magic 'D4JT' | u32 version | i64 n | i64 feat_elems | i64 lab_elems
//         | features f32[n*feat_elems] | labels f32[n*lab_elems]
// ---------------------------------------------------------------------------

static const uint32_t kMagic = 0x44344A54;  // 'D4JT'

long dataset_write(const char* path, const float* features,
                   const float* labels, long n, long feat_elems,
                   long lab_elems) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t header[2] = {kMagic, 1};
  int64_t dims[3] = {n, feat_elems, lab_elems};
  long ok = fwrite(header, sizeof(header), 1, f) == 1 &&
            fwrite(dims, sizeof(dims), 1, f) == 1 &&
            fwrite(features, sizeof(float), (size_t)(n * feat_elems), f) ==
                (size_t)(n * feat_elems) &&
            (lab_elems == 0 ||
             fwrite(labels, sizeof(float), (size_t)(n * lab_elems), f) ==
                 (size_t)(n * lab_elems));
  fclose(f);
  return ok ? 0 : -1;
}

long dataset_read_header(const char* path, int64_t* n, int64_t* feat_elems,
                         int64_t* lab_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t header[2];
  int64_t dims[3];
  long ok = fread(header, sizeof(header), 1, f) == 1 &&
            fread(dims, sizeof(dims), 1, f) == 1 && header[0] == kMagic;
  fclose(f);
  if (!ok) return -1;
  *n = dims[0];
  *feat_elems = dims[1];
  *lab_elems = dims[2];
  return 0;
}

long dataset_read(const char* path, float* features, float* labels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t header[2];
  int64_t dims[3];
  long ok = fread(header, sizeof(header), 1, f) == 1 &&
            fread(dims, sizeof(dims), 1, f) == 1 && header[0] == kMagic;
  if (ok) {
    size_t fe = (size_t)(dims[0] * dims[1]), le = (size_t)(dims[0] * dims[2]);
    ok = fread(features, sizeof(float), fe, f) == fe &&
         (le == 0 || fread(labels, sizeof(float), le, f) == le);
  }
  fclose(f);
  return ok ? 0 : -1;
}

}  // extern "C"
