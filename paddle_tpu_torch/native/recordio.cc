// TPU-native data-IO runtime: recordio chunk format + background prefetcher.
//
// Replaces the reference's native data plane — the Go recordio chunks the
// master partitions into tasks (reference: go/master/service.go:105 uses
// recordio.Chunk offsets) and the C++ DataProvider's async double-buffer
// thread (reference: paddle/gserver/dataproviders/DataProvider.h DoubleBuffer)
// — as one small C library the Python framework loads via ctypes.
//
// File layout: a sequence of chunks.
//   chunk   := magic:u32 | crc32:u32 | body_len:u32 | n_records:u32 | body
//   body    := len_0:u32 ... len_{n-1}:u32 | payload_0 ... payload_{n-1}
// crc32 covers the body only.  All integers little-endian.  No compression
// (XLA hosts are never CPU-bound on raw record IO; gzip would serialize the
// prefetch threads).
//
// C ABI (ctypes-friendly): see the extern "C" block at the bottom.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x7061646c;  // "padl"

// -- crc32 (standard polynomial, table-driven) ------------------------------
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_buf(const uint8_t* buf, size_t len) {
  crc_init();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

void put_u32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back(v & 0xff);
  out->push_back((v >> 8) & 0xff);
  out->push_back((v >> 16) & 0xff);
  out->push_back((v >> 24) & 0xff);
}

uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// -- writer -----------------------------------------------------------------
struct Writer {
  FILE* f = nullptr;
  std::vector<std::vector<uint8_t>> pending;
  size_t pending_bytes = 0;
  size_t max_chunk_bytes;
  uint32_t max_chunk_records;

  int flush() {
    if (pending.empty()) return 0;
    std::vector<uint8_t> body;
    body.reserve(pending_bytes + 4 * pending.size());
    for (auto& r : pending) put_u32(&body, (uint32_t)r.size());
    for (auto& r : pending) body.insert(body.end(), r.begin(), r.end());
    std::vector<uint8_t> head;
    put_u32(&head, kMagic);
    put_u32(&head, crc32_buf(body.data(), body.size()));
    put_u32(&head, (uint32_t)body.size());
    put_u32(&head, (uint32_t)pending.size());
    if (fwrite(head.data(), 1, head.size(), f) != head.size()) return -1;
    if (fwrite(body.data(), 1, body.size(), f) != body.size()) return -1;
    pending.clear();
    pending_bytes = 0;
    return 0;
  }
};

// -- reader -----------------------------------------------------------------
struct Reader {
  FILE* f = nullptr;
  std::deque<std::vector<uint8_t>> records;  // decoded from current chunk
  std::vector<uint8_t> current;              // last record handed out
  bool corrupt = false;

  // Reads the next chunk into `records`; false on EOF or error.
  bool load_chunk() {
    uint8_t head[16];
    if (fread(head, 1, 16, f) != 16) return false;
    if (get_u32(head) != kMagic) {
      corrupt = true;
      return false;
    }
    uint32_t crc = get_u32(head + 4);
    uint32_t body_len = get_u32(head + 8);
    uint32_t n = get_u32(head + 12);
    // The CRC covers the body only, so header fields are untrusted: the
    // length table must fit inside the body, and each record must stay in
    // bounds, or the chunk is treated as corrupt rather than read OOB.
    if (4ull * n > body_len) {
      corrupt = true;
      return false;
    }
    std::vector<uint8_t> body;
    try {
      body.resize(body_len);
    } catch (const std::bad_alloc&) {
      corrupt = true;
      return false;
    }
    if (fread(body.data(), 1, body_len, f) != body_len) {
      corrupt = true;
      return false;
    }
    if (crc32_buf(body.data(), body_len) != crc) {
      corrupt = true;
      return false;
    }
    size_t off = 4ul * n;
    const uint8_t* p = body.data();
    for (uint32_t i = 0; i < n; i++) {
      uint32_t len = get_u32(p + 4ul * i);
      if ((uint64_t)len > (uint64_t)body_len - off) {
        corrupt = true;
        records.clear();
        return false;
      }
      records.emplace_back(body.begin() + off, body.begin() + off + len);
      off += len;
    }
    return true;
  }
};

// -- prefetcher -------------------------------------------------------------
// N worker threads each own a disjoint set of files and push records into a
// bounded queue; the consumer pops.  This is the double-buffer thread of the
// reference DataProvider generalized to a pool.
struct Prefetcher {
  std::vector<std::string> paths;
  size_t capacity;
  std::deque<std::vector<uint8_t>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  int active_workers = 0;
  bool stop = false;
  bool error = false;  // IO/corruption seen by any worker
  std::vector<uint8_t> current;

  void set_error() {
    std::unique_lock<std::mutex> lk(mu);
    error = true;
  }

  void worker(size_t begin, size_t end) {
    for (size_t i = begin; i < end && !stopped(); i++) {
      FILE* f = fopen(paths[i].c_str(), "rb");
      if (!f) {
        set_error();
        continue;
      }
      Reader r;
      r.f = f;
      while (!stopped() && (!r.records.empty() || r.load_chunk())) {
        while (!r.records.empty()) {
          std::vector<uint8_t> rec = std::move(r.records.front());
          r.records.pop_front();
          std::unique_lock<std::mutex> lk(mu);
          cv_push.wait(lk, [&] { return queue.size() < capacity || stop; });
          if (stop) break;
          queue.push_back(std::move(rec));
          cv_pop.notify_one();
        }
      }
      if (r.corrupt) set_error();
      fclose(f);
    }
    std::unique_lock<std::mutex> lk(mu);
    if (--active_workers == 0) cv_pop.notify_all();
  }

  bool stopped() {
    std::unique_lock<std::mutex> lk(mu);
    return stop;
  }
};

}  // namespace

extern "C" {

// ---- writer ----
void* rio_writer_create(const char* path, uint32_t max_chunk_records,
                        uint32_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->max_chunk_records = max_chunk_records ? max_chunk_records : 1000;
  w->max_chunk_bytes = max_chunk_bytes ? max_chunk_bytes : (1u << 20);
  return w;
}

int rio_writer_write(void* handle, const uint8_t* data, uint32_t len) {
  Writer* w = (Writer*)handle;
  w->pending.emplace_back(data, data + len);
  w->pending_bytes += len;
  if (w->pending.size() >= w->max_chunk_records ||
      w->pending_bytes >= w->max_chunk_bytes)
    return w->flush();
  return 0;
}

int rio_writer_close(void* handle) {
  Writer* w = (Writer*)handle;
  int rc = w->flush();
  if (fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

// ---- reader ----
void* rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->f = f;
  return r;
}

// Seek to a chunk's byte offset (for master task partitioning).
int rio_reader_seek(void* handle, uint64_t offset) {
  Reader* r = (Reader*)handle;
  r->records.clear();
  return fseek(r->f, (long)offset, SEEK_SET);
}

// Returns record length and sets *out to an internal buffer valid until the
// next call; -1 at EOF, -2 on corruption.
int64_t rio_reader_next(void* handle, const uint8_t** out) {
  Reader* r = (Reader*)handle;
  if (r->records.empty() && !r->load_chunk())
    return r->corrupt ? -2 : -1;
  r->current = std::move(r->records.front());
  r->records.pop_front();
  *out = r->current.data();
  return (int64_t)r->current.size();
}

void rio_reader_close(void* handle) {
  Reader* r = (Reader*)handle;
  fclose(r->f);
  delete r;
}

// ---- chunk index scan (master task partitioning) ----
// Fills offsets[]/counts[] with each chunk's byte offset and record count.
// Returns number of chunks, or -1 on malformed file.
int64_t rio_scan_chunks(const char* path, uint64_t* offsets, uint32_t* counts,
                        int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return -1;
  }
  long fsize_l = ftell(f);
  if (fsize_l < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  uint64_t fsize = (uint64_t)fsize_l;
  int64_t n = 0;
  uint8_t head[16];
  uint64_t pos = 0;
  while (fread(head, 1, 16, f) == 16) {
    if (get_u32(head) != kMagic) {
      fclose(f);
      return -1;
    }
    uint32_t body_len = get_u32(head + 8);
    uint32_t n_rec = get_u32(head + 12);
    // Header fields are not covered by the CRC: a chunk whose claimed body
    // overruns the file, or whose length table alone exceeds the body, marks
    // the file malformed instead of producing a phantom chunk index.
    if (4ull * n_rec > body_len || pos + 16 + (uint64_t)body_len > fsize) {
      fclose(f);
      return -1;
    }
    if (n < cap) {
      offsets[n] = pos;
      counts[n] = n_rec;
    }
    n++;
    pos += 16 + body_len;
    if (fseek(f, (long)pos, SEEK_SET) != 0) break;
  }
  fclose(f);
  return n;
}

// ---- prefetcher ----
void* rio_prefetcher_create(const char** paths, int32_t n_paths,
                            int32_t n_threads, int32_t capacity) {
  Prefetcher* p = new Prefetcher();
  for (int32_t i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? capacity : 1024;
  if (n_threads <= 0) n_threads = 2;
  if (n_threads > n_paths) n_threads = n_paths > 0 ? n_paths : 1;
  p->active_workers = n_threads;
  size_t per = (p->paths.size() + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    size_t b = t * per, e = std::min(p->paths.size(), (t + 1) * per);
    p->workers.emplace_back([p, b, e] { p->worker(b, e); });
  }
  return p;
}

// Blocks until a record is available or all workers finished.
// Returns length (with *out set), -1 at clean end of stream, or -2 when a
// worker hit an unopenable/corrupt file (after serving what it could).
int64_t rio_prefetcher_next(void* handle, const uint8_t** out) {
  Prefetcher* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_pop.wait(lk, [&] { return !p->queue.empty() || p->active_workers == 0; });
  if (p->queue.empty()) return p->error ? -2 : -1;
  p->current = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_push.notify_one();
  *out = p->current.data();
  return (int64_t)p->current.size();
}

void rio_prefetcher_destroy(void* handle) {
  Prefetcher* p = (Prefetcher*)handle;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_push.notify_all();
    p->cv_pop.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
