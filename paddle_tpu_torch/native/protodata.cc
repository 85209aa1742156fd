// Native decoder for the DataFormat.proto binary stream — the data-loader
// hot path (dense image + index label files like the reference's
// mnist_bin_part).  Mirrors the wire-format rules of io/protodata.py:
// varint32-framed proto2 messages (ProtoReader.h:53), DataHeader then
// DataSamples.  Scope: the DENSE+INDEX fast path, decoded in one pass into
// contiguous buffers the Python side wraps as numpy arrays; sparse /
// sequence / gzip files take the pure-Python decoder instead.
//
// C ABI (ctypes):
//   pdx_scan(path, &n_samples, &n_slots, types[], dims[], max_slots)
//   pdx_decode_dense_index(path, dense_ptrs[], index_ptrs[], expected)
// Buffers are allocated by the CALLER (numpy) at the sizes pdx_scan
// reports; decode fills them and refuses files whose sample count no
// longer matches `expected`.  Returns 0 on success, negative error codes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buf {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  uint64_t varint() {
    uint64_t out = 0;
    int shift = 0;
    while (pos < n) {
      uint8_t b = p[pos++];
      out |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return out;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  bool read_file(const char* path, std::string* store) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    store->resize(static_cast<size_t>(sz));
    size_t got = sz ? std::fread(&(*store)[0], 1, sz, f) : 0;
    std::fclose(f);
    if (got != static_cast<size_t>(sz)) return false;
    p = reinterpret_cast<const uint8_t*>(store->data());
    n = store->size();
    pos = 0;
    return true;
  }
};

constexpr int kDense = 0;  // SlotDef::VECTOR_DENSE
constexpr int kIndex = 3;  // SlotDef::INDEX

struct SlotDef {
  int type = -1;
  uint32_t dim = 0;
};

bool parse_header(const uint8_t* msg, size_t len, std::vector<SlotDef>* defs) {
  Buf b{msg, len};
  while (b.pos < b.n && b.ok) {
    uint64_t key = b.varint();
    int field = static_cast<int>(key >> 3), wt = static_cast<int>(key & 7);
    if (field == 1 && wt == 2) {  // SlotDef submessage
      uint64_t sz = b.varint();
      if (!b.ok || sz > b.n - b.pos) return false;
      Buf s{b.p + b.pos, static_cast<size_t>(sz)};
      SlotDef d;
      while (s.pos < s.n && s.ok) {
        uint64_t k2 = s.varint();
        int f2 = static_cast<int>(k2 >> 3), w2 = static_cast<int>(k2 & 7);
        uint64_t v = (w2 == 0) ? s.varint() : 0;
        if (w2 != 0) return false;  // SlotDef only has varint fields
        if (f2 == 1) d.type = static_cast<int>(v);
        if (f2 == 2) d.dim = static_cast<uint32_t>(v);
      }
      if (!s.ok) return false;
      defs->push_back(d);
      b.pos += sz;
    } else {
      return false;  // unexpected field in DataHeader
    }
  }
  return b.ok && !defs->empty();
}

// Walk one DataSample; when fill buffers are given, copy dense floats /
// index ids into them (per-kind running offsets).  Returns false on any
// wire-format surprise or a non-fast-path feature (sparse ids, strings,
// subseq slots).
bool walk_sample(const uint8_t* msg, size_t len,
                 const std::vector<SlotDef>& defs,
                 float** dense_fill, int32_t** index_fill,
                 size_t sample_idx) {
  Buf b{msg, len};
  size_t vec_i = 0;   // which dense slot (in slot order of kind)
  size_t idx_i = 0;   // which index value
  // Declared slot counts, computed up front: every write below must be
  // bounded by these.  The caller allocates exactly want_vec/want_idx
  // pointers, and the file content is re-read after pdx_scan (whose result
  // may come from a cache), so a sample with more slots than declared must
  // fail cleanly here rather than index past the pointer arrays.
  size_t want_vec = 0, want_idx = 0;
  for (const auto& d : defs) {
    if (d.type == kDense) ++want_vec;
    else if (d.type == kIndex) ++want_idx;
    else return false;
  }
  while (b.pos < b.n && b.ok) {
    uint64_t key = b.varint();
    int field = static_cast<int>(key >> 3), wt = static_cast<int>(key & 7);
    if (field == 1 && wt == 0) {        // is_beginning
      b.varint();
    } else if (field == 2 && wt == 2) { // VectorSlot
      uint64_t sz = b.varint();
      if (!b.ok || sz > b.n - b.pos) return false;
      Buf s{b.p + b.pos, static_cast<size_t>(sz)};
      bool saw_values = false;
      while (s.pos < s.n && s.ok) {
        uint64_t k2 = s.varint();
        int f2 = static_cast<int>(k2 >> 3), w2 = static_cast<int>(k2 & 7);
        if (f2 == 1 && w2 == 2) {  // packed float values
          uint64_t bytes = s.varint();
          if (!s.ok || bytes > s.n - s.pos || bytes % 4) return false;
          if (vec_i >= want_vec) return false;
          if (dense_fill) {
            // find the vec_i-th DENSE slot's dim for bounds checking
            size_t seen = 0;
            uint32_t dim = 0;
            for (const auto& d : defs) {
              if (d.type == kDense) {
                if (seen == vec_i) { dim = d.dim; break; }
                ++seen;
              }
            }
            if (bytes / 4 != dim) return false;
            std::memcpy(dense_fill[vec_i] + sample_idx * dim,
                        s.p + s.pos, bytes);
          }
          s.pos += bytes;
          saw_values = true;
        } else if (f2 == 1 && w2 == 5) {  // unpacked single float
          return false;  // rare; let Python handle it
        } else {
          return false;  // ids/dims/strs => not the fast path
        }
      }
      if (!s.ok || !saw_values) return false;
      ++vec_i;
      b.pos += sz;
    } else if (field == 3 && (wt == 2 || wt == 0)) {  // id_slots
      if (wt == 2) {
        uint64_t bytes = b.varint();
        if (!b.ok || bytes > b.n - b.pos) return false;
        Buf s{b.p + b.pos, static_cast<size_t>(bytes)};
        while (s.pos < s.n && s.ok) {
          uint64_t v = s.varint();
          if (idx_i >= want_idx) return false;
          if (index_fill) index_fill[idx_i][sample_idx] = static_cast<int32_t>(v);
          ++idx_i;
        }
        if (!s.ok) return false;
        b.pos += bytes;
      } else {
        uint64_t v = b.varint();
        if (idx_i >= want_idx) return false;
        if (index_fill) index_fill[idx_i][sample_idx] = static_cast<int32_t>(v);
        ++idx_i;
      }
    } else {
      return false;  // var_id_slots / subseq_slots => not the fast path
    }
  }
  if (!b.ok) return false;
  // every declared slot must have appeared (exactly once / exactly dim ids)
  return vec_i == want_vec && idx_i == want_idx;
}

}  // namespace

extern "C" {

// Scan: header + sample count; verifies every sample is dense/index-only.
// Returns 0 ok, -1 io, -2 wire format, -3 not fast path, -4 too many slots.
int pdx_scan(const char* path, long long* n_samples, int* n_slots,
             int* types, unsigned int* dims, int max_slots) {
  std::string store;
  Buf b{};
  if (!b.read_file(path, &store)) return -1;
  uint64_t hlen = b.varint();
  if (!b.ok || hlen > b.n - b.pos) return -2;
  std::vector<SlotDef> defs;
  if (!parse_header(b.p + b.pos, hlen, &defs)) return -2;
  b.pos += hlen;
  if (static_cast<int>(defs.size()) > max_slots) return -4;
  for (const auto& d : defs)
    if (d.type != kDense && d.type != kIndex) return -3;
  long long count = 0;
  while (b.pos < b.n) {
    uint64_t mlen = b.varint();
    if (!b.ok || mlen > b.n - b.pos) return -2;
    if (!walk_sample(b.p + b.pos, mlen, defs, nullptr, nullptr, 0)) return -3;
    b.pos += mlen;
    ++count;
  }
  *n_samples = count;
  *n_slots = static_cast<int>(defs.size());
  for (size_t i = 0; i < defs.size(); ++i) {
    types[i] = defs[i].type;
    dims[i] = defs[i].dim;
  }
  return 0;
}

// Decode into caller-allocated buffers: dense_ptrs[i] -> [expected, dim_i]
// f32 (slot order among DENSE slots), index_ptrs[j] -> [expected] int32.
// `expected` is the sample count pdx_scan reported — a file that changed
// size since the scan returns -5 instead of overflowing the buffers.
int pdx_decode_dense_index(const char* path, float** dense_ptrs,
                           int32_t** index_ptrs, long long expected) {
  std::string store;
  Buf b{};
  if (!b.read_file(path, &store)) return -1;
  uint64_t hlen = b.varint();
  if (!b.ok || hlen > b.n - b.pos) return -2;
  std::vector<SlotDef> defs;
  if (!parse_header(b.p + b.pos, hlen, &defs)) return -2;
  b.pos += hlen;
  size_t i = 0;
  while (b.pos < b.n) {
    if (static_cast<long long>(i) >= expected) return -5;  // file grew since scan
    uint64_t mlen = b.varint();
    if (!b.ok || mlen > b.n - b.pos) return -2;
    if (!walk_sample(b.p + b.pos, mlen, defs, dense_ptrs, index_ptrs, i))
      return -3;
    b.pos += mlen;
    ++i;
  }
  return (static_cast<long long>(i) == expected) ? 0 : -5;
}

}  // extern "C"
