// Native LMDB dataset reader (C ABI, loaded via ctypes).
//
// The reference reads Caffe LMDB databases through liblmdb + libprotobuf
// (src/worker/layer.cc:237-328); this is the port's copy of the JAX
// package's native walker (singa_tpu/native/lmdbcodec.cc): it walks an
// LMDB 0.9 data.mdb B+tree (main DB only, 64-bit LE layout — the same
// subset singa_tpu_torch/data/lmdbio.py reads) and decodes each Caffe
// Datum into dense float32/int32 arrays in one pass, no Python in the
// per-record loop. singa_tpu_torch.data.pipeline.load_lmdb_arrays takes
// it first; only a mixed-geometry database (-5) goes on to the Python
// reader, every other error code raises. Tests hold both to the same
// arrays.
//
// Build: g++ -O2 -shared -fPIC -o liblmdbcodec.so lmdbcodec.cc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr uint64_t kInvalidPage = ~0ULL;
constexpr uint16_t P_BRANCH = 0x01, P_LEAF = 0x02, P_OVERFLOW = 0x04,
                   P_META = 0x08, P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01, F_SUBDATA = 0x02, F_DUPDATA = 0x04;
constexpr size_t kPageHdr = 16;

struct FileBuf {
  std::vector<uint8_t> data;
  bool ok = false;
  explicit FileBuf(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n >= 0) {
      data.resize(static_cast<size_t>(n));
      ok = n == 0 || std::fread(data.data(), 1, data.size(), f) == data.size();
    }
    std::fclose(f);
  }
};

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

struct Meta {
  uint64_t psize = 0, root = kInvalidPage, entries = 0, txnid = 0;
  uint16_t flags = 0;
  bool ok = false;
};

// Meta layout after the 16-byte page header: magic u32 | version u32 |
// address u64 | mapsize u64 | MDB_db[2] (48B each: pad u32, flags u16,
// depth u16, branch/leaf/overflow/entries/root u64) | last_pg | txnid.
Meta parse_meta(const uint8_t* buf, size_t len, size_t off) {
  Meta m;
  if (off + kPageHdr + 136 > len) return m;
  const uint8_t* p = buf + off;
  if (!(rd16(p + 10) & P_META)) return m;
  const uint8_t* mm = p + kPageHdr;
  if (rd32(mm) != kMagic || rd32(mm + 4) != kVersion) return m;
  m.psize = rd32(mm + 24);           // free DB md_pad doubles as psize
  const uint8_t* main_db = mm + 24 + 48;
  m.flags = rd16(main_db + 4);
  m.entries = rd64(main_db + 32);  // pad4+flags2+depth2+branch8+leaf8+ovfl8
  m.root = rd64(main_db + 40);
  m.txnid = rd64(mm + 24 + 96 + 8);
  m.ok = true;
  return m;
}

// ------------------------------------------------------ Datum decode ----

bool read_varint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len && shift < 64) {
    uint8_t b = buf[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

struct Datum {
  int32_t channels = 0, height = 0, width = 0, label = 0;
  const uint8_t* pix = nullptr;
  size_t pix_len = 0;
  std::vector<float> floats;
  bool encoded = false;
};

bool decode_datum(const uint8_t* buf, size_t len, Datum* d) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t tag, v;
    if (!read_varint(buf, len, &pos, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3), wt = tag & 7;
    if (wt == 0 && (field <= 3 || field == 5 || field == 7)) {
      if (!read_varint(buf, len, &pos, &v)) return false;
      int32_t iv = static_cast<int32_t>(v);
      if (field == 1) d->channels = iv;
      else if (field == 2) d->height = iv;
      else if (field == 3) d->width = iv;
      else if (field == 5) d->label = iv;
      else d->encoded = v != 0;
    } else if (field == 4 && wt == 2) {
      if (!read_varint(buf, len, &pos, &v) || v > len - pos) return false;
      d->pix = buf + pos;
      d->pix_len = v;
      pos += v;
    } else if (field == 6 && wt == 5) {
      if (len - pos < 4) return false;
      float f;
      std::memcpy(&f, buf + pos, 4);
      d->floats.push_back(f);
      pos += 4;
    } else if (field == 6 && wt == 2) {  // packed floats
      if (!read_varint(buf, len, &pos, &v) || v > len - pos || v % 4)
        return false;
      size_t n = v / 4, old = d->floats.size();
      d->floats.resize(old + n);
      std::memcpy(d->floats.data() + old, buf + pos, v);
      pos += v;
    } else {  // unknown field: skip by wire type
      switch (wt) {
        case 0:
          if (!read_varint(buf, len, &pos, &v)) return false;
          break;
        case 1:
          if (len - pos < 8) return false;
          pos += 8;
          break;
        case 2:
          if (!read_varint(buf, len, &pos, &v) || v > len - pos) return false;
          pos += v;
          break;
        case 5:
          if (len - pos < 4) return false;
          pos += 4;
          break;
        default:
          return false;
      }
    }
  }
  return true;
}

// ------------------------------------------------------- tree walker ----

struct Walker {
  const std::vector<uint8_t>& buf;
  uint64_t psize;
  uint64_t npages;         // pages in the file: wrap-safe bounds domain
  uint64_t visit_budget;   // total page visits; bounds corrupt cycles
  int64_t rc = 0;  // first error
  int64_t sample = -1;
  int32_t shape[3] = {0, 0, 0};
  std::vector<float> pixels;
  std::vector<int32_t> labels;

  Walker(const std::vector<uint8_t>& b, uint64_t ps)
      : buf(b), psize(ps), npages(b.size() / ps),
        visit_budget(b.size() / ps + 1) {}

  const uint8_t* page(uint64_t pgno) {
    // division-form check: (pgno+1)*psize can wrap uint64 on crafted pgnos
    if (pgno >= npages) return nullptr;
    return buf.data() + pgno * psize;
  }

  bool value(const uint8_t* val, size_t len) {
    Datum d;
    if (!decode_datum(val, len, &d) || d.encoded) {
      rc = -3;
      return false;
    }
    // overflow-checked C*H*W: corrupt dims must become a clean reject,
    // not signed-overflow UB or a doomed multi-GB resize below
    if (d.channels <= 0 || d.height <= 0 || d.width <= 0) {
      rc = -4;
      return false;
    }
    int64_t n = static_cast<int64_t>(d.channels) * d.height;
    if (n > INT64_MAX / d.width) {
      rc = -4;
      return false;
    }
    n *= d.width;
    if (sample < 0) {
      sample = n;
      shape[0] = d.channels;
      shape[1] = d.height;
      shape[2] = d.width;
    }
    if (n != sample) {
      rc = -5;  // mixed geometry: nothing can batch it; the Python
                // fallback raises the descriptive error
      return false;
    }
    // payload size must match BEFORE the dense arrays grow, so every
    // resize is bounded by bytes actually present in the file
    if (d.pix_len) {
      if (static_cast<int64_t>(d.pix_len) != sample) {
        rc = -5;
        return false;
      }
    } else if (static_cast<int64_t>(d.floats.size()) != sample) {
      rc = -5;
      return false;
    }
    size_t old = pixels.size();
    pixels.resize(old + sample);
    float* dst = pixels.data() + old;
    if (d.pix_len) {
      for (int64_t i = 0; i < sample; ++i)
        dst[i] = static_cast<float>(d.pix[i]);
    } else {
      std::memcpy(dst, d.floats.data(), sample * sizeof(float));
    }
    labels.push_back(d.label);
    return true;
  }

  bool walk(uint64_t pgno, int depth) {
    // a corrupt cyclic tree can't visit more pages than the file holds
    if (depth > 64 || visit_budget-- == 0) {
      rc = -3;
      return false;
    }
    const uint8_t* p = page(pgno);
    if (!p) {
      rc = -3;
      return false;
    }
    uint16_t flags = rd16(p + 10);
    uint16_t lower = rd16(p + 12);
    if (flags & P_LEAF2) {
      rc = -4;
      return false;
    }
    if (lower < kPageHdr || lower > psize) {
      rc = -3;
      return false;
    }
    size_t nkeys = (lower - kPageHdr) >> 1;
    for (size_t i = 0; i < nkeys; ++i) {
      uint16_t off = rd16(p + kPageHdr + 2 * i);
      if (off + 8u > psize) {
        rc = -3;
        return false;
      }
      const uint8_t* node = p + off;
      uint16_t lo = rd16(node), hi = rd16(node + 2), nflags = rd16(node + 4),
               ksize = rd16(node + 6);
      if (flags & P_BRANCH) {
        uint64_t child = static_cast<uint64_t>(lo) |
                         (static_cast<uint64_t>(hi) << 16) |
                         (static_cast<uint64_t>(nflags) << 32);
        if (!walk(child, depth + 1)) return false;
      } else if (flags & P_LEAF) {
        if (nflags & (F_SUBDATA | F_DUPDATA)) {
          rc = -4;
          return false;
        }
        uint64_t dsize =
            static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 16);
        size_t dstart = off + 8 + ksize;
        if (nflags & F_BIGDATA) {
          if (dstart + 8 > psize) {
            rc = -3;
            return false;
          }
          uint64_t ov = rd64(node + 8 + ksize);
          const uint8_t* op = page(ov);
          if (!op || !(rd16(op + 10) & P_OVERFLOW)) {
            rc = -3;
            return false;
          }
          uint32_t chain = rd32(op + 12);
          // division-form bounds: multiplication could wrap on crafted
          // page counts
          if (chain == 0 || ov >= npages || chain > npages - ov ||
              dsize > static_cast<uint64_t>(chain) * psize - kPageHdr) {
            rc = -3;
            return false;
          }
          if (!value(op + kPageHdr, dsize)) return false;
        } else {
          if (dstart + dsize > psize) {
            rc = -3;
            return false;
          }
          if (!value(node + 8 + ksize, dsize)) return false;
        }
      } else {
        rc = -3;
        return false;
      }
    }
    return true;
  }
};

// Heap handle owning the decoded arrays: the caller reads the exposed
// pointers, copies into its own storage, and releases the whole result
// with lc_free_result — no malloc+memcpy duplication of the dataset.
struct Result {
  std::vector<float> pixels;
  std::vector<int32_t> labels;
};

}  // namespace

extern "C" {

// Decode every Datum of an LMDB main database (data.mdb at `path`) into
// dense arrays: float32 pixels ((N, C, H, W) order, uint8 payloads
// widened like the reference's cast, layer.cc:390-400) and int32 labels.
// shape receives (C, H, W); *handle_out receives an opaque owner the
// caller must release with lc_free_result after copying out of
// *pixels_out / *labels_out. Returns the record count, or <0: -1
// open/alloc, -2 empty, -3 corrupt, -4 unsupported feature, -5 mixed
// geometry (callers fall back to the Python codec on any error).
int64_t lc_load_dataset(const char* path, void** handle_out,
                        float** pixels_out, int32_t** labels_out,
                        int32_t* shape_out) try {
  FileBuf fb(path);
  if (!fb.ok || fb.data.size() < 2 * 512) return -1;
  Meta m0 = parse_meta(fb.data.data(), fb.data.size(), 0);
  Meta best = m0;
  if (m0.ok) {
    Meta m1 = parse_meta(fb.data.data(), fb.data.size(), m0.psize);
    if (m1.ok && m1.txnid > m0.txnid) best = m1;
  } else {
    for (uint64_t ps : {4096u, 8192u, 16384u, 32768u, 65536u}) {
      Meta m1 = parse_meta(fb.data.data(), fb.data.size(), ps);
      if (m1.ok && m1.psize == ps) {
        best = m1;
        break;
      }
    }
  }
  if (!best.ok) return -3;
  if (best.psize < 512 || (best.psize & (best.psize - 1))) return -3;
  if (best.flags & ~0x08) return -4;  // dupsort/sub-databases
  if (best.root == kInvalidPage) return -2;

  Walker w(fb.data, best.psize);
  if (!w.walk(best.root, 0)) return w.rc ? w.rc : -3;
  if (w.labels.empty()) return -2;

  Result* res = new Result{std::move(w.pixels), std::move(w.labels)};
  *handle_out = res;
  *pixels_out = res->pixels.data();
  *labels_out = res->labels.data();
  shape_out[0] = w.shape[0];
  shape_out[1] = w.shape[1];
  shape_out[2] = w.shape[2];
  return static_cast<int64_t>(res->labels.size());
} catch (...) {
  // bad_alloc on huge/sparse files etc. must not cross the C ABI —
  // report failure and let the Python reader take over
  return -1;
}

void lc_free_result(void* handle) {
  delete static_cast<Result*>(handle);
}

}  // extern "C"
