// Native shard/record codec (C ABI, loaded via ctypes).
//
// The reference keeps its whole data layer in C++ — the shard record file
// (src/utils/shard.cc), the protobuf Record codec (src/proto/model.proto:
// 279-305 via libprotobuf), and the dataset->shard loader
// (tools/data_loader/). This is the port's copy of the JAX package's
// native codec (singa_tpu/native/shardcodec.cc): it scans/loads/writes
// shard.dat files and encodes/decodes the proto2 Record wire format
// without Python in the per-record loop. singa_tpu_torch.data.pipeline
// and the loader take it first (singa_tpu_torch/native/__init__.py builds
// it with g++); tests hold it to the Python codec, byte for byte.
//
// Three repairs over the original:
//   - a packed `shape` field's varints are read bounded by the field's
//     end, and a field whose last varint crosses that end is malformed
//     (as in singa_tpu_torch/data/records.py);
//   - every extern "C" entry point catches any C++ exception and returns
//     an error code: nothing may cross the C ABI;
//   - a record whose shape differs from the first record's is mixed
//     geometry (-5) even when its payload has the same size, as the
//     Python codec, which stacks the records by shape, sees it.
//
// Return codes of the entry points: >= 0 success; -1 open/read/write or
// allocation failure; -2 no records; -3 a malformed record; -4 record
// geometry the codec cannot hold (a non-positive dim, more dims than the
// caller's buffer); -5 a record's shape or payload size differs from
// the first record's (mixed geometry: the Python codec's case); -6 an
// internal error (an exception caught at the C ABI).
//
// Wire format recap (shard.cc:49-67): repeated tuples
//   [u64 LE keylen][key][u64 LE vallen][val]
// where val is a proto2 Record{type=0, image={shape*, label, pixel|data*}}.
//
// Build: g++ -O2 -shared -fPIC -o libshardcodec.so shardcodec.cc

#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- io ----

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

inline uint64_t read_u64le(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // build targets are little-endian, like the ref
  return v;
}

inline void put_u64le(std::vector<uint8_t>& out, uint64_t v) {
  uint8_t b[8];
  std::memcpy(b, &v, 8);
  out.insert(out.end(), b, b + 8);
}

// ------------------------------------------------------------- varint ----

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

void write_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out.push_back(b | 0x80);
    } else {
      out.push_back(b);
      return;
    }
  }
}

// All length arithmetic uses subtraction-form bounds checks (`v > len - pos`)
// so an adversarial/corrupted u64 length can't wrap the position past
// SIZE_MAX and defeat the check — the Python reader stops gracefully at a
// corrupt tuple and the native path must too.
bool skip_field(const uint8_t* buf, size_t len, size_t* pos, uint32_t wt) {
  uint64_t tmp;
  switch (wt) {
    case 0:
      return read_varint(buf, len, pos, &tmp);
    case 1:
      if (len - *pos < 8) return false;
      *pos += 8;
      return true;
    case 2:
      if (!read_varint(buf, len, pos, &tmp)) return false;
      if (tmp > len - *pos) return false;
      *pos += tmp;
      return true;
    case 5:
      if (len - *pos < 4) return false;
      *pos += 4;
      return true;
    default:
      return false;
  }
}

// ------------------------------------------------------------- record ----

struct Image {
  std::vector<int32_t> shape;
  int32_t label = 0;
  const uint8_t* pixel = nullptr;
  size_t pixel_len = 0;
  std::vector<float> data;
};

bool decode_image(const uint8_t* buf, size_t len, Image* img) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t tag;
    if (!read_varint(buf, len, &pos, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3), wt = tag & 7;
    uint64_t v;
    if (field == 1 && wt == 0) {
      if (!read_varint(buf, len, &pos, &v)) return false;
      img->shape.push_back(static_cast<int32_t>(v));
    } else if (field == 1 && wt == 2) {  // packed repeated int32
      if (!read_varint(buf, len, &pos, &v)) return false;
      if (v > len - pos) return false;
      size_t end = pos + v;
      while (pos < end) {
        uint64_t s;
        // bounded by the field's end: a varint that runs past it is a
        // malformed field, not a read of the bytes that follow
        if (!read_varint(buf, end, &pos, &s)) return false;
        img->shape.push_back(static_cast<int32_t>(s));
      }
      if (pos != end) return false;
    } else if (field == 2 && wt == 0) {
      if (!read_varint(buf, len, &pos, &v)) return false;
      img->label = static_cast<int32_t>(v);
    } else if (field == 3 && wt == 2) {
      if (!read_varint(buf, len, &pos, &v) || v > len - pos) return false;
      img->pixel = buf + pos;
      img->pixel_len = v;
      pos += v;
    } else if (field == 4 && wt == 5) {
      if (len - pos < 4) return false;
      float f;
      std::memcpy(&f, buf + pos, 4);
      img->data.push_back(f);
      pos += 4;
    } else if (field == 4 && wt == 2) {  // packed repeated float
      if (!read_varint(buf, len, &pos, &v) || v > len - pos || v % 4)
        return false;
      size_t n = v / 4;
      size_t old = img->data.size();
      img->data.resize(old + n);
      std::memcpy(img->data.data() + old, buf + pos, v);
      pos += v;
    } else {
      if (!skip_field(buf, len, &pos, wt)) return false;
    }
  }
  return true;
}

bool decode_record(const uint8_t* buf, size_t len, Image* img, bool* found) {
  size_t pos = 0;
  *found = false;
  while (pos < len) {
    uint64_t tag;
    if (!read_varint(buf, len, &pos, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3), wt = tag & 7;
    if (field == 2 && wt == 2) {
      uint64_t ln;
      if (!read_varint(buf, len, &pos, &ln) || ln > len - pos) return false;
      if (!decode_image(buf + pos, ln, img)) return false;
      *found = true;
      pos += ln;
    } else {
      if (!skip_field(buf, len, &pos, wt)) return false;
    }
  }
  return *found;
}

// Canonical encoding, byte-identical to singa_tpu_torch.data.records.encode_record
// (unpacked repeateds, ascending field order).
void encode_record(std::vector<uint8_t>& out, const int32_t* shape,
                   int ndim, int32_t label, const uint8_t* pixel,
                   size_t pixel_len) {
  std::vector<uint8_t> img;
  for (int i = 0; i < ndim; ++i) {
    img.push_back(0x08);
    write_varint(img, static_cast<uint32_t>(shape[i]));
  }
  img.push_back(0x10);
  write_varint(img, static_cast<uint32_t>(label));
  if (pixel_len) {
    img.push_back(0x1A);
    write_varint(img, pixel_len);
    img.insert(img.end(), pixel, pixel + pixel_len);
  }
  out.push_back(0x08);  // Record.type = kSingleLabelImage (0)
  write_varint(out, 0);
  out.push_back(0x12);  // Record.image
  write_varint(out, img.size());
  out.insert(out.end(), img.begin(), img.end());
}

// Iterate complete shard tuples; cb returns false to stop early.
template <typename Fn>
size_t for_each_tuple(const std::vector<uint8_t>& buf, Fn cb,
                      uint64_t* valid_end) {
  size_t pos = 0, count = 0, end = 0;
  const uint8_t* p = buf.data();
  while (true) {
    size_t remain = buf.size() - pos;
    if (remain < 8) break;
    uint64_t keylen = read_u64le(p + pos);
    if (keylen > remain - 8 || remain - 8 - keylen < 8) break;
    const uint8_t* key = p + pos + 8;
    uint64_t vallen = read_u64le(p + pos + 8 + keylen);
    size_t val_off = pos + 8 + keylen + 8;
    if (vallen > buf.size() - val_off) break;
    if (!cb(key, keylen, p + val_off, vallen)) {
      end = val_off + vallen;
      break;
    }
    pos = val_off + vallen;
    end = pos;
    ++count;
  }
  if (valid_end) *valid_end = end;
  return count;
}

}  // namespace

// ------------------------------------------------------------- C ABI ----

extern "C" {

// Scan a shard: complete-tuple count and byte offset after the last
// complete tuple (the PrepareForAppend torn-tail boundary, shard.cc:175-206).
// Returns count, or -1 on open/read failure.
int64_t sc_scan(const char* path, uint64_t* valid_end) try {
  FileBuf fb(path);
  if (!fb.ok) return -1;
  return static_cast<int64_t>(for_each_tuple(
      fb.data, [](const uint8_t*, size_t, const uint8_t*, size_t) {
        return true;
      },
      valid_end));
} catch (...) {
  return -6;
}

// Decode the whole shard in ONE file read: the first record fixes the
// sample geometry, every record is decoded into library-allocated dense
// arrays (float32 pixels — uint8 payloads widened, the reference's cast
// dance at layer.cc:390-400 — and int32 labels). Caller must release both
// arrays with sc_free. Returns records decoded, or <0 on error (-5 = a
// record's payload size mismatched the first record's, the
// uniform-dataset contract — the caller hands such a shard to the Python
// codec; every other code is an error).
int64_t sc_load_dataset_alloc(const char* path, float** pixels_out,
                              int32_t** labels_out, int32_t* shape,
                              int32_t shape_cap, int32_t* ndim) try {
  FileBuf fb(path);
  if (!fb.ok) return -1;
  std::vector<float> pixels;
  std::vector<int32_t> labels;
  int64_t sample = -1;
  int64_t rc = 0;
  for_each_tuple(
      fb.data,
      [&](const uint8_t*, size_t, const uint8_t* val, size_t vallen) {
        Image img;
        bool found;
        if (!decode_record(val, vallen, &img, &found)) {
          rc = -3;
          return false;
        }
        if (img.shape.empty()) {
          // a shapeless record is flat: its payload length is its shape
          // (the Python codec's reshape(-1))
          int64_t flat = img.pixel_len
                             ? static_cast<int64_t>(img.pixel_len)
                             : static_cast<int64_t>(img.data.size());
          if (flat <= 0 || flat > INT32_MAX) {
            rc = -4;
            return false;
          }
          img.shape.push_back(static_cast<int32_t>(flat));
        }
        if (sample >= 0 &&
            (static_cast<int32_t>(img.shape.size()) != *ndim ||
             !std::equal(img.shape.begin(), img.shape.end(), shape))) {
          rc = -5;  // another shape, whatever its payload size
          return false;
        }
        if (sample < 0) {  // first record defines the geometry
          if (static_cast<int32_t>(img.shape.size()) > shape_cap) {
            rc = -4;
            return false;
          }
          *ndim = static_cast<int32_t>(img.shape.size());
          sample = 1;
          for (size_t i = 0; i < img.shape.size(); ++i) {
            int32_t d = img.shape[i];
            // corrupt dims must fail cleanly: d <= 0 and the
            // overflow-checked product keep `sample` well-defined
            // (a fuzzed shape once drove resize() into bad_alloc and
            // aborted the embedding process before the payload check
            // below was hoisted above the allocation)
            if (d <= 0 || sample > INT64_MAX / d) {
              rc = -4;
              return false;
            }
            shape[i] = d;
            sample *= d;
          }
        }
        // validate the payload size BEFORE growing the dense arrays:
        // a mismatched record must cost nothing, and after this check
        // every resize is bounded by bytes actually present on disk
        if (img.pixel_len) {
          if (static_cast<int64_t>(img.pixel_len) != sample) {
            rc = -5;
            return false;
          }
        } else if (static_cast<int64_t>(img.data.size()) != sample) {
          rc = -5;
          return false;
        }
        size_t old = pixels.size();
        pixels.resize(old + sample);
        float* dst = pixels.data() + old;
        if (img.pixel_len) {
          for (int64_t i = 0; i < sample; ++i)
            dst[i] = static_cast<float>(img.pixel[i]);
        } else {
          std::memcpy(dst, img.data.data(), sample * sizeof(float));
        }
        labels.push_back(img.label);
        return true;
      },
      nullptr);
  if (rc < 0) return rc;
  if (labels.empty()) return -2;
  float* p = static_cast<float*>(std::malloc(pixels.size() * sizeof(float)));
  int32_t* l =
      static_cast<int32_t*>(std::malloc(labels.size() * sizeof(int32_t)));
  if (!p || !l) {
    std::free(p);
    std::free(l);
    return -1;
  }
  std::memcpy(p, pixels.data(), pixels.size() * sizeof(float));
  std::memcpy(l, labels.data(), labels.size() * sizeof(int32_t));
  *pixels_out = p;
  *labels_out = l;
  return static_cast<int64_t>(labels.size());
} catch (...) {
  // NO C++ exception may escape the C ABI — it would std::terminate
  // the embedding Python process (a FileBuf fed a directory path
  // resizes to ftell's bogus LONG_MAX and throws bad_alloc).
  return -6;
}

void sc_free(void* p) { std::free(p); }

// Encode + append n uint8 images as Records with zero-padded index keys
// (matching singa_tpu_torch.data.loader.write_records). start_index offsets the
// keys so kAppend resumes where a crashed run stopped. Truncates the file
// at valid_end first (torn-tail recovery) when appending. Returns records
// written, or <0 on error.
int64_t sc_write_records(const char* path, const uint8_t* images,
                         const int32_t* labels, int64_t n,
                         const int32_t* shape, int32_t ndim,
                         int64_t start_index, int32_t append) try {
  int64_t sample = 1;
  for (int32_t i = 0; i < ndim; ++i) sample *= shape[i];

  if (append) {
    // drop a torn final tuple before continuing (PrepareForAppend)
    uint64_t valid_end = 0;
    if (sc_scan(path, &valid_end) >= 0 &&
        truncate(path, static_cast<off_t>(valid_end)) != 0) {
      return -1;
    }
  }
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;

  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n) * (sample + 64));
  char keybuf[32];
  for (int64_t i = 0; i < n; ++i) {
    int keylen =
        std::snprintf(keybuf, sizeof(keybuf), "%08lld",
                      static_cast<long long>(start_index + i));
    std::vector<uint8_t> rec;
    encode_record(rec, shape, ndim, labels[i],
                  images + i * sample, static_cast<size_t>(sample));
    put_u64le(out, static_cast<uint64_t>(keylen));
    out.insert(out.end(), keybuf, keybuf + keylen);
    put_u64le(out, rec.size());
    out.insert(out.end(), rec.begin(), rec.end());
  }
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  // fsync for crash durability — the torn-tail recovery contract assumes at
  // most the final tuple is lost, which page-cache-only writes would break
  // (the Python ShardWriter.flush fsyncs for the same reason)
  bool ok = written == out.size() && std::fflush(f) == 0 &&
            fsync(fileno(f)) == 0;
  std::fclose(f);
  return ok ? n : -1;
} catch (...) {
  return -6;
}

}  // extern "C"
