// recordio: chunked record file format, C ABI for ctypes.
//
// Wire-format compatible with the reference implementation
// (paddle/fluid/recordio/{header,chunk}.{h,cc}): a file is a sequence of
// chunks; each chunk is five little-endian uint32s
//   magic=0x01020304, num_records, crc32(payload), compressor, payload_size
// followed by the payload: per record a uint32 length then the bytes,
// the whole payload optionally compressed. Compressor 0 = none, 2 = gzip
// (zlib). Snappy (1) is not built here: the era's default was none, and
// zlib ships in every image while snappy does not.
//
// Architecture differs from the reference deliberately: one translation
// unit, C ABI (for ctypes), stdio + flat buffers instead of iostreams —
// the data path feeds the host side of the input pipeline where the
// scanner's per-chunk buffer is reused across records (zero-copy yields).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x01020304u;
enum Compressor : uint32_t { kNone = 0, kSnappy = 1, kGzip = 2 };

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kNone;
  uint32_t max_records = 1000;     // chunk flush thresholds
  size_t max_bytes = 1 << 20;
  std::string payload;             // uncompressed chunk payload
  uint32_t num_records = 0;
  bool error = false;
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint8_t> payload;    // current chunk, decompressed
  size_t pos = 0;                  // cursor into payload
  uint32_t remaining = 0;          // records left in current chunk
  bool error = false;
};

bool write_u32(FILE* f, uint32_t v) {
  uint8_t b[4] = {uint8_t(v), uint8_t(v >> 8), uint8_t(v >> 16),
                  uint8_t(v >> 24)};
  return fwrite(b, 1, 4, f) == 4;
}

bool read_u32(FILE* f, uint32_t* v) {
  uint8_t b[4];
  if (fread(b, 1, 4, f) != 4) return false;
  *v = uint32_t(b[0]) | uint32_t(b[1]) << 8 | uint32_t(b[2]) << 16 |
       uint32_t(b[3]) << 24;
  return true;
}

bool flush_chunk(Writer* w) {
  if (w->num_records == 0) return true;
  const uint8_t* data = reinterpret_cast<const uint8_t*>(w->payload.data());
  size_t len = w->payload.size();
  std::vector<uint8_t> zbuf;
  if (w->compressor == kGzip) {
    uLongf zlen = compressBound(len);
    zbuf.resize(zlen);
    if (compress2(zbuf.data(), &zlen, data, len, Z_DEFAULT_COMPRESSION) !=
        Z_OK)
      return false;
    data = zbuf.data();
    len = zlen;
  } else if (w->compressor != kNone) {
    return false;  // snappy not built
  }
  uint32_t crc = uint32_t(crc32(crc32(0, nullptr, 0), data, len));
  if (!write_u32(w->f, kMagic) || !write_u32(w->f, w->num_records) ||
      !write_u32(w->f, crc) || !write_u32(w->f, w->compressor) ||
      !write_u32(w->f, uint32_t(len)))
    return false;
  if (fwrite(data, 1, len, w->f) != len) return false;
  w->payload.clear();
  w->num_records = 0;
  return true;
}

bool load_chunk(Scanner* s) {
  uint32_t magic;
  if (!read_u32(s->f, &magic)) return false;  // clean EOF
  if (magic != kMagic) {
    s->error = true;
    return false;
  }
  uint32_t num, crc, comp, len;
  if (!read_u32(s->f, &num) || !read_u32(s->f, &crc) ||
      !read_u32(s->f, &comp) || !read_u32(s->f, &len)) {
    s->error = true;
    return false;
  }
  std::vector<uint8_t> raw(len);
  if (len && fread(raw.data(), 1, len, s->f) != len) {
    s->error = true;
    return false;
  }
  if (uint32_t(crc32(crc32(0, nullptr, 0), raw.data(), len)) != crc) {
    s->error = true;
    return false;
  }
  if (comp == kGzip) {
    // format stores no uncompressed size; retry with a doubling buffer
    uLongf cap = len ? len * 4 + 64 : 64;
    for (;;) {
      s->payload.resize(cap);
      uLongf out = cap;
      int rc = uncompress(s->payload.data(), &out, raw.data(), len);
      if (rc == Z_OK) {
        s->payload.resize(out);
        break;
      }
      if (rc != Z_BUF_ERROR || cap > (1u << 30)) {
        s->error = true;
        return false;
      }
      cap *= 2;
    }
  } else if (comp == kNone) {
    s->payload = std::move(raw);
  } else {
    s->error = true;
    return false;
  }
  s->pos = 0;
  s->remaining = num;
  return true;
}

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, uint32_t compressor,
                      uint32_t max_records, uint64_t max_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  if (max_records) w->max_records = max_records;
  if (max_bytes) w->max_bytes = size_t(max_bytes);
  return w;
}

int rio_writer_write(void* h, const uint8_t* data, uint32_t len) {
  Writer* w = static_cast<Writer*>(h);
  if (w->error) return -1;
  uint8_t b[4] = {uint8_t(len), uint8_t(len >> 8), uint8_t(len >> 16),
                  uint8_t(len >> 24)};
  w->payload.append(reinterpret_cast<const char*>(b), 4);
  w->payload.append(reinterpret_cast<const char*>(data), len);
  w->num_records++;
  if (w->num_records >= w->max_records || w->payload.size() >= w->max_bytes) {
    if (!flush_chunk(w)) {
      w->error = true;
      return -1;
    }
  }
  return 0;
}

int rio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  int rc = 0;
  if (!flush_chunk(w)) rc = -1;
  if (w->f && fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// 1 = record produced (data/len point into scanner-owned buffer, valid until
// the next call), 0 = EOF, -1 = corrupt file
int rio_scanner_next(void* h, const uint8_t** data, uint32_t* len) {
  Scanner* s = static_cast<Scanner*>(h);
  while (s->remaining == 0) {
    if (!load_chunk(s)) return s->error ? -1 : 0;
  }
  if (s->pos + 4 > s->payload.size()) {
    s->error = true;
    return -1;
  }
  const uint8_t* p = s->payload.data() + s->pos;
  uint32_t n = uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
               uint32_t(p[3]) << 24;
  s->pos += 4;
  if (s->pos + n > s->payload.size()) {
    s->error = true;
    return -1;
  }
  *data = s->payload.data() + s->pos;
  *len = n;
  s->pos += n;
  s->remaining--;
  return 1;
}

void rio_scanner_close(void* h) {
  Scanner* s = static_cast<Scanner*>(h);
  if (s->f) fclose(s->f);
  delete s;
}

}  // extern "C"
