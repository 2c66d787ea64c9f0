// Native LoD packing: flat ragged data + offsets -> zero-padded dense
// batch, and the reverse. Parity: the reference keeps LoD manipulation in
// C++ (paddle/fluid/framework/lod_tensor.cc); here the padded-dense layout
// conversion is the per-step host hot path for EVERY sequence feed (the
// Python fallback copies one sequence slice at a time through numpy), so
// it gets the same native treatment as recordio.
//
// Build: make -C paddle_tpu/native liblodpack.so
#include <cstdint>
#include <cstring>

extern "C" {

// src: flat [total_rows, row_bytes] ragged data. offs: [n_seqs + 1] row
// offsets. dst: caller-allocated [n_seqs, max_len, row_bytes], already
// zeroed. Returns 0, or -1 on malformed offsets (non-monotonic, negative,
// past total_rows) or a sequence longer than max_len (the caller's numpy
// fallback raises for that; the native path must never silently truncate).
int ptpu_lod_pack(const char* src, const int64_t* offs, int64_t n_seqs,
                  int64_t total_rows, int64_t max_len, int64_t row_bytes,
                  char* dst) {
  for (int64_t i = 0; i < n_seqs; ++i) {
    int64_t lo = offs[i], hi = offs[i + 1];
    if (hi < lo || lo < 0 || hi > total_rows) return -1;
    int64_t len = hi - lo;
    if (len > max_len) return -1;
    memcpy(dst + i * max_len * row_bytes, src + lo * row_bytes,
           len * row_bytes);
  }
  return 0;
}

// Reverse: padded [n_seqs, max_len, row_bytes] + lengths -> flat ragged
// [sum(lengths), row_bytes]. Returns total rows written, or -1 on a
// length exceeding max_len.
int64_t ptpu_lod_unpack(const char* src, const int32_t* lengths,
                        int64_t n_seqs, int64_t max_len, int64_t row_bytes,
                        char* dst) {
  int64_t out_row = 0;
  for (int64_t i = 0; i < n_seqs; ++i) {
    int64_t len = lengths[i];
    if (len < 0 || len > max_len) return -1;
    memcpy(dst + out_row * row_bytes, src + i * max_len * row_bytes,
           len * row_bytes);
    out_row += len;
  }
  return out_row;
}

}  // extern "C"
