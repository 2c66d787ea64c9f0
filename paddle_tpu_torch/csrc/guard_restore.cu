// The gate of a numerically guarded training step, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package gates a guarded step's state
// update with ONE lax.cond over the whole state set (guard_select_all,
// paddle_tpu/ops/guard_ops.py:87-102), which XLA turns into a device-side
// branch. The port's update rules return new tensors, so after the update
// each gated var has its new value X and its pre-step value Y (the
// guard_backup alias). guard_restore writes Y over X, byte for byte, in
// place, where the step's all-finite flag is false, and does nothing where
// it is true: one launch covers up to kMaxSegs vars, each block reading the
// flag first. A healthy step (the common case) reads one byte a block; a
// tripped one copies the state set once.
//
// The plain torch form (`torch.where(ok, x, y)` a var, then the copy)
// reads X and Y and writes X on every step, healthy or not, one launch a
// var, and with the 0-d flag broadcast torch runs its non-vectorized
// elementwise kernel (chip_smoke.py times both: the guard_restore row).
//
// The segment table goes by value in the kernel's parameters (24 bytes a
// var, under the 4 KB parameter limit), so a CUDA graph captures it with
// the launch; the pointers are the capture's, which its replays reuse.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegs = 96;     // (dst, src, bytes) a launch
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;   // blocks a var (grid.x)

struct Seg {
  char* dst;
  const char* src;
  long long bytes;
};

struct Table {
  Seg seg[kMaxSegs];
};

__global__ void __launch_bounds__(kThreads)
    guard_restore_kernel(const bool* __restrict__ ok, Table table) {
  if (*ok) return;  // the step was all-finite: its update stands
  const Seg s = table.seg[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(s.dst) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(s.src) % 16 == 0);
  const long long n16 = aligned ? s.bytes / 16 : 0;
  int4* dst16 = reinterpret_cast<int4*>(s.dst);
  const int4* src16 = reinterpret_cast<const int4*>(s.src);
  for (long long k = first; k < n16; k += stride) dst16[k] = src16[k];
  for (long long k = n16 * 16 + first; k < s.bytes; k += stride)
    s.dst[k] = s.src[k];
}

}  // namespace

// Launch guard_restore on `stream` for n vars: dst[i] <- src[i] (bytes[i]
// bytes each) where *ok is false. Writes the number of launches (one per
// kMaxSegs vars) to *launches. Returns a cudaError_t (0 on success).
extern "C" int ptt_guard_restore(const void* ok, int n, void* const* dst,
                                 const void* const* src,
                                 const long long* bytes, void* stream,
                                 int* launches) {
  *launches = 0;
  for (int base = 0; base < n; base += kMaxSegs) {
    const int m = n - base < kMaxSegs ? n - base : kMaxSegs;
    Table table;
    long long widest = 1;
    for (int j = 0; j < m; ++j) {
      table.seg[j].dst = static_cast<char*>(dst[base + j]);
      table.seg[j].src = static_cast<const char*>(src[base + j]);
      table.seg[j].bytes = bytes[base + j];
      if (bytes[base + j] > widest) widest = bytes[base + j];
    }
    // enough blocks for the widest var at 16 bytes a thread and 8 loads
    // a thread, at most kMaxBlocks
    long long blocks = (widest + 16LL * kThreads * 8 - 1) /
                       (16LL * kThreads * 8);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(m));
    guard_restore_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bool*>(ok), table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
