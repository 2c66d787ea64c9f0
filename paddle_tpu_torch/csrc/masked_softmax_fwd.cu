// Masked sequence softmax forward (softmax over the time steps of each
// row, steps past the row's length set to 0), fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_masked_softmax_kernel` (launched by `_masked_softmax_call`, wrapped by
// `masked_softmax`): for x [N, T] and lengths [N],
//   y[n, t] = exp(x[n, t] - m) / max(sum_{s < len} exp(x[n, s] - m), 1e-30)
// for t < len[n], with m the row's max over t < len[n], and y[n, t] = 0 for
// t >= len[n]; a row of length 0 is all 0 and never NaN. The TPU kernel
// loads [block_n, T] tiles into VMEM and masks every lane; this one reads
// only the steps t < len[n].
//
// What bounds it on this card: bytes. A few operations per element, far
// below the fp32 balance point (~20 flops per byte), so the least time is
// the valid steps of x (sum(len) * 4 bytes), the full [N, T] output and the
// lengths over 3.35 TB/s. At the attention decoder's shape (N = 16 rows of
// T <= 48 steps, once per decoder step) that is a few KB: the launch is the
// time. Design: one warp per row, four rows per block. The warp's lanes
// walk t = lane, lane + 32, ... < len three times: a max, then the sum of
// exp(x - max), both reduced by shuffles, then the write of every t < T
// (zeros past the length). The second and third reads of a row hit L1/L2.
// x is read through its row stride.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNeg = -1e30f;  // the TPU kernel's _NEG: an empty row's max

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
masked_softmax_fwd_kernel(const float* __restrict__ x, long long sxn,
                          const int* __restrict__ lens, float* __restrict__ y,
                          int N, int T) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const int len = min(max(lens ? lens[row] : T, 0), T);
  const float* xr = x + (long long)row * sxn;
  float* yr = y + (long long)row * T;

  float m = kNeg;
  for (int t = lane; t < len; t += 32) m = fmaxf(m, xr[t]);
  m = warp_max(m);
  float s = 0.f;
  for (int t = lane; t < len; t += 32) s += expf(xr[t] - m);
  const float denom = fmaxf(warp_sum(s), 1e-30f);
  for (int t = lane; t < T; t += 32)
    yr[t] = t < len ? expf(xr[t] - m) / denom : 0.f;
}

}  // namespace

// x: fp32 [N, T] with unit stride along T and row stride sxn (in elements);
// lens: int32 [N] or null (every row T steps); y: fp32 [N, T] contiguous.
// Returns the cudaError_t of the launch.
extern "C" int ptt_masked_softmax_fwd(const float* x, long long sxn,
                                      const int* lens, float* y, int N, int T,
                                      void* stream) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  masked_softmax_fwd_kernel<<<grid, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, sxn, lens, y, N, T);
  return static_cast<int>(cudaGetLastError());
}
