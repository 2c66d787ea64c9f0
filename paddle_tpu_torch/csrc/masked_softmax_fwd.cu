// Masked sequence softmax forward (softmax over the time steps of each
// row, steps past the row's length set to 0), fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_masked_softmax_kernel` (launched by `_masked_softmax_call`, wrapped by
// `masked_softmax`): for x [N, T] and lengths [N],
//   y[n, t] = exp(x[n, t] - m) / max(sum_{s < len} exp(x[n, s] - m), 1e-30)
// for t < len[n], with m the row's max over t < len[n], and y[n, t] = 0 for
// t >= len[n]; a row of length 0 is all 0 and never NaN. The TPU kernel
// loads [block_n, T] tiles into VMEM and masks every lane.
//
// What bounds it on this card: bytes. A few operations per element, far
// below the fp32 balance point (~20 flops per byte), so the least time is
// the valid steps of x (sum(len) * 4 bytes), the full [N, T] output and the
// lengths over 3.35 TB/s. At the attention decoder's shape (N = 16 rows of
// T <= 48 steps, once per decoder step) that is a few KB: the launch is the
// time.
//
// Design: one warp per row, `warps` rows a block. For T up to 1024 the
// row is loaded once into registers (a template on the chunks a lane
// holds): only its valid steps, as float4 when the row's address and
// stride allow it (x 16-byte aligned, row stride and T multiples of 4; a
// chunk is read whole once its first step is valid), else as scalars. The
// max and the sum
// come from the registers by shuffles, exp is taken once per element (the
// fast exponential: its arguments are at most 0), each
// is scaled by the sum's reciprocal, and the output is written from the
// registers (as float4 where aligned),
// zeros past the length. Above 1024 steps one online pass keeps a running
// max and a rescaled sum per lane (merged across the warp by shuffles),
// then one pass writes: two reads of x, not three. x is read through its
// row stride.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernel's _NEG: an empty row's max
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Register path: lane `lane` holds chunks c = lane + 32 i (i < CHUNKS) of
// VEC consecutive steps each, steps VEC c .. VEC c + VEC - 1.
template <int CHUNKS, int VEC>
__global__ void masked_softmax_reg_kernel(const float* __restrict__ x,
                                          long long sxn,
                                          const int* __restrict__ lens,
                                          float* __restrict__ y, int N,
                                          int T) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const int len = min(max(lens ? lens[row] : T, 0), T);
  const float* xr = x + (long long)row * sxn;
  float* yr = y + (long long)row * T;

  // the steps loaded: the valid ones (a float4 chunk whole once its first
  // step is valid)
  const int lim = len;
  float v[CHUNKS][VEC];
  float m = kNeg;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int t0 = (lane + 32 * i) * VEC;
    if (VEC == 4 && t0 < lim) {
      const float4 q = *reinterpret_cast<const float4*>(xr + t0);
      v[i][0] = q.x;
      v[i][VEC > 1 ? 1 : 0] = q.y;
      v[i][VEC > 2 ? 2 : 0] = q.z;
      v[i][VEC > 3 ? 3 : 0] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[i][e] = t0 + e < lim ? xr[t0 + e] : kNeg;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (t0 + e >= len) v[i][e] = kNeg;
      m = fmaxf(m, v[i][e]);
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int t0 = (lane + 32 * i) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[i][e] = t0 + e < len ? __expf(v[i][e] - m) : 0.f;
      s += v[i][e];
    }
  }
  const float denom = fmaxf(warp_sum(s), 1e-30f);
  const float inv = 1.f / denom;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int t0 = (lane + 32 * i) * VEC;
    if (t0 >= T) continue;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = v[i][e] * inv;
    if (VEC == 4) {
      *reinterpret_cast<float4*>(yr + t0) =
          make_float4(o[0], o[VEC > 1 ? 1 : 0], o[VEC > 2 ? 2 : 0],
                      o[VEC > 3 ? 3 : 0]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (t0 + e < T) yr[t0 + e] = o[e];
    }
  }
}

// Online path for T above the register cap: per lane a running max m and
// a sum s of exp(x - m), rescaled when m grows; the lanes' pairs merge by
// shuffles; then one pass writes.
__global__ void masked_softmax_online_kernel(const float* __restrict__ x,
                                             long long sxn,
                                             const int* __restrict__ lens,
                                             float* __restrict__ y, int N,
                                             int T) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;
  const int len = min(max(lens ? lens[row] : T, 0), T);
  const float* xr = x + (long long)row * sxn;
  float* yr = y + (long long)row * T;

  float m = kNeg, s = 0.f;
  for (int t = lane; t < len; t += 32) {
    const float v = xr[t];
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  const float mw = warp_max(m);
  const float denom = fmaxf(warp_sum(s * expf(m - mw)), 1e-30f);
  for (int t = lane; t < T; t += 32)
    yr[t] = t < len ? expf(xr[t] - mw) / denom : 0.f;
}

template <int CHUNKS, int VEC>
cudaError_t launch_reg(const float* x, long long sxn, const int* lens,
                       float* y, int N, int T, int warps,
                       cudaStream_t stream) {
  const dim3 grid((N + warps - 1) / warps);
  masked_softmax_reg_kernel<CHUNKS, VEC><<<grid, warps * 32, 0, stream>>>(
      x, sxn, lens, y, N, T);
  return cudaGetLastError();
}

}  // namespace

// x: fp32 [N, T] with unit stride along T and row stride sxn (in elements);
// lens: int32 [N] or null (every row T steps); y: fp32 [N, T] contiguous;
// warps: rows a block (1-32). Returns the cudaError_t of the launch.
extern "C" int ptt_masked_softmax_fwd(const float* x, long long sxn,
                                      const int* lens, float* y, int N, int T,
                                      int warps, void* stream) {
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   sxn % 4 == 0 && T % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(y) % 16 == 0;
  cudaError_t e;
  if (vec && T <= 128)
    e = launch_reg<1, 4>(x, sxn, lens, y, N, T, warps, s);
  else if (vec && T <= 256)
    e = launch_reg<2, 4>(x, sxn, lens, y, N, T, warps, s);
  else if (vec && T <= 512)
    e = launch_reg<4, 4>(x, sxn, lens, y, N, T, warps, s);
  else if (vec && T <= 1024)
    e = launch_reg<8, 4>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 32)
    e = launch_reg<1, 1>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 64)
    e = launch_reg<2, 1>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 128)
    e = launch_reg<4, 1>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 256)
    e = launch_reg<8, 1>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 512)
    e = launch_reg<16, 1>(x, sxn, lens, y, N, T, warps, s);
  else if (T <= 1024)
    e = launch_reg<32, 1>(x, sxn, lens, y, N, T, warps, s);
  else {
    const dim3 grid((N + warps - 1) / warps);
    masked_softmax_online_kernel<<<grid, warps * 32, 0, s>>>(x, sxn, lens, y,
                                                             N, T);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
