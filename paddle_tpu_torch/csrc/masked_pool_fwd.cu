// Masked sequence pool forward (SUM / AVERAGE / SQRT over time), fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_masked_pool_kernel` (launched by `_masked_pool_call`, wrapped by
// `masked_pool`): for x [B, T, F] and lengths [B],
//   out[b, f] = sum_{t < len[b]} x[b, t, f]
// divided by max(len[b], 1) for AVERAGE and by sqrt(max(len[b], 1)) for
// SQRT. The TPU kernel loads whole [block_n, T, F] tiles into VMEM and
// multiplies by the mask; this kernel reads only the steps t < len[b] and
// never touches the padding.
//
// What bounds it on this card: bytes. One add per element read, far below
// the fp32 balance point (~20 flops per byte), so the least time is the
// valid rows of x (sum(len) * F * 4 bytes) plus the [B, F] output over
// 3.35 TB/s. Design: one block per (row, tile of features); the block's
// threads are a [BT, BF] grid with threadIdx.x along F, so each warp reads
// consecutive features of one step (coalesced), and the BT thread rows walk
// the valid steps t = ty, ty + BT, ... with an fp32 sum each. The BT partial
// sums meet in shared memory and are added in a fixed order (the result
// does not depend on scheduling), then scaled and written once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
masked_pool_fwd_kernel(const float* __restrict__ x, long long sxb,
                       long long sxt, const int* __restrict__ lens,
                       float* __restrict__ out, int T, int F, int ptype) {
  __shared__ float part[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bf = blockDim.x, bt = blockDim.y;
  const int f = blockIdx.x * bf + tx;
  const int row = blockIdx.y;
  const int len = lens ? lens[row] : T;
  const int steps = min(max(len, 0), T);
  float s = 0.f;
  if (f < F) {
    const float* xr = x + (long long)row * sxb + f;
    for (int t = ty; t < steps; t += bt) s += xr[(long long)t * sxt];
  }
  part[ty * bf + tx] = s;
  __syncthreads();
  if (ty == 0 && f < F) {
    float tot = 0.f;
    for (int i = 0; i < bt; ++i) tot += part[i * bf + tx];
    const float denom = fmaxf((float)len, 1.f);
    if (ptype == 1) tot = tot / denom;
    else if (ptype == 2) tot = tot / sqrtf(denom);
    out[(long long)row * F + f] = tot;
  }
}

}  // namespace

// x: fp32 [B, T, F], last dim contiguous, batch/time strides sxb/sxt (in
// elements); lens: int32 [B] or null (every row T steps); out: fp32 [B, F]
// contiguous. ptype: 0 SUM, 1 AVERAGE, 2 SQRT. B <= 65535. Returns the
// cudaError_t of the launch.
extern "C" int ptt_masked_pool_fwd(const float* x, long long sxb,
                                   long long sxt, const int* lens,
                                   float* out, int B, int T, int F,
                                   int ptype, void* stream) {
  if (ptype < 0 || ptype > 2) return static_cast<int>(cudaErrorInvalidValue);
  int bf = 32;
  while (bf < F && bf < kThreads) bf *= 2;
  const dim3 block(bf, kThreads / bf);
  const dim3 grid((F + bf - 1) / bf, B);
  masked_pool_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sxb, sxt, lens, out, T, F, ptype);
  return static_cast<int>(cudaGetLastError());
}
