// Layer norm forward over the last dim of [N, D], fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py `_ln_kernel`
// (launched by `_ln_fwd_call`): per row, mean, variance and
// y = (x - mean) * rsqrt(var + eps) * scale + bias, with the statistics in
// fp32. Unlike the TPU path, which computes the op's Mean and Variance
// outputs with two more reductions outside the kernel, this kernel writes
// them itself, so the op reads x from device memory once.
//
// What bounds it on this card: bytes. It does ~8 flops per element against
// 8 bytes moved (x read, y written), far below the H100's ~20 flops per
// byte fp32 balance point, so the least time is (N*D*8 + 2*D*4 + 2*N*4)
// bytes over 3.35 TB/s. Design: one warp per row, eight rows per block; the
// row is read once from device memory and then from L1 for the variance
// and output passes (a D=512 row is 2 KB), with warp-shuffle reductions
// and no shared memory. Any D works; rows are not padded to a block.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VEC4: D % 4 == 0 and every row 16-byte aligned -> float4 accesses
template <bool VEC4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ var,
                      int N, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp leaves together
  const float* xr = x + (long long)row * D;
  float* yr = y + (long long)row * D;

  float s = 0.f;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 a = x4[i];
      s += (a.x + a.y) + (a.z + a.w);
    }
  } else {
    for (int i = lane; i < D; i += 32) s += xr[i];
  }
  const float mu = warp_sum(s) / D;

  float ss = 0.f;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 a = x4[i];
      const float d0 = a.x - mu, d1 = a.y - mu, d2 = a.z - mu, d3 = a.w - mu;
      ss += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float d = xr[i] - mu;
      ss += d * d;
    }
  }
  const float vr = warp_sum(ss) / D;
  const float rstd = rsqrtf(vr + eps);

  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(scale);
    const float4* b4 = reinterpret_cast<const float4*>(bias);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 a = x4[i], g = g4[i], c = b4[i];
      y4[i] = make_float4((a.x - mu) * rstd * g.x + c.x,
                          (a.y - mu) * rstd * g.y + c.y,
                          (a.z - mu) * rstd * g.z + c.z,
                          (a.w - mu) * rstd * g.w + c.w);
    }
  } else {
    for (int i = lane; i < D; i += 32)
      yr[i] = (xr[i] - mu) * rstd * scale[i] + bias[i];
  }
  if (lane == 0) {
    mean[row] = mu;
    var[row] = vr;
  }
}

}  // namespace

// x, y: fp32 [N, D] contiguous; scale, bias: fp32 [D]; mean, var: fp32 [N]
// (biased variance, as the op's Variance output). vec4 != 0 asks for the
// float4 path (D % 4 == 0 and 16-byte aligned rows, checked by the caller).
// Returns the cudaError_t of the launch.
extern "C" int ptt_layer_norm_fwd(const float* x, const float* scale,
                                  const float* bias, float* y, float* mean,
                                  float* var, int N, int D, float eps,
                                  int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec4) {
    layer_norm_fwd_kernel<true><<<grid, block, 0, s>>>(x, scale, bias, y,
                                                       mean, var, N, D, eps);
  } else {
    layer_norm_fwd_kernel<false><<<grid, block, 0, s>>>(x, scale, bias, y,
                                                        mean, var, N, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
