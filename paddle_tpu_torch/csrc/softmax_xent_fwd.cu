// Softmax cross-entropy forward over the last dim of [N, V], fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py `_xent_kernel`
// (launched by `_xent_fwd_call`): per row, lse = log(sum(exp(x))) and
// loss = lse - x[label], the softmax never written. A label outside [0, V)
// picks the class of the JAX package's CPU rule (cuda_kernels.
// hard_label_index): a negative label wraps once (-1 -> V - 1), then the
// label is clamped to [0, V - 1] (V + k -> V - 1).
//
// What bounds it on this card: bytes. Each logit is read once and costs one
// exponential and a few flops, far below the H100's fp32 balance point, so
// the least time is N*V*4 bytes over 3.35 TB/s (0.29 ms at the Transformer's
// N = 8192 tokens, V = 30000). Design: the TPU kernel holds a block of rows
// in VMEM and reduces each twice (max, then sum); a 30000-wide fp32 row is
// 120 KB, so here one 256-thread block owns one row and reads it ONCE from
// device memory, 16 bytes a thread per load, keeping an online max and a
// rescaled sum per thread (rescaled only when the max grows), and picking
// the label's logit in the same pass. The per-thread (max, sum) pairs then
// merge by warp shuffles and one shared-memory step.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// VEC4: V % 4 == 0 and every row 16-byte aligned -> float4 loads
template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
softmax_xent_fwd_kernel(const float* __restrict__ logits,
                        const long long* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ lse,
                        int V) {
  __shared__ float sm[kWarps], ss[kWarps], sp[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = logits + (long long)row * V;
  long long lab = labels[row];
  if (lab < 0) lab += V;
  const int pick = static_cast<int>(lab < 0 ? 0 : lab >= V ? V - 1 : lab);

  // -FLT_MAX, not -inf: merging two empty partials stays finite (exp(0)*0)
  float m = -FLT_MAX, s = 0.f, picked = 0.f;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = tid; i < V / 4; i += kThreads) {
      const float4 a = x4[i];
      const float mx = fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
      if (mx > m) {
        s *= expf(m - mx);
        m = mx;
      }
      s += (expf(a.x - m) + expf(a.y - m)) + (expf(a.z - m) + expf(a.w - m));
      if ((pick >> 2) == i) {
        const int c = pick & 3;
        picked = c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
      }
    }
  } else {
    for (int i = tid; i < V; i += kThreads) {
      const float a = x[i];
      online_add(m, s, a);
      if (i == pick) picked = a;
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
    picked += __shfl_xor_sync(0xffffffffu, picked, o);
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    sm[warp] = m;
    ss[warp] = s;
    sp[warp] = picked;
  }
  __syncthreads();
  if (tid == 0) {
    float mm = sm[0], sum = ss[0], pk = sp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      merge(mm, sum, sm[w], ss[w]);
      pk += sp[w];
    }
    const float l = mm + logf(sum);
    lse[row] = l;
    loss[row] = l - pk;
  }
}

}  // namespace

// logits: fp32 [N, V] contiguous; labels: int64 [N]; loss, lse: fp32 [N]
// (the caller's [N, 1]). vec4 != 0 asks for the float4 path (V % 4 == 0 and
// a 16-byte aligned base, checked by the caller). Returns the cudaError_t
// of the launch.
extern "C" int ptt_softmax_xent_fwd(const float* logits,
                                    const long long* labels, float* loss,
                                    float* lse, int N, int V, int vec4,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    softmax_xent_fwd_kernel<true><<<N, kThreads, 0, s>>>(logits, labels, loss,
                                                         lse, V);
  } else {
    softmax_xent_fwd_kernel<false><<<N, kThreads, 0, s>>>(logits, labels,
                                                          loss, lse, V);
  }
  return static_cast<int>(cudaGetLastError());
}
