// Flash attention forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`): exact softmax attention
// with an online (running max / denominator / accumulator) softmax, so the
// [T, T] score matrix never reaches device memory; key blocks past the
// causal frontier and past the row's key length are skipped; the row
// log-sum-exp is emitted for the backward pass.
//
// What bounds it on this card: in fp32 the two products per key block run
// on the CUDA cores (67 TFLOP/s on an H100 SXM; fp32 has no tensor-core
// path without TF32 rounding), and at the serving shape (T=256, D=64) the
// work is 4*T*T*D flops per (batch, head) against 4*T*D*4 bytes read and
// written, about 64 flops per byte -- compute-bound. This first kernel is
// simple rather than fast: each block owns one (batch*head, 64-query tile)
// and holds it in registers, four threads per query row (each owns D/4 of
// the row, a float4-interleaved slice so shared-memory reads of a key row
// are conflict-free broadcasts), and key/value tiles stream through shared
// memory. Scores of one key tile stay in registers. wgmma/TMA and
// warp specialisation are later work.
//
// Differences from the TPU kernel, by design: it reads q, k and v with
// their strides straight from the [B, T, H, D] layout (no [BH, T, D]
// transpose), masks the ragged T edge itself instead of padding T to a
// block multiple, and allocates nothing (outputs come from the caller).
// A row whose key length is 0 gives out = 0 and lse = -1e30 + log(1e-30),
// the TPU kernel's `l_safe` values.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kTPR = 4;                     // threads per query row
constexpr int kThreads = kBlockQ * kTPR;    // 256
constexpr float kNeg = -1e30f;

template <int D>
struct FlashCfg {
  static constexpr int kBlockK = (D >= 128) ? 32 : 64;  // keys per tile
  static constexpr int kVec = D / 4;                    // float4 per row
  static constexpr int kVecPerThread = kVec / kTPR;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_len,
                 float* __restrict__ out, float* __restrict__ lse, int T,
                 int H, long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh, long long vsb,
                 long long vst, long long vsh, float scale, int causal) {
  using Cfg = FlashCfg<D>;
  constexpr int BK = Cfg::kBlockK;
  constexpr int VEC = Cfg::kVec;
  constexpr int VPT = Cfg::kVecPerThread;
  __shared__ float4 k_tile[BK][VEC];
  __shared__ float4 v_tile[BK][VEC];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int part = tid - row * kTPR;
  const int qpos = q0 + row;
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));

  // this thread's slice of the scaled query row and of the accumulator:
  // float4 columns part, part + kTPR, part + 2*kTPR, ...
  float4 qr[VPT];
  float4 acc[VPT];
  const float4* qrow = reinterpret_cast<const float4*>(
      q + b * qsb + (long long)min(qpos, T - 1) * qst + h * qsh);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    float4 x = qpos < T ? qrow[i * kTPR + part]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg;  // running row max
  float l = 0.f;   // running denominator

  // key tiles that do any work: up to the row length, and for causal
  // attention up to this query tile's frontier
  int n_tiles = (len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ + BK - 1) / BK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < BK * VEC; idx += kThreads) {
      const int r = idx / VEC;
      const int c = idx - r * VEC;
      const int kp = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kp < len) {
        kx = reinterpret_cast<const float4*>(
            k + b * ksb + (long long)kp * kst + h * ksh)[c];
        vx = reinterpret_cast<const float4*>(
            v + b * vsb + (long long)kp * vst + h * vsh)[c];
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();

    float s[BK];
    unsigned long long valid_mask = 0ull;
    float tile_max = kNeg;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) d += dot4(qr[i], k_tile[j][i * kTPR + part]);
      // the four threads of a row are adjacent lanes: butterfly sum
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int kp = k0 + j;
      const bool valid = kp < len && (!causal || kp <= qpos);
      s[j] = valid ? d : kNeg;
      valid_mask |= valid ? (1ull << j) : 0ull;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ((valid_mask >> j) & 1ull) ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const float4 vv = v_tile[j][i * kTPR + part];
        acc[i].x += p * vv.x;
        acc[i].y += p * vv.y;
        acc[i].z += p * vv.z;
        acc[i].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qpos < T) {
    const float l_safe = fmaxf(l, 1e-30f);
    float4* orow = reinterpret_cast<float4*>(
        out + (((long long)b * T + qpos) * H + h) * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      orow[i * kTPR + part] = make_float4(acc[i].x / l_safe, acc[i].y / l_safe,
                                          acc[i].z / l_safe, acc[i].w / l_safe);
    }
    if (part == 0) lse[((long long)b * H + h) * T + qpos] = m + logf(l_safe);
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v, const int* kv_len,
            float* out, float* lse, int B, int T, int H, long long qsb,
            long long qst, long long qsh, long long ksb, long long kst,
            long long ksh, long long vsb, long long vst, long long vsh,
            float scale, int causal, cudaStream_t stream) {
  dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_len, out, lse, T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
      vsh, scale, causal);
}

}  // namespace

// q, k, v: fp32 [B, T, H, D] with the given element strides (the last dim
// contiguous, every row 16-byte aligned); kv_len: int32 [B] or null (all
// T); out: fp32 [B, T, H, D] contiguous; lse: fp32 [B, H, T] contiguous.
// Returns the cudaError_t of the launch.
extern "C" int ptt_flash_attention_fwd(
    const float* q, const float* k, const float* v, const int* kv_len,
    float* out, float* lse, int B, int T, int H, int D, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, float scale, int causal,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16>(q, k, v, kv_len, out, lse, B, T, H, qsb, qst, qsh, ksb, kst,
                 ksh, vsb, vst, vsh, scale, causal, s);
      break;
    case 32:
      launch<32>(q, k, v, kv_len, out, lse, B, T, H, qsb, qst, qsh, ksb, kst,
                 ksh, vsb, vst, vsh, scale, causal, s);
      break;
    case 64:
      launch<64>(q, k, v, kv_len, out, lse, B, T, H, qsb, qst, qsh, ksb, kst,
                 ksh, vsb, vst, vsh, scale, causal, s);
      break;
    case 128:
      launch<128>(q, k, v, kv_len, out, lse, B, T, H, qsb, qst, qsh, ksb, kst,
                  ksh, vsb, vst, vsh, scale, causal, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
