// Flash attention backward, fp32, for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_kernels.py
// `_flash_bwd_dkdv_kernel` and `_flash_bwd_dq_kernel` (both launched by
// `_flash_bwd`): the standard flash recompute from the forward's saved
// log-sum-exp, p = exp(q.k * scale - lse), so the [T, T] matrix never
// reaches device memory. With g the output gradient and
// delta = rowsum(g * out) (computed by the caller, as the TPU path does
// outside its kernels):
//   dV = p^T g,  dS = p * (g.v - delta) * scale,  dK = dS^T q,  dQ = dS k.
//
// The TPU grid walks blocks in order; on Hopper blocks run in no order and
// nothing carries over between them. So, as in the TPU's two-kernel split,
// neither kernel needs atomics:
//   * dK/dV: one block owns one (batch*head, 64-key tile) and loops over the
//     query tiles from the causal frontier to T; a key tile at or past the
//     row's key length does no work and writes zeros;
//   * dQ: one block owns one (batch*head, 64-query tile) and loops over the
//     key tiles up to the causal and key-length frontier.
// A pair is masked BEFORE the exponential (a select, never inf * 0): on a
// row with key length 0 the saved lse is about -1e30, and there every
// gradient is 0, as in the TPU kernels.
//
// What bounds it on this card: like the forward, fp32 on the CUDA cores
// (67 TFLOP/s on an H100 SXM). A valid (query, key) pair costs 8*D flops in
// dK/dV (two dot products, two updates) and 6*D in dQ, against q, k, v, g
// read and dq, dk, dv written once: at T=256, D=64 about 100 flops per byte,
// compute-bound. This first version is simple rather than fast, and keeps
// the forward kernel's layout: four threads per owned row, each holding a
// float4-interleaved D/4 slice in registers (so a streamed row read from
// shared memory is a conflict-free broadcast), the streamed tiles in shared
// memory, butterfly shuffles for the dot products. It reads q, k, v and g
// with their strides from the [B, T, H, D] layout (no transpose), masks the
// ragged T edge itself, and allocates nothing.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;                   // owned rows per block
constexpr int kTPR = 4;                     // threads per owned row
constexpr int kThreads = kRows * kTPR;      // 256

template <int D>
struct BwdCfg {
  static constexpr int kTile = (D >= 128) ? 32 : 64;  // streamed rows per tile
  static constexpr int kVec = D / 4;                  // float4 per row
  static constexpr int kVecPerThread = kVec / kTPR;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x += a * x.x;
  y.y += a * x.y;
  y.z += a * x.z;
  y.w += a * x.w;
}

// the four threads of a row are adjacent lanes: butterfly sum
__device__ __forceinline__ float row_sum(float d) {
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh;
};

template <int D>
__device__ __forceinline__ void load_row(float4 (&r)[BwdCfg<D>::kVecPerThread],
                                         const float* base, bool ok,
                                         int part) {
  const float4* p = reinterpret_cast<const float4*>(base);
#pragma unroll
  for (int i = 0; i < BwdCfg<D>::kVecPerThread; ++i)
    r[i] = ok ? p[i * kTPR + part] : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__device__ __forceinline__ void store_row(float* base,
                                          const float4 (&r)[BwdCfg<D>::kVecPerThread],
                                          int part) {
  float4* p = reinterpret_cast<float4*>(base);
#pragma unroll
  for (int i = 0; i < BwdCfg<D>::kVecPerThread; ++i) p[i * kTPR + part] = r[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_len, float* __restrict__ dk,
                      float* __restrict__ dv, int T, int H, Strides st,
                      float scale, int causal) {
  using Cfg = BwdCfg<D>;
  constexpr int BQ = Cfg::kTile;
  constexpr int VEC = Cfg::kVec;
  constexpr int VPT = Cfg::kVecPerThread;
  __shared__ float4 q_tile[BQ][VEC];
  __shared__ float4 g_tile[BQ][VEC];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int part = tid - row * kTPR;
  const int kpos = k0 + row;
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));
  const bool key_valid = kpos < len;
  const float* lse_row = lse + (long long)bh * T;
  const float* delta_row = delta + (long long)bh * T;

  float4 kr[VPT], vr[VPT], dkr[VPT], dvr[VPT];
  load_row<D>(kr, k + b * st.ksb + (long long)kpos * st.kst + h * st.ksh,
              key_valid, part);
  load_row<D>(vr, v + b * st.vsb + (long long)kpos * st.vst + h * st.vsh,
              key_valid, part);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    dkr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dvr[i] = dkr[i];
  }

  // query tiles that do any work: from the causal frontier (queries before
  // this key tile see none of its keys) to T; none when the whole key tile
  // lies at or past the row's key length
  const int n_tiles = (T + BQ - 1) / BQ;
  const int first = k0 >= len ? n_tiles : (causal ? k0 / BQ : 0);

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < BQ * VEC; idx += kThreads) {
      const int r = idx / VEC;
      const int c = idx - r * VEC;
      const int qp = q0 + r;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gx = qx;
      if (qp < T) {
        qx = reinterpret_cast<const float4*>(
            q + b * st.qsb + (long long)qp * st.qst + h * st.qsh)[c];
        gx = reinterpret_cast<const float4*>(
            g + b * st.gsb + (long long)qp * st.gst + h * st.gsh)[c];
      }
      q_tile[r][c] = qx;
      g_tile[r][c] = gx;
    }
    for (int r = tid; r < BQ; r += kThreads) {
      const int qp = q0 + r;
      lse_tile[r] = qp < T ? lse_row[qp] : 0.f;
      delta_tile[r] = qp < T ? delta_row[qp] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        s += dot4(kr[j], q_tile[i][j * kTPR + part]);
        dp += dot4(vr[j], g_tile[i][j * kTPR + part]);
      }
      s = row_sum(s) * scale;
      dp = row_sum(dp);
      const int qp = q0 + i;
      const bool valid = key_valid && qp < T && (!causal || qp >= kpos);
      const float p = valid ? expf(s - lse_tile[i]) : 0.f;
      const float ds = p * (dp - delta_tile[i]) * scale;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        axpy4(dvr[j], p, g_tile[i][j * kTPR + part]);
        axpy4(dkr[j], ds, q_tile[i][j * kTPR + part]);
      }
    }
  }

  if (kpos < T) {
    const long long off = (((long long)b * T + kpos) * H + h) * D;
    store_row<D>(dk + off, dkr, part);
    store_row<D>(dv + off, dvr, part);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    int T, int H, Strides st, float scale, int causal) {
  using Cfg = BwdCfg<D>;
  constexpr int BK = Cfg::kTile;
  constexpr int VEC = Cfg::kVec;
  constexpr int VPT = Cfg::kVecPerThread;
  __shared__ float4 k_tile[BK][VEC];
  __shared__ float4 v_tile[BK][VEC];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int part = tid - row * kTPR;
  const int qpos = q0 + row;
  const bool active = qpos < T;
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));

  float4 qr[VPT], gr[VPT], dqr[VPT];
  load_row<D>(qr, q + b * st.qsb + (long long)qpos * st.qst + h * st.qsh,
              active, part);
  load_row<D>(gr, g + b * st.gsb + (long long)qpos * st.gst + h * st.gsh,
              active, part);
#pragma unroll
  for (int i = 0; i < VPT; ++i) dqr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse_r = active ? lse[(long long)bh * T + qpos] : 0.f;
  const float delta_r = active ? delta[(long long)bh * T + qpos] : 0.f;

  // key tiles that do any work: up to the row length, and for causal
  // attention up to this query tile's frontier
  int n_tiles = (len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + BK - 1) / BK);

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
            k + b * st.ksb + (long long)kp * st.kst + h * st.ksh)[c];
        vx = reinterpret_cast<const float4*>(
            v + b * st.vsb + (long long)kp * st.vst + h * st.vsh)[c];
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        s += dot4(qr[i], k_tile[j][i * kTPR + part]);
        dp += dot4(gr[i], v_tile[j][i * kTPR + part]);
      }
      s = row_sum(s) * scale;
      dp = row_sum(dp);
      const int kp = k0 + j;
      const bool valid = active && kp < len && (!causal || kp <= qpos);
      const float p = valid ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - delta_r) * scale;
#pragma unroll
      for (int i = 0; i < VPT; ++i) axpy4(dqr[i], ds, k_tile[j][i * kTPR + part]);
    }
  }

  if (active) {
    store_row<D>(dq + (((long long)b * T + qpos) * H + h) * D, dqr, part);
  }
}

template <int D>
void launch_dkdv(const float* q, const float* k, const float* v,
                 const float* g, const float* lse, const float* delta,
                 const int* kv_len, float* dk, float* dv, int B, int T, int H,
                 const Strides& st, float scale, int causal,
                 cudaStream_t stream) {
  dim3 grid((T + kRows - 1) / kRows, B * H);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, g, lse, delta, kv_len, dk, dv, T, H, st, scale, causal);
}

template <int D>
void launch_dq(const float* q, const float* k, const float* v, const float* g,
               const float* lse, const float* delta, const int* kv_len,
               float* dq, int B, int T, int H, const Strides& st, float scale,
               int causal, cudaStream_t stream) {
  dim3 grid((T + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, g, lse, delta, kv_len, dq, T, H, st, scale, causal);
}

Strides make_strides(long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh,
                     long long gsb, long long gst, long long gsh) {
  Strides st = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh};
  return st;
}

}  // namespace

// q, k, v, g: fp32 [B, T, H, D] with the given element strides (the last
// dim contiguous, every row 16-byte aligned); lse, delta: fp32 [B, H, T]
// contiguous; kv_len: int32 [B] or null (all T); dk, dv: fp32 [B, T, H, D]
// contiguous. Returns the cudaError_t of the launch.
extern "C" int ptt_flash_attention_bwd_dkdv(
    const float* q, const float* k, const float* v, const float* g,
    const float* lse, const float* delta, const int* kv_len, float* dk,
    float* dv, int B, int T, int H, int D, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, long long gsb, long long gst, long long gsh,
    float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = make_strides(qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                  gsb, gst, gsh);
  switch (D) {
    case 16:
      launch_dkdv<16>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H, st,
                      scale, causal, s);
      break;
    case 32:
      launch_dkdv<32>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H, st,
                      scale, causal, s);
      break;
    case 64:
      launch_dkdv<64>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H, st,
                      scale, causal, s);
      break;
    case 128:
      launch_dkdv<128>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H, st,
                       scale, causal, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same inputs; dq: fp32 [B, T, H, D] contiguous.
extern "C" int ptt_flash_attention_bwd_dq(
    const float* q, const float* k, const float* v, const float* g,
    const float* lse, const float* delta, const int* kv_len, float* dq,
    int B, int T, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long gsb, long long gst, long long gsh, float scale,
    int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = make_strides(qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                  gsb, gst, gsh);
  switch (D) {
    case 16:
      launch_dq<16>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st, scale,
                    causal, s);
      break;
    case 32:
      launch_dq<32>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st, scale,
                    causal, s);
      break;
    case 64:
      launch_dq<64>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st, scale,
                    causal, s);
      break;
    case 128:
      launch_dq<128>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st, scale,
                     causal, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
