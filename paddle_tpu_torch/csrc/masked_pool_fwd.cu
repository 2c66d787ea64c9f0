// Masked sequence pool forward (SUM / AVERAGE / SQRT over time), fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_masked_pool_kernel` (launched by `_masked_pool_call`, wrapped by
// `masked_pool`): for x [B, T, F] and lengths [B],
//   out[b, f] = sum_{t < min(max(len[b], 0), T)} x[b, t, f]
// divided by max(len[b], 1) for AVERAGE and by sqrt(max(len[b], 1)) for
// SQRT (the length is not clamped to T there, as in the TPU kernel). The
// TPU kernel loads whole [block_n, T, F] tiles into VMEM and multiplies by
// the mask; this kernel reads only the steps t < len[b] and never touches
// the padding.
//
// What bounds it on this card: bytes. One add per element read, far below
// the fp32 balance point (~20 flops per byte), so the least time is the
// valid rows of x (sum(len) * F * 4 bytes) plus the [B, F] output over
// 3.35 TB/s; at the serving shape that is tens of ns, and the launch is
// the floor.
//
// Design (the plan is made on the host from shapes alone, never from the
// lengths: cuda_kernels.pool_launch_plan):
//   * one thread-block cluster of CS blocks (1, 2, 4 or 8) per (row,
//     feature tile): rows times CS on grid.x, feature tiles on grid.y, so
//     any B launches. Block c of a cluster takes the steps [c * chunk,
//     (c + 1) * chunk) below the row's length, chunk = ceil(T / CS); a
//     block whose range is empty adds nothing and still meets the cluster
//     barrier. CS splits a long row over SMs, up to one wave of blocks
//     on the card; a cluster's barriers cost more than they save on
//     short rows, where the plan keeps CS = 1.
//   * a block is lf lanes along F (16-byte columns when F, the strides
//     and the base allow float4, else 4-byte ones) times 256 / lf lanes
//     along T. Each thread issues kUnroll loads (ld.global.nc) into
//     registers before it adds any of them, so a block's chunk is a few
//     round trips to memory, not a chain of dependent loads; a batch's
//     loads are summed by a fixed tree, so a thread's chain of adds is
//     one per batch.
//   * a fixed-order reduction: the step lanes of a warp meet by xor
//     shuffles (a fixed tree), the warps' partials in shared memory in
//     warp order, and across the cluster rank 0 reads the peers' partials
//     through distributed shared memory (mapa) in rank order after one
//     cluster barrier (barrier.cluster.arrive.release / wait.acquire),
//     scales them and writes out once; a second cluster barrier keeps the
//     peers alive until rank 0 has read them. No atomics and no second
//     launch: a plan gives the same bits on every run.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kUnroll = 8;      // loads a thread has in flight

template <int VEC>
struct VecOf;
template <>
struct VecOf<1> {
  using T = float;
};
template <>
struct VecOf<4> {
  using T = float4;
};

__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int m) {
  return make_float4(shfl_xor(v.x, m), shfl_xor(v.y, m), shfl_xor(v.z, m),
                     shfl_xor(v.w, m));
}
__device__ __forceinline__ void scale(float& a, float s, int ptype) {
  a = ptype == 1 ? a / s : ptype == 2 ? a / sqrtf(s) : a;
}
__device__ __forceinline__ void scale(float4& a, float s, int ptype) {
  scale(a.x, s, ptype);
  scale(a.y, s, ptype);
  scale(a.z, s, ptype);
  scale(a.w, s, ptype);
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned int cluster_ctarank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned int cluster_nctarank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned int cluster_id() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// the cluster barrier: every thread arrives (releasing its earlier shared
// stores) and waits (acquiring every other thread's)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// what block `rank` of this cluster holds at the place `local` (a shared
// address of this block) has there
__device__ __forceinline__ unsigned int peer_addr(unsigned int local,
                                                  unsigned int rank) {
  unsigned int remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ float ld_peer(const float* p, unsigned int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(peer_addr(smem_addr(p), rank))
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_peer(const float4* p,
                                          unsigned int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(peer_addr(smem_addr(p), rank))
               : "memory");
  return v;
}

// This thread's sum over its steps t0, t0 + lt, ... below t1: loads issued
// kUnroll at a time into registers, each batch summed by a fixed tree,
// the batches added in order.
template <typename V>
__device__ __forceinline__ V sum_loads(const V* __restrict__ xc,
                                       long long st, int t0, int t1, int lt,
                                       bool ok) {
  V acc;
  zero(acc);
  if (!ok) return acc;
  for (int base = t0; base < t1; base += kUnroll * lt) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * lt;
      if (t < t1)
        v[u] = __ldg(xc + t * st);
      else
        zero(v[u]);
    }
#pragma unroll
    for (int s = 1; s < kUnroll; s *= 2)
#pragma unroll
      for (int u = 0; u < kUnroll; u += 2 * s) add(v[u], v[u + s]);
    add(acc, v[0]);
  }
  return acc;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
masked_pool_fwd_kernel(const float* __restrict__ x, long long sxb,
                       long long sxt, const int* __restrict__ lens,
                       float* __restrict__ out, int T, int F, int ptype,
                       int lf_shift, int chunk) {
  using V = typename VecOf<VEC>::T;
  __shared__ V part[kThreads];
  const int tid = threadIdx.x;
  const int lf = 1 << lf_shift;
  const int tx = tid & (lf - 1), ty = tid >> lf_shift;
  const int lt = kThreads >> lf_shift;
  const unsigned int cs = cluster_nctarank(), rank = cluster_ctarank();
  const int row = static_cast<int>(cluster_id());
  const int col = blockIdx.y * lf + tx;
  const bool ok = col < F / VEC;
  const int t0 = static_cast<int>(rank) * chunk;
  const int len = lens ? lens[row] : T;
  const int t1 = min(t0 + chunk, min(max(len, 0), T));
  const V* xc = reinterpret_cast<const V*>(x + (long long)row * sxb) + col;
  V acc = sum_loads(xc, sxt / VEC, t0 + ty, t1, lt, ok);

  // the step lanes of one warp (lf < 32): a fixed xor tree; every lane
  // ends with the same bits (the adds commute exactly)
  for (int m = 16; m >= lf; m >>= 1) add(acc, shfl_xor(acc, m));
  // then the warps' (lf < 32) or step lanes' (lf >= 32) partials in order
  const int spw = lf < 32 ? 32 >> lf_shift : 1;
  if (ty % spw == 0) part[(ty / spw) * lf + tx] = acc;
  __syncthreads();
  if (tid < lf) {
    V tot = part[tx];
    for (int g = 1; g < lt / spw; ++g) add(tot, part[g * lf + tx]);
    part[tx] = tot;
  }
  // across the cluster: rank 0 adds the peers' partials in rank order
  if (cs > 1) cluster_sync();
  if (rank == 0 && tid < lf && ok) {
    V tot = part[tx];
    for (unsigned int r = 1; r < cs; ++r) add(tot, ld_peer(&part[tx], r));
    scale(tot, fmaxf(static_cast<float>(len), 1.f), ptype);
    reinterpret_cast<V*>(out + (long long)row * F)[col] = tot;
  }
  // no block exits while rank 0 may still read its shared memory
  if (cs > 1) cluster_sync();
}

template <int VEC>
int launch(const float* x, long long sxb, long long sxt, const int* lens,
           float* out, int B, int T, int F, int ptype, int lf_shift,
           int tiles, int cs, int chunk, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  config.gridDim = dim3(B * cs, tiles);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&config, masked_pool_fwd_kernel<VEC>, x, sxb, sxt,
                         lens, out, T, F, ptype, lf_shift, chunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x: fp32 [B, T, F], last dim contiguous, batch/time strides sxb/sxt (in
// elements); lens: int32 [B] or null (every row T steps); out: fp32 [B, F]
// contiguous. ptype: 0 SUM, 1 AVERAGE, 2 SQRT. The plan
// (cuda_kernels.pool_launch_plan): vec 1 or 4 (4: F, sxb and sxt multiples
// of 4 and x 16-byte aligned), lf (a power of 2 up to 256) lanes along F,
// cs (1, 2, 4 or 8) blocks a cluster, chunk steps a block (chunk * cs >=
// T). Grid (B * cs, F tiles): B * cs <= INT_MAX, tiles <= 65535. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a plan it does
// not take).
extern "C" int ptt_masked_pool_fwd(const float* x, long long sxb,
                                   long long sxt, const int* lens,
                                   float* out, int B, int T, int F,
                                   int ptype, int vec, int lf, int cs,
                                   int chunk, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (ptype < 0 || ptype > 2 || B < 1 || T < 0 || F < 1) return bad;
  if (vec != 1 && vec != 4) return bad;
  if (vec == 4 && (F % 4 || sxb % 4 || sxt % 4 ||
                   reinterpret_cast<unsigned long long>(x) % 16))
    return bad;
  int lf_shift = 0;
  while ((1 << lf_shift) < lf && lf_shift < 8) ++lf_shift;
  if (lf < 1 || (1 << lf_shift) != lf) return bad;
  if (cs != 1 && cs != 2 && cs != 4 && cs != kMaxCluster) return bad;
  if (chunk < 1 || (long long)chunk * cs < T) return bad;
  const long long tiles = (F / vec + lf - 1) / lf;
  if (tiles > 65535 || (long long)B * cs > INT_MAX) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = static_cast<int>(tiles);
  if (vec == 1)
    return launch<1>(x, sxb, sxt, lens, out, B, T, F, ptype, lf_shift, nt,
                     cs, chunk, s);
  return launch<4>(x, sxb, sxt, lens, out, B, T, F, ptype, lf_shift, nt, cs,
                   chunk, s);
}

// The blocks of the vec (1 or 4) kernel an SM holds at once (its
// registers decide). Returns the cudaError_t of the query.
extern "C" int ptt_masked_pool_blocks_per_sm(int vec, int* blocks) {
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vec == 1 ? masked_pool_fwd_kernel<1> : masked_pool_fwd_kernel<4>,
      kThreads, 0));
}
