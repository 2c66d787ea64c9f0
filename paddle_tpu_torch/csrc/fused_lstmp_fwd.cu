// Fused LSTMP recurrence forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py `_lstmp_seq_kernel`
// (launched by `_lstmp_fwd_call`, wrapped by `fused_lstmp`): the whole masked
// recurrence of a dynamic_lstmp with no peepholes and the default
// activations, an LSTM whose hidden state is projected before it feeds the
// next step (reference lstmp_op.h). Per step t, with gate order {candidate,
// input, forget, output} (lstm_op.cc:125):
//   g = x[:, t] + r_prev @ W + b              [rows, 4D], W [P, 4D]
//   c_new = sigmoid(g_f) * c_prev + sigmoid(g_i) * tanh(g_c)
//   h_new = sigmoid(g_o) * tanh(c_new)
//   r_new = tanh(h_new @ W_proj)              [rows, P], W_proj [D, P]
//   (r, c) = t < len ? (r_new, c_new) : (r_prev, c_prev)   (masked carry)
// and proj[:, t] = r, cell[:, t] = c. `reverse` walks t from T-1 down, each
// step with its own mask (the TPU wrapper's flip of x and the mask), so the
// padding steps, which come first in reversed time, carry r0/c0 unchanged.
//
// What bounds it on this card. Counted over the valid (row, step) pairs,
// the work is 2 * (P * 4D + D * P) flops of the two products against
// (4D + P + D) * 4 bytes of x and outputs: at D = 1024, P = 512 (the
// DeepASR acoustic model) 5.2 MFLOP against 22 KB, far above the fp32
// balance point (~20 flops per byte), so its least time is the operations
// at 67 TFLOP/s. What holds it far from that is the recurrence: T dependent
// steps, each needing all of W and W_proj (8 MB + 2 MB) before the next can
// start. On the TPU the grid walks T in order with (r, c) resident in VMEM
// scratch and both weights in VMEM. On Hopper blocks run in no order, so,
// as in fused_lstm_fwd.cu, one block owns one batch row and loops over T
// itself, keeping r_prev, c, the step's gate products and h_new in shared
// memory (30 KB at the widths above). The weights do not fit in a block's
// 227 KB, so every step re-reads them from L2 (they stay in its 50 MB):
// the step's time is one SM's L2 read rate for 10 MB, whatever the batch.
// A block owning several rows would reuse each loaded weight for all of
// them but would not shorten a step, and it would leave SMs idle at the
// serving batch of 8; one row per block keeps the simple design. Each step
// has two dependent products, so three barriers: after the gate product,
// after the cell update (h_new complete), after the projection's partial
// sums. The gate product reads W's rows as float4 (a thread owns four
// adjacent gate columns), 8 loads in flight per thread; the projection
// splits D over the threads left once each of the P columns has one
// (partial sums in shared memory), 16 scalar loads in flight. 1024 threads
// leave 64 registers a thread, which those buffers fit.
//
// Later work: spread W's and W_proj's columns over all SMs (each keeps its
// ~78 KB slice in shared memory) with a grid-wide barrier per product, so
// the weights are read from L2 once per launch instead of once per step
// and row.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLoads4 = 8;   // float4 loads of W a thread keeps in flight
constexpr int kLoads = 16;   // scalar loads of W_proj a thread keeps in flight

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// One block per batch row. x: [B, T, 4D] with strides (sxb, sxt, 1); w4:
// W [P, 4D] as [P, D] float4; wp: W_proj [D, P].
__global__ void __launch_bounds__(kMaxThreads) fused_lstmp_fwd_kernel(
    const float* __restrict__ x, long long sxb, long long sxt,
    const float4* __restrict__ w4, const float* __restrict__ wp,
    const float* __restrict__ bias, const float* __restrict__ r0,
    const float* __restrict__ c0, const int* __restrict__ lens,
    float* __restrict__ proj, float* __restrict__ cell, int T, int D, int P,
    int reverse) {
  extern __shared__ float smem[];
  float* r_s = smem;        // [P]  r_prev
  float* c_s = r_s + P;     // [D]  c_prev
  float* h_s = c_s + D;     // [D]  the step's h_new
  float* g_s = h_s + D;     // [4D] the step's r_prev @ W
  float* red_s = g_s + 4 * D;  // [S, P] partial sums of h_new @ W_proj
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int len = lens ? lens[row] : T;
  const float* xr = x + row * sxb;
  // the projection: `cols` threads per slice of D, S slices
  const int cols = P < nth ? P : nth;
  const int S = nth / cols;
  const int kchunk = (D + S - 1) / S;
  const int slice = tid / cols;

  for (int i = tid; i < P; i += nth) r_s[i] = r0 ? r0[row * P + i] : 0.f;
  for (int i = tid; i < D; i += nth) c_s[i] = c0 ? c0[row * D + i] : 0.f;

  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    __syncthreads();  // r_s, c_s of the previous step (or r0, c0) are in
    // 1) r_prev @ W: thread c owns the gate columns 4c .. 4c+3. W comes
    // from L2 at every step, so the loads are issued kLoads4 at a time
    for (int c = tid; c < D; c += nth) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int kk = 0;
      for (; kk + kLoads4 <= P; kk += kLoads4) {
        float4 wv[kLoads4];
#pragma unroll
        for (int u = 0; u < kLoads4; ++u)
          wv[u] = __ldg(w4 + (long long)(kk + u) * D + c);
#pragma unroll
        for (int u = 0; u < kLoads4; ++u) {
          const float rv = r_s[kk + u];
          a0 = fmaf(rv, wv[u].x, a0);
          a1 = fmaf(rv, wv[u].y, a1);
          a2 = fmaf(rv, wv[u].z, a2);
          a3 = fmaf(rv, wv[u].w, a3);
        }
      }
      for (; kk < P; ++kk) {
        const float4 wv = __ldg(w4 + (long long)kk * D + c);
        const float rv = r_s[kk];
        a0 = fmaf(rv, wv.x, a0);
        a1 = fmaf(rv, wv.y, a1);
        a2 = fmaf(rv, wv.z, a2);
        a3 = fmaf(rv, wv.w, a3);
      }
      g_s[4 * c] = a0;
      g_s[4 * c + 1] = a1;
      g_s[4 * c + 2] = a2;
      g_s[4 * c + 3] = a3;
    }
    __syncthreads();  // every gate column of the step is in g_s
    // 2) the gates, the cell and h_new of each unit d
    const bool valid = t < len;
    const float* xt = xr + (long long)t * sxt;
    for (int d = tid; d < D; d += nth) {
      const float z = tanhf((xt[d] + g_s[d]) + __ldg(bias + d));
      const float ig =
          sigmoid_f((xt[D + d] + g_s[D + d]) + __ldg(bias + D + d));
      const float fg =
          sigmoid_f((xt[2 * D + d] + g_s[2 * D + d]) + __ldg(bias + 2 * D + d));
      const float og =
          sigmoid_f((xt[3 * D + d] + g_s[3 * D + d]) + __ldg(bias + 3 * D + d));
      const float c_prev = c_s[d];
      const float c_new = fg * c_prev + ig * z;
      h_s[d] = og * tanhf(c_new);
      const float cv = valid ? c_new : c_prev;
      c_s[d] = cv;
      cell[(row * T + t) * D + d] = cv;
    }
    __syncthreads();  // h_s holds the whole h_new
    // 3) h_new @ W_proj: slice s sums its kchunk rows of W_proj
    if (slice < S) {
      const int k0 = slice * kchunk;
      const int k1 = k0 + kchunk < D ? k0 + kchunk : D;
      for (int p = tid - slice * cols; p < P; p += cols) {
        float acc = 0.f;
        int kk = k0;
        for (; kk + kLoads <= k1; kk += kLoads) {
          float wv[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            wv[u] = __ldg(wp + (long long)(kk + u) * P + p);
#pragma unroll
          for (int u = 0; u < kLoads; ++u) acc = fmaf(h_s[kk + u], wv[u], acc);
        }
        for (; kk < k1; ++kk)
          acc = fmaf(h_s[kk], __ldg(wp + (long long)kk * P + p), acc);
        red_s[slice * P + p] = acc;
      }
    }
    __syncthreads();  // every slice's partial sums are in red_s
    for (int p = tid; p < P; p += nth) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += red_s[s * P + p];
      const float rv = valid ? tanhf(acc) : r_s[p];
      r_s[p] = rv;
      proj[(row * T + t) * P + p] = rv;
    }
  }
}

}  // namespace

// x: fp32 [B, T, 4D], last dim contiguous, batch/time strides sxb/sxt (in
// elements); w: fp32 [P, 4D] contiguous, 16-byte aligned; w_proj: fp32
// [D, P] contiguous; b: fp32 [4D]; r0: fp32 [B, P] or null (zeros); c0:
// fp32 [B, D] or null (zeros); lens: int32 [B] or null (every row full
// length); proj: fp32 [B, T, P] and cell: fp32 [B, T, D], contiguous.
// Returns the cudaError_t of the launch.
extern "C" int ptt_fused_lstmp_fwd(const float* x, long long sxb,
                                   long long sxt, const float* w,
                                   const float* w_proj, const float* b,
                                   const float* r0, const float* c0,
                                   const int* lens, float* proj, float* cell,
                                   int B, int T, int D, int P, int reverse,
                                   void* stream) {
  int threads = D > P ? D : P;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const int cols = P < threads ? P : threads;
  const int S = threads / cols;
  const size_t smem =
      sizeof(float) * ((size_t)P + 6 * (size_t)D + (size_t)S * P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_lstmp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_lstmp_fwd_kernel<<<B, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, sxb, sxt, reinterpret_cast<const float4*>(w), w_proj, b, r0, c0,
      lens, proj, cell, T, D, P, reverse);
  return static_cast<int>(cudaGetLastError());
}
