// Fused LSTM recurrence forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py `_lstm_seq_kernel`
// (launched by `_lstm_fwd_call`, wrapped by `fused_lstm`): the whole masked
// recurrence of a dynamic_lstm with no peepholes and the default
// activations. Per step t, with gate order {candidate, input, forget,
// output} (the reference's lstm_op.cc:125 {W_ch, W_ih, W_fh, W_oh}):
//   g = x[:, t] + h_prev @ W + b              [rows, 4D]
//   c_new = sigmoid(g_f) * c_prev + sigmoid(g_i) * tanh(g_c)
//   h_new = sigmoid(g_o) * tanh(c_new)
//   (h, c) = t < len ? (h_new, c_new) : (h_prev, c_prev)   (masked carry)
// and hidden[:, t] = h, cell[:, t] = c. `reverse` walks t from T-1 down,
// each step with its own mask, which is the TPU wrapper's flip of x and the
// mask: the padding steps, which come first in reversed time, carry h0/c0
// unchanged.
//
// What bounds it on this card. Counted over the valid (row, step) pairs,
// the work is 8*D*D flops of the recurrent product (plus ~20*D elementwise)
// against 24*D bytes of x and outputs, so at D = 128 it sits above the fp32
// balance point (~20 flops per byte) and its least time is the operations
// at 67 TFLOP/s. What holds it far from that is the recurrence itself: T
// dependent steps, each needing all of W. On the TPU the grid walks T in
// order with (h, c) resident in VMEM scratch and W in VMEM. On Hopper
// blocks run in no order, so one block owns one batch row and loops over
// T itself, keeping h_prev, c and the step's gates in shared memory. A
// batch of B rows is B blocks, so the path's batches (8 when serving, 128
// when training) put at most one block on each of the 132 SMs. At D = 128, W is [128, 512] fp32 = 256 KB, more than a block's 227 KB of
// shared memory, so this simple kernel reads W from global memory at every
// step (it stays in the 50 MB L2): each thread owns one gate column j and
// loads W[k, j] once per k (coalesced across the warp), 32 loads at a time
// before it uses the first, since a step waits on the latency of those
// loads; left to itself the compiler kept 2-8 in flight. x is read in place
// through its strides (no [T, B, 4D] copy) and hidden/cell are written
// straight into [B, T, D].
//
// Later work: split the 4D gate columns over a thread-block cluster, each
// block keeping its W slice in shared memory, with h_prev crossing between
// the blocks through distributed shared memory every step; then W is read
// from device memory once per launch instead of once per step and block.
#include <cuda_runtime.h>

namespace {

constexpr int kLoads = 32;  // W loads each thread keeps in flight

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// One block per batch row. x: [B, T, 4D] with strides (sxb, sxt, 1).
__global__ void fused_lstm_fwd_kernel(
    const float* __restrict__ x, long long sxb, long long sxt,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ lens, float* __restrict__ hidden,
    float* __restrict__ cell, int T, int D, int reverse) {
  extern __shared__ float smem[];
  float* h_s = smem;      // [D]  h_prev
  float* c_s = h_s + D;   // [D]  c_prev
  float* g_s = c_s + D;   // [4D] the step's gate pre-activations
  const int G = 4 * D;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int len = lens ? lens[row] : T;
  const float* xr = x + row * sxb;

  for (int i = tid; i < D; i += nth) {
    h_s[i] = h0 ? h0[row * D + i] : 0.f;
    c_s[i] = c0 ? c0[row * D + i] : 0.f;
  }

  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    __syncthreads();  // h_s, c_s of the previous step (or h0, c0) are in
    for (int j = tid; j < G; j += nth) {
      // W comes from L2 at every step, so the step's time is the latency
      // of its loads: issue kLoads of them before the first use
      float acc = 0.f;
      int kk = 0;
      for (; kk + kLoads <= D; kk += kLoads) {
        float wv[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          wv[u] = __ldg(w + (long long)(kk + u) * G + j);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) acc = fmaf(h_s[kk + u], wv[u], acc);
      }
      for (; kk < D; ++kk)
        acc = fmaf(h_s[kk], __ldg(w + (long long)kk * G + j), acc);
      g_s[j] = (xr[(long long)t * sxt + j] + acc) + __ldg(bias + j);
    }
    __syncthreads();  // every gate of the step is in g_s
    const bool valid = t < len;
    for (int d = tid; d < D; d += nth) {
      const float z = tanhf(g_s[d]);
      const float ig = sigmoid_f(g_s[D + d]);
      const float fg = sigmoid_f(g_s[2 * D + d]);
      const float og = sigmoid_f(g_s[3 * D + d]);
      const float c_prev = c_s[d], h_prev = h_s[d];
      const float c_new = fg * c_prev + ig * z;
      const float h_new = og * tanhf(c_new);
      const float h = valid ? h_new : h_prev;
      const float c = valid ? c_new : c_prev;
      h_s[d] = h;
      c_s[d] = c;
      const long long o = (row * T + t) * D + d;
      hidden[o] = h;
      cell[o] = c;
    }
  }
}

}  // namespace

// x: fp32 [B, T, 4D], last dim contiguous, batch/time strides sxb/sxt (in
// elements); w: fp32 [D, 4D] contiguous; b: fp32 [4D]; h0, c0: fp32 [B, D]
// or null (zeros); lens: int32 [B] or null (every row full length);
// hidden, cell: fp32 [B, T, D] contiguous. Returns the cudaError_t of the
// launch.
extern "C" int ptt_fused_lstm_fwd(const float* x, long long sxb,
                                  long long sxt, const float* w,
                                  const float* b, const float* h0,
                                  const float* c0, const int* lens,
                                  float* hidden, float* cell, int B, int T,
                                  int D, int reverse, void* stream) {
  const size_t smem = sizeof(float) * (size_t)6 * D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = 4 * D < 1024 ? 4 * D : 1024;
  threads = (threads + 31) / 32 * 32;
  fused_lstm_fwd_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, sxb, sxt, w, b, h0, c0, lens, hidden, cell, T, D, reverse);
  return static_cast<int>(cudaGetLastError());
}
