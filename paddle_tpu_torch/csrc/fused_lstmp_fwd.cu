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
// at 67 TFLOP/s. What holds it from that is the recurrence: T dependent
// steps, each needing all of W and W_proj (8 MB + 2 MB) before the next can
// start. On the TPU the grid walks T in order with (r, c) and both weights
// resident in VMEM. No SM holds 10 MB, so here the weights are spread over
// the whole card instead: one persistent block per SM (a cooperative
// launch, so that every block is resident and a grid-wide barrier cannot
// deadlock), and block j owns
//   * a slice of the hidden units, [u0, u1) (D / G of them, balanced), with
//     all four gate columns of each: its W slice [P, 4 (u1 - u0)] (64 KB at
//     D 1024, P 512, G 132) stays in shared memory for the whole launch, and
//     the cell update of its units is local (c never leaves the block);
//   * a slice of the projection's columns, [q0, q1), with its W_proj slice
//     [D, q1 - q0] (16 KB), also resident.
// Each step is two phases with a grid barrier after each:
//   A. stage r_prev^T [P, B] from L2 into shared memory (cp.async, row
//      tiles), the gate product of the block's 4 (u1 - u0) columns over
//      all rows (a thread owns an 8-row x 4-column tile over a slice of P:
//      per p one float4 of W and two of r^T for 32 FMAs; the slices'
//      partial sums meet through shared memory in a fixed order), then
//      the cell update; the block's h_new slice goes to a scratch buffer
//      [B, D] in global memory;                      -- barrier --
//   B. stage h_new [B, D] from L2 (cp.async), the block's projection
//      columns from it (a thread owns an 8-row x 4-column tile over a
//      slice of D; the 32 sums of a warp meet by recursive halving over
//      its lanes, 31 shuffles, then across warps in shared memory), the
//      tanh and the masked carry; the r slice goes to a scratch buffer
//      [P, B] and to proj.                           -- barrier --
// The exchanged r and h are written by other SMs in the same launch, so
// they are read through L2 only (cp.async.cg, never the non-coherent L1).
// The next step's x columns are prefetched into shared memory with
// cp.async while the current step runs. A step's floor is then two
// barriers plus the L2 reads of r and h (B (P + D) * 4 bytes per SM) plus
// the block's share of the flops, instead of one SM's L2 read of all 10
// MB. Where the slices do not fit in shared memory (widths well above
// DeepASR's, or a batch whose row buffers crowd them out), the same kernel
// reads its slices from L2 at every step (RESIDENT = false), still spread
// over all SMs.
//
// The launch plan (grid size from the SM count, the slices, the row tile,
// the h rows staged at once, the shared-memory size, resident or
// streamed, the x prefetch) is computed by the caller,
// `cuda_kernels.lstmp_launch_plan`, and passed in; the layout below must
// match it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroup = 8;  // rows of one thread's tile in phase A

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, cached in L1 (x: written before the launch)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes global -> shared through L2 only (.cg: another SM wrote them
// in this launch)
__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Grid-wide barrier over a counter that the caller zeroes before the
// launch: every block adds one with release semantics, then waits with
// acquire loads until the counter reaches its own running target (a
// multiple of the grid size). Valid only because the cooperative launch
// makes every block resident. The block barriers around it carry the
// ordering to and from the block's other threads. A barrier still open
// after kBarrierTimeoutNs traps, so that a fault ends the launch with an
// error instead of spinning forever.
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
                 : "memory");
    const unsigned long long t0 = global_ns();
    unsigned int v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
      if (static_cast<int>(v - target) >= 0) break;
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// One step of a recursive-halving reduction over a warp: the lanes with
// bit HALF set keep the upper half of v[0 .. 2 HALF), the others the lower,
// each adding its partner's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int o = 0; o < HALF; ++o) {
    const float send = upper ? v[o] : v[o + HALF];
    const float keep = upper ? v[o + HALF] : v[o];
    v[o] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// x: [B, T, 4D] with strides (sxb, sxt, 1); w: W [P, 4D]; wp: W_proj [D, P].
// scratch: [4 + Pp * b_pad + B * Dp] fp32, zeroed by the caller: the
// barrier counter (as uint), then r transposed [Pp][b_pad] and h [B][Dp]
// (Pp, Dp: P, D rounded up to 4; b_pad: B rounded up to the row tile; the
// padding stays 0).
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1) fused_lstmp_fwd_kernel(
    const float* __restrict__ x, long long sxb, long long sxt,
    const float* __restrict__ w, const float* __restrict__ wp,
    const float* __restrict__ bias, const float* __restrict__ r0,
    const float* __restrict__ c0, const int* __restrict__ lens,
    float* __restrict__ proj, float* __restrict__ cell,
    float* __restrict__ scratch, int B, int T, int D, int P, int reverse,
    int ku, int kp, int row_tile, int h_rows, int prefetch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int G = gridDim.x, j = blockIdx.x;
  const int Pp = round4(P), Dp = round4(D), kp4 = round4(kp);
  const int ncmax = 4 * ku;
  const int b_pad = (B + row_tile - 1) / row_tile * row_tile;
  // this block's hidden units and projection columns (balanced split)
  const int u0 = static_cast<int>((long long)j * D / G);
  const int u1 = static_cast<int>((long long)(j + 1) * D / G);
  const int q0 = static_cast<int>((long long)j * P / G);
  const int q1 = static_cast<int>((long long)(j + 1) * P / G);
  const int nu = u1 - u0, nc = 4 * nu, nq = q1 - q0;

  // shared-memory layout (floats; every region a multiple of 4). One
  // region holds phase A's r_prev^T tile, partial sums and their sums,
  // then phase B's rows of h_new
  const int dv = Dp / 4;
  float* w_s = smem;                                    // [Pp][nc]
  float* wp_s = w_s + (RESIDENT ? Pp * ncmax : 0);      // [4][Dp/4][kp4]
  float* rt_s = wp_s + (RESIDENT ? Dp * kp4 : 0);       // [Pp][row_tile]
  float* red_s = rt_s + Pp * row_tile;                  // [KS][row_tile][nc]
  float* sum_s = red_s + kThreads * 4 * kRowGroup;      // [row_tile][nc]
  float* h_s = rt_s;                                    // [h_rows][Dp]
  float* wsum_s = h_s + h_rows * Dp;                    // [kThreads]
  float* xs = rt_s + max(Pp * row_tile + kThreads * 4 * kRowGroup +
                             row_tile * ncmax,
                         h_rows * Dp + kThreads);       // [2][B][ncmax]
  float* c_s = xs + (prefetch ? round4(2 * B * ncmax) : 0);  // [B][ku]
  float* ro_s = c_s + round4(B * ku);                   // [B][kp]
  int* lens_s = reinterpret_cast<int*>(ro_s + round4(B * kp));  // [B]

  unsigned int* count = reinterpret_cast<unsigned int*>(scratch);
  float* rbuf = scratch + 4;                     // r^T [Pp][b_pad]
  float* hbuf = rbuf + (long long)Pp * b_pad;    // h [B][Dp]
  unsigned int target = 0;

  // phase A's thread roles: an 8-row x 4-column tile of the gate product
  // (row group rg, column group cg) over slice ks of P
  const int CG = nu, tiles = row_tile / kRowGroup * CG;
  const int KS = tiles ? kThreads / tiles : 0;
  const int tile = tiles ? tid % tiles : 0;
  const int ks = tiles ? tid / tiles : 0;
  const int rg = CG ? tile / CG : 0, cg = CG ? tile % CG : 0;
  const int slice = KS ? (Pp + KS - 1) / KS : 0;
  const int p_lo = ks * slice;
  const int p_hi = min(Pp, p_lo + slice);
  // the global columns of W that gate columns 4 cg .. 4 cg + 3 read
  int gcol[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * cg + e;
    gcol[e] = nu ? (c / nu) * D + u0 + c % nu : 0;
  }

  // the weight slices, once per launch
  if (RESIDENT) {
    for (int i = tid; i < Pp * nc; i += kThreads) {
      const int p = i / nc, c = i % nc;
      w_s[i] = p < P ? w[(long long)p * 4 * D + (c / nu) * D + u0 + c % nu]
                     : 0.f;
    }
    // W_proj row d = 4 i + e at plane e, row i: the lanes of phase B,
    // which read rows 4 i .. 4 i + 3 for consecutive i, stay off each
    // other's banks
    for (int i = tid; i < Dp * kp4; i += kThreads) {
      const int d = i / kp4, q = i % kp4;
      wp_s[((d & 3) * dv + (d >> 2)) * kp4 + q] =
          (d < D && q < nq) ? wp[(long long)d * P + q0 + q] : 0.f;
    }
  }
  for (int i = tid; i < B; i += kThreads) lens_s[i] = lens ? lens[i] : T;
  for (int i = tid; i < B * ku; i += kThreads) {
    const int b = i / ku, u = i % ku;
    c_s[i] = (c0 && u < nu) ? c0[(long long)b * D + u0 + u] : 0.f;
  }
  for (int i = tid; i < B * kp; i += kThreads) {
    const int b = i / kp, q = i % kp;
    const float v = (r0 && q < nq) ? r0[(long long)b * P + q0 + q] : 0.f;
    ro_s[i] = v;
    if (r0 && q < nq) rbuf[(long long)(q0 + q) * b_pad + b] = v;
  }

  // x columns of step k into xs[k & 1], asynchronously (without
  // `prefetch`, the cell update reads x from global memory itself)
  auto prefetch_x = [&](int k) {
    if (prefetch && k < T) {
      const int t = reverse ? T - 1 - k : k;
      float* dst = xs + (k & 1) * B * ncmax;
      for (int i = tid; i < B * nc; i += kThreads) {
        const int b = i / nc, c = i % nc;
        cp_async4(dst + b * ncmax + c,
                  x + b * sxb + t * sxt + (c / nu) * D + u0 + c % nu);
      }
    }
    cp_async_commit();
  };
  prefetch_x(0);
  if (r0) grid_barrier(count, target);  // every block's r0 columns are in

  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    prefetch_x(k + 1);
    const float* xk = xs + (k & 1) * B * ncmax;
    const float* xt = x + (long long)t * sxt + u0;

    // ---- phase A: gates, cell update and h_new of the block's units ----
    for (int b0 = 0; b0 < B; b0 += row_tile) {
      const int nb = min(row_tile, B - b0);
      // stage r_prev^T [Pp][rows b0 .. b0 + row_tile) from L2, every copy
      // in flight at once (rows past B are the buffer's zero padding)
      const int rv4 = row_tile / 4;
      for (int i = tid; i < Pp * rv4; i += kThreads) {
        const int p = i / rv4, r4 = i % rv4;
        cp_async16_cg(rt_s + p * row_tile + 4 * r4,
                      rbuf + (long long)p * b_pad + b0 + 4 * r4);
      }
      cp_async_commit();
      cp_async_wait_all();  // rt_s and (at the first tile) xk have landed
      __syncthreads();
      // the thread's 8 x 4 tile over its slice of P: per p one float4 of
      // W and two of r^T for 32 FMAs
      if (ks < KS) {
        float acc[kRowGroup][4];
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
        const float* rcol = rt_s + rg * kRowGroup;
#pragma unroll 4
        for (int p = p_lo; p < p_hi; ++p) {
          float wv[4];
          if (RESIDENT) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(w_s + p * nc + 4 * cg);
            wv[0] = w4.x;
            wv[1] = w4.y;
            wv[2] = w4.z;
            wv[3] = w4.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wv[e] = p < P ? __ldg(w + (long long)p * 4 * D + gcol[e]) : 0.f;
          }
          const float4 ra =
              *reinterpret_cast<const float4*>(rcol + p * row_tile);
          const float4 rb =
              *reinterpret_cast<const float4*>(rcol + p * row_tile + 4);
          const float rr[kRowGroup] = {ra.x, ra.y, ra.z, ra.w,
                                       rb.x, rb.y, rb.z, rb.w};
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][e] = fmaf(rr[r], wv[e], acc[r][e]);
        }
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r)
          *reinterpret_cast<float4*>(
              red_s + (ks * row_tile + rg * kRowGroup + r) * nc + 4 * cg) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      __syncthreads();  // every slice's partial sums are in red_s
      // the slices' sum of each (row, column), all threads at once
      for (int i = tid; i < nb * nc; i += kThreads) {
        float sum = 0.f;
#pragma unroll 8
        for (int q = 0; q < KS; ++q) sum += red_s[q * row_tile * nc + i];
        sum_s[i] = sum;
      }
      __syncthreads();
      for (int i = tid; i < nb * nu; i += kThreads) {
        const int r = i / nu, u = i % nu, b = b0 + r;
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float xv = prefetch ? xk[b * ncmax + g * nu + u]
                                    : __ldg(xt + b * sxb + g * D + u);
          gs[g] = (xv + sum_s[r * nc + g * nu + u]) +
                  __ldg(bias + g * D + u0 + u);
        }
        const float z = tanhf(gs[0]);
        const float ig = sigmoid_f(gs[1]);
        const float fg = sigmoid_f(gs[2]);
        const float og = sigmoid_f(gs[3]);
        const float c_prev = c_s[b * ku + u];
        const float c_new = fg * c_prev + ig * z;
        __stcg(hbuf + (long long)b * Dp + u0 + u, og * tanhf(c_new));
        const float cv = t < lens_s[b] ? c_new : c_prev;
        c_s[b * ku + u] = cv;
        cell[((long long)b * T + t) * D + u0 + u] = cv;
      }
      // the next tile's staging rewrites rt_s only; its partial sums are
      // written after the block barrier that follows the staging
    }
    grid_barrier(count, target);  // h_new complete

    // ---- phase B: the block's projection columns ----
    for (int hb0 = 0; hb0 < B && nq > 0; hb0 += h_rows) {
      const int nbh = min(h_rows, B - hb0);
      // stage h_new rows [hb0, hb0 + nbh) from L2, every copy in flight
      for (int i = tid; i < nbh * dv; i += kThreads)
        cp_async16_cg(h_s + 4 * i, hbuf + (long long)hb0 * Dp + 4 * i);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      // thread (row group rg, slice sd of D) sums an 8-row x 4-column
      // tile: per 4 units one float4 of h per row and four of W_proj for
      // 128 FMAs. A row group has wg whole warps (h_rows <= 64)
      const int rgs = (nbh + kRowGroup - 1) / kRowGroup;
      const int wg = (kThreads / 32) / rgs, sdn = 32 * wg;
      const int rg = tid / sdn, sd = tid % sdn, lane = tid & 31;
      for (int qb = 0; qb < nq; qb += 4) {
        float v[kRowGroup * 4];
#pragma unroll
        for (int o = 0; o < kRowGroup * 4; ++o) v[o] = 0.f;
        if (rg < rgs) {
          for (int i = sd; i < dv; i += sdn) {
            float wq[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (RESIDENT) {
                const float4 wv = *reinterpret_cast<const float4*>(
                    wp_s + (e * dv + i) * kp4 + qb);
                wq[e][0] = wv.x;
                wq[e][1] = wv.y;
                wq[e][2] = wv.z;
                wq[e][3] = wv.w;
              } else {
                const int d = 4 * i + e;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  wq[e][q] = (d < D && qb + q < nq)
                                 ? __ldg(wp + (long long)d * P + q0 + qb + q)
                                 : 0.f;
              }
            }
#pragma unroll
            for (int r = 0; r < kRowGroup; ++r) {
              const int row = rg * kRowGroup + r;
              if (row < nbh) {
                const float4 hv =
                    *reinterpret_cast<const float4*>(h_s + row * Dp + 4 * i);
                const float he[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    v[r * 4 + q] = fmaf(he[e], wq[e][q], v[r * 4 + q]);
              }
            }
          }
        }
        // reduce the 32 sums over the warp's lanes by recursive halving:
        // lane l ends with the warp's total of tile element l
        halve<16>(v, lane);
        halve<8>(v, lane);
        halve<4>(v, lane);
        halve<2>(v, lane);
        halve<1>(v, lane);
        wsum_s[tid] = v[0];
        __syncthreads();
        // the row group's warps add up; element l is (row l / 4, col l % 4)
        if (tid < rgs * 32) {
          const int g = tid / 32, l = tid % 32;
          float sum = 0.f;
          for (int w = 0; w < wg; ++w) sum += wsum_s[(g * wg + w) * 32 + l];
          const int r = g * kRowGroup + l / 4, q = qb + l % 4;
          if (r < nbh && q < nq) {
            const int b = hb0 + r;
            const float rv =
                t < lens_s[b] ? tanhf(sum) : ro_s[b * kp + q];
            ro_s[b * kp + q] = rv;
            __stcg(rbuf + (long long)(q0 + q) * b_pad + b, rv);
            proj[((long long)b * T + t) * P + q0 + q] = rv;
          }
        }
        __syncthreads();  // wsum_s (and, after the last pass, h_s) is free
      }
    }
    if (k + 1 < T) grid_barrier(count, target);  // r complete
  }
}

template <bool RESIDENT>
cudaError_t launch(const float* x, long long sxb, long long sxt,
                   const float* w, const float* w_proj, const float* b,
                   const float* r0, const float* c0, const int* lens,
                   float* proj, float* cell, float* scratch, int B, int T,
                   int D, int P, int reverse, int grid, int ku, int kp,
                   int row_tile, int h_rows, int prefetch, int smem,
                   cudaStream_t stream) {
  auto kernel = fused_lstmp_fwd_kernel<RESIDENT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, x, sxb, sxt, w, w_proj, b, r0,
                            c0, lens, proj, cell, scratch, B, T, D, P,
                            reverse, ku, kp, row_tile, h_rows, prefetch);
}

}  // namespace

// x: fp32 [B, T, 4D], last dim contiguous, batch/time strides sxb/sxt (in
// elements); w: fp32 [P, 4D] and w_proj: fp32 [D, P], contiguous; b: fp32
// [4D]; r0: fp32 [B, P] or null (zeros); c0: fp32 [B, D] or null (zeros);
// lens: int32 [B] or null (every row full length); proj: fp32 [B, T, P] and
// cell: fp32 [B, T, D], contiguous; scratch: fp32 [4 + Pp * b_pad + B *
// Dp], zeroed. The plan (grid, ku = the most units a block owns, kp = the
// most projection columns, row_tile, h_rows, prefetch, smem bytes,
// resident, threads) comes from cuda_kernels.lstmp_launch_plan. Returns the
// cudaError_t of the launch (cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be resident).
extern "C" int ptt_fused_lstmp_fwd(const float* x, long long sxb,
                                   long long sxt, const float* w,
                                   const float* w_proj, const float* b,
                                   const float* r0, const float* c0,
                                   const int* lens, float* proj, float* cell,
                                   float* scratch, int B, int T, int D, int P,
                                   int reverse, int grid, int ku, int kp,
                                   int row_tile, int h_rows, int prefetch,
                                   int smem, int resident, int threads,
                                   void* stream) {
  if (threads != kThreads || row_tile <= 0 || row_tile % kRowGroup ||
      row_tile / kRowGroup * ku > kThreads || h_rows <= 0 ||
      h_rows > kThreads / 32 * kRowGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      resident ? launch<true>(x, sxb, sxt, w, w_proj, b, r0, c0, lens, proj,
                              cell, scratch, B, T, D, P, reverse, grid, ku,
                              kp, row_tile, h_rows, prefetch, smem, s)
               : launch<false>(x, sxb, sxt, w, w_proj, b, r0, c0, lens, proj,
                               cell, scratch, B, T, D, P, reverse, grid, ku,
                               kp, row_tile, h_rows, prefetch, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
