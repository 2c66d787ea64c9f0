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
// dependent steps, each needing all of W (256 KB at D = 128, more than one
// block's 227 KB of shared memory) and all of the previous step's h. On the
// TPU the grid walks T in order with (h, c) resident in VMEM scratch and W
// in VMEM.
//
// Design: a thread-block cluster per group of rows. The launch is clusters
// of CS blocks (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension;
// CS up to 16, above 8 with the non-portable attribute). Cluster q owns the
// batch rows [q R, q R + R); clusters never wait on each other, so no
// cooperative launch is needed and clusters that do not fit at once run in
// waves. Block j of a cluster owns the hidden units [u0, u1) =
// [j D / CS, (j + 1) D / CS) with all four gate columns of each:
//   * its W slice [D, 4 (u1 - u0)] stays in shared memory for the whole
//     launch (32 KB at D = 128, CS = 8), stored unit-major (column 4 u + g)
//     so that a float4 holds the four gates of one unit;
//   * its c and its bias slice stay in shared memory, and its hidden and
//     cell columns are written by it alone;
//   * it holds the full h_prev of its rows, transposed [D][rows], in its own
//     shared memory, double-buffered by step parity.
// A step:
//   1. the gate product of the R rows x the block's 4 (u1 - u0) columns over
//      D, from the resident W slice and h_prev: a thread owns a tile of RG
//      rows x the 4 gates of one unit over a slice of D (per k one float4 of
//      W and RG / 4 of h, for 4 RG independent FMAs); the slices' partial
//      sums go to shared memory;
//   2. a block barrier; then a thread per (row, unit) sums the slices'
//      partials in a fixed order, adds x (copied into shared memory with
//      cp.async during the previous step, 16 bytes a copy where aligned)
//      and the bias, and does the cell update (the fast exponential and
//      reciprocal) and the masked carry;
//   3. the same thread stores h into its own block's next h buffer and
//      into every peer's through distributed shared memory (mapa +
//      st.shared::cluster);
//   4. one cluster barrier (barrier.cluster.arrive.release /
//      wait.acquire), the step's hidden and cell columns written to global
//      memory between its two halves so that the release does not wait
//      for them.
// No loop of a step divides: each thread walks its indices by carries
// from digits divided once at the set-up (Walk).
// Why one cluster barrier a step is enough: step k reads h buffer k % 2
// and writes buffer (k + 1) % 2, its own and its peers'. Every block last
// read buffer (k + 1) % 2 in step k - 1, before that step's cluster
// barrier, and no block writes into a peer in step k before it has passed
// that barrier itself, which needs every thread of the cluster to have
// arrived. The readers of buffer (k + 1) % 2 in step k + 1 start after the
// barrier of step k, which every writer reached after its stores (release
// / acquire). The same barrier orders the block's own reuse of the partial
// sums and of the x buffer. A cluster barrier after the set-up makes sure
// every peer is running before the first remote store; the last step
// stores nothing remote, so no block can exit while a peer still writes
// into it.
// Sums run in a fixed order with no atomics: two runs give the same bits.
//
// Where a W slice does not fit in shared memory (D = 512 is 256 KB a block
// even at CS = 16) the same kernel reads its slice from L2 at every step
// (RESIDENT = false), still spread over the cluster. The launch plan (CS,
// R, the row tile RG, the D slices, resident or streamed, the x prefetch,
// the shared-memory bytes, the threads) is computed by the caller,
// `cuda_kernels.lstm_launch_plan`, and passed in; the entry point checks it
// against the layout below (smem_floats) and refuses any other.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// The shared-memory layout in 4-byte words, region by region (each a
// multiple of 4): W slice [D][4 ku] (resident only), h [2][D][rp], partial
// sums [ks][rp][4 ku], x [2][R][4 ku] (prefetch only), bias [4 ku], c
// [R][ku], lengths [R].
__host__ __device__ constexpr long long smem_floats(int D, int R, int ku,
                                                    int rp, int ks,
                                                    bool resident,
                                                    bool prefetch) {
  return (resident ? 4LL * D * ku : 0) + 2LL * D * rp + 4LL * ks * rp * ku +
         (prefetch ? 8LL * R * ku : 0) + 4LL * ku + round4(R * ku) +
         round4(R);
}

// plans at the path's D = 128 fit a block: the training step's (CS = 2,
// R = 2) and the larger ones at CS 8 and 16 (the serving dispatch's, CS =
// 8 and R = 1, is smaller)
static_assert(4 * smem_floats(128, 8, 16, 8, 16, true, true) <= kSmemLimit,
              "K6 plan at D = 128, CS = 8, R = 8 overflows shared memory");
static_assert(4 * smem_floats(128, 2, 64, 4, 4, true, true) <= kSmemLimit,
              "K6 plan at D = 128, CS = 2, R = 2 overflows shared memory");
static_assert(4 * smem_floats(128, 16, 8, 16, 32, true, true) <= kSmemLimit,
              "K6 plan at D = 128, CS = 16, R = 16 overflows shared memory");

// The gates' squashing functions from the fast exponential (ex2.approx)
// and reciprocal (rcp.approx); both saturate exactly (an infinite
// exponential gives 0, 1 or -1).
__device__ __forceinline__ float sigmoid_f(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_f(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
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

// a float into the shared memory of block `rank` of this cluster, at the
// place `local` (a shared address of this block) has there
__device__ __forceinline__ void st_peer(unsigned int local,
                                        unsigned int rank, float v) {
  unsigned int remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v)
               : "memory");
}

// The digits (q, a, b) of i = (q * na + a) * nb + b as a thread walks i =
// tid, tid + kThreads, ...: divided once at the set-up, then advanced by
// kThreads's digits with carries, so that no loop of a step divides.
struct Walk {
  int q, a, b, dq, da, db, na, nb;
  __device__ Walk(int na_, int nb_) : na(na_), nb(nb_) {
    const int n = na * nb, rem = threadIdx.x % n, drem = kThreads % n;
    q = threadIdx.x / n;
    a = rem / nb;
    b = rem % nb;
    dq = kThreads / n;
    da = drem / nb;
    db = drem % nb;
  }
  __device__ __forceinline__ void next() {
    q += dq;
    a += da;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
    if (a >= na) {
      a -= na;
      ++q;
    }
  }
};

// The cluster barrier in its two halves: every thread of the cluster
// arrives (releasing its earlier stores) and then waits (acquiring every
// other thread's). Work between the two overlaps the barrier, and its
// stores are not released by this arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 4 or 16 bytes global -> shared (x: written before the launch)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x: [B, T, 4D] with strides (sxb, sxt, 1). R rows a cluster, ku = the
// most units a block owns, ks = the slices of D in the gate product, RG =
// the rows of a thread's tile (rp = R rounded up to RG).
template <bool RESIDENT, int RG>
__global__ void __launch_bounds__(kThreads, 1) fused_lstm_fwd_kernel(
    const float* __restrict__ x, long long sxb, long long sxt,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ lens, float* __restrict__ hidden,
    float* __restrict__ cell, int B, int T, int D, int reverse, int R,
    int ku, int ks_n, int prefetch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cs = static_cast<int>(cluster_nctarank());
  const int j = static_cast<int>(cluster_ctarank());
  const int row0 = static_cast<int>(cluster_id()) * R;
  const int nrows = min(R, B - row0);
  // this block's hidden units (balanced split of D over the cluster)
  const int u0 = static_cast<int>((long long)j * D / cs);
  const int u1 = static_cast<int>((long long)(j + 1) * D / cs);
  const int nu = u1 - u0;
  const int nc = 4 * ku;  // row stride of the W slice, partials and x
  const int rp = (R + RG - 1) / RG * RG;

  float* w_s = smem;                                    // [D][nc]
  float* h_s = w_s + (RESIDENT ? D * nc : 0);           // [2][D][rp]
  float* red_s = h_s + 2 * D * rp;                      // [ks][rp][nc]
  float* xs = red_s + ks_n * rp * nc;                   // [2][R][nc]
  float* b_s = xs + (prefetch ? 2 * R * nc : 0);        // [nc]
  float* c_s = b_s + nc;                                // [R][ku]
  int* lens_s = reinterpret_cast<int*>(c_s + round4(R * ku));  // [R]

  // the set-up: W slice and bias (unit-major), h0 into buffer 0 (buffer 1
  // zeroed: its rows past the cluster's never change), c0, the lengths
  if (RESIDENT) {
    for (int i = tid; i < D * nc; i += kThreads) {
      const int k = i / nc, c = i % nc, u = c >> 2, g = c & 3;
      w_s[i] = u < nu ? w[(long long)k * 4 * D + g * D + u0 + u] : 0.f;
    }
  }
  for (int c = tid; c < nc; c += kThreads)
    b_s[c] = (c >> 2) < nu ? bias[(c & 3) * D + u0 + (c >> 2)] : 0.f;
  for (int i = tid; i < D * rp; i += kThreads) {
    const int k = i / rp, r = i % rp;
    h_s[i] = (h0 && r < nrows) ? h0[(long long)(row0 + r) * D + k] : 0.f;
    h_s[D * rp + i] = 0.f;
  }
  for (int i = tid; i < R * ku; i += kThreads) {
    const int r = i / ku, u = i % ku;
    c_s[i] = (c0 && r < nrows && u < nu)
                 ? c0[(long long)(row0 + r) * D + u0 + u]
                 : 0.f;
  }
  for (int r = tid; r < R; r += kThreads)
    lens_s[r] = r < nrows ? (lens ? lens[row0 + r] : T) : 0;

  // x's gate columns of the block's units are copied 16 bytes at a time
  // where every such run starts 16-byte aligned
  const int xv = (reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                  sxb % 4 == 0 && sxt % 4 == 0 && D % 4 == 0 && u0 % 4 == 0 &&
                  nu % 4 == 0 && ku % 4 == 0)
                     ? 4
                     : 1;
  // each loop's walk: (row, gate, unit or unit quad) of the x copies,
  // (slice, row group, unit) of the product's tiles, (row, unit) of the
  // cell update
  const Walk walk_x(4, nu / xv), walk_tile(rp / RG, nu), walk_cell(1, nu);
  const int tiles = rp / RG * nu;
  const int kslice = (D + ks_n - 1) / ks_n;

  // the x columns of step k (the block's gates of the cluster's rows) into
  // xs[k & 1], gate-major ([row][gate][ku]), asynchronously: neighbouring
  // threads read neighbouring addresses
  auto prefetch_x = [&](int k) {
    if (prefetch && k < T) {
      const int t = reverse ? T - 1 - k : k;
      float* dst = xs + (k & 1) * R * nc;
      const float* src = x + row0 * sxb + t * sxt + u0;
      Walk ix = walk_x;
      for (int i = tid; i < nrows * 4 * nu / xv; i += kThreads, ix.next()) {
        float* d = dst + ix.q * nc + ix.a * ku + ix.b * xv;
        const float* g = src + ix.q * sxb + ix.a * D + ix.b * xv;
        if (xv == 4)
          cp_async16(d, g);
        else
          cp_async4(d, g);
      }
    }
    cp_async_commit();
  };
  prefetch_x(0);
  cluster_arrive();  // every peer runs and is set up
  cluster_wait();

  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    prefetch_x(k + 1);
    const float* hb = h_s + (k & 1) * D * rp;
    float* hn = h_s + ((k + 1) & 1) * D * rp;

    // 1. the gate product: tile (row group rg, unit u) over slice ks of D
    Walk it = walk_tile;
    for (int item = tid; item < tiles * ks_n; item += kThreads, it.next()) {
      const int ks = it.q, rg = it.a, u = it.b;
      const int k_lo = ks * kslice, k_hi = min(D, k_lo + kslice);
      float acc[RG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      const float* hcol = hb + rg * RG;
#pragma unroll 4
      for (int kk = k_lo; kk < k_hi; ++kk) {
        float wv[4];
        if (RESIDENT) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(w_s + kk * nc + 4 * u);
          wv[0] = w4.x;
          wv[1] = w4.y;
          wv[2] = w4.z;
          wv[3] = w4.w;
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            wv[g] = __ldg(w + (long long)kk * 4 * D + g * D + u0 + u);
        }
        float hv[RG];
#pragma unroll
        for (int q = 0; q < RG / 4; ++q) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(hcol + kk * rp + 4 * q);
          hv[4 * q] = h4.x;
          hv[4 * q + 1] = h4.y;
          hv[4 * q + 2] = h4.z;
          hv[4 * q + 3] = h4.w;
        }
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[r][g] = fmaf(hv[r], wv[g], acc[r][g]);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
        *reinterpret_cast<float4*>(red_s + (ks * rp + rg * RG + r) * nc +
                                   4 * u) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    cp_async_wait_prev();  // this thread's copies of step k's x
    __syncthreads();       // every partial sum and every x copy is in

    // 2. the cell update of each (row, unit) (the last step: hidden and
    // cell straight to global memory)
    const float* xk = xs + (k & 1) * R * nc;
    Walk ic = walk_cell;
    for (int i = tid; i < nrows * nu; i += kThreads, ic.next()) {
      const int r = ic.q, u = ic.b;
      float4 sum = *reinterpret_cast<const float4*>(red_s + r * nc + 4 * u);
      for (int q = 1; q < ks_n; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            red_s + (q * rp + r) * nc + 4 * u);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      float xg[4];
      if (prefetch) {
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = xk[r * nc + g * ku + u];
      } else {
        const float* xr = x + (row0 + r) * sxb + t * sxt + u0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = __ldg(xr + g * D);
      }
      const float4 bv = *reinterpret_cast<const float4*>(b_s + 4 * u);
      const float z = tanh_f((xg[0] + sum.x) + bv.x);
      const float ig = sigmoid_f((xg[1] + sum.y) + bv.y);
      const float fg = sigmoid_f((xg[2] + sum.z) + bv.z);
      const float og = sigmoid_f((xg[3] + sum.w) + bv.w);
      const float c_prev = c_s[r * ku + u];
      const float h_prev = hb[(u0 + u) * rp + r];
      const float c_new = fg * c_prev + ig * z;
      const float h_new = og * tanh_f(c_new);
      const bool valid = t < lens_s[r];
      const float h = valid ? h_new : h_prev;
      const float c = valid ? c_new : c_prev;
      c_s[r * ku + u] = c;
      if (k + 1 < T) {
        // 3. h into this block's next h buffer and, through distributed
        // shared memory, into every peer's (each block starting at the
        // rank after its own)
        hn[(u0 + u) * rp + r] = h;
        const unsigned int local = smem_addr(hn + (u0 + u) * rp + r);
        for (int p = 1; p < cs; ++p)
          st_peer(local, j + p < cs ? j + p : j + p - cs, h);
      } else {
        const long long o = ((long long)(row0 + r) * T + t) * D + u0 + u;
        hidden[o] = h;
        cell[o] = c;
      }
    }
    if (k + 1 < T) {
      // 4. the cluster barrier: every h of the step is in. The step's
      // hidden and cell columns go to global memory between its halves,
      // so that the arrive does not wait for them
      cluster_arrive();
      Walk io = walk_cell;
      for (int i = tid; i < nrows * nu; i += kThreads, io.next()) {
        const int r = io.q, u = io.b;
        const long long o = ((long long)(row0 + r) * T + t) * D + u0 + u;
        hidden[o] = hn[(u0 + u) * rp + r];
        cell[o] = c_s[r * ku + u];
      }
      cluster_wait();
    }
  }
}

template <bool RESIDENT, int RG>
cudaError_t prepare(int cs, int smem) {
  auto kernel = fused_lstm_fwd_kernel<RESIDENT, RG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

void cluster_config(cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
                    int grid, int cs, int smem, cudaStream_t stream) {
  *config = {};
  config->gridDim = dim3(grid);
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = static_cast<size_t>(smem);
  config->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
}

template <bool RESIDENT, int RG>
cudaError_t launch(const float* x, long long sxb, long long sxt,
                   const float* w, const float* b, const float* h0,
                   const float* c0, const int* lens, float* hidden,
                   float* cell, int B, int T, int D, int reverse, int cs,
                   int R, int ku, int ks, int prefetch, int smem,
                   cudaStream_t stream) {
  const cudaError_t e = prepare<RESIDENT, RG>(cs, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cluster_config(&config, attr, (B + R - 1) / R * cs, cs, smem, stream);
  return cudaLaunchKernelEx(&config, fused_lstm_fwd_kernel<RESIDENT, RG>, x,
                            sxb, sxt, w, b, h0, c0, lens, hidden, cell, B, T,
                            D, reverse, R, ku, ks, prefetch);
}

template <bool RESIDENT, int RG>
cudaError_t max_clusters(int cs, int smem, int* count) {
  const cudaError_t e = prepare<RESIDENT, RG>(cs, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cluster_config(&config, attr, cs, cs, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(
      count, fused_lstm_fwd_kernel<RESIDENT, RG>, &config);
}

bool plan_ok(int D, int cs, int R, int ku, int rg, int ks, int prefetch,
             int smem, int resident, int threads) {
  if (threads != kThreads || cs < 1 || cs > kMaxCluster || cs > D ||
      R < 1 || ks < 1 || ks > D || (rg != 4 && rg != 8) ||
      ku != (D + cs - 1) / cs)
    return false;
  const int rp = (R + rg - 1) / rg * rg;
  const long long bytes =
      4 * smem_floats(D, R, ku, rp, ks, resident != 0, prefetch != 0);
  return bytes == smem && bytes <= kSmemLimit;
}

}  // namespace

// x: fp32 [B, T, 4D], last dim contiguous, batch/time strides sxb/sxt (in
// elements); w: fp32 [D, 4D] contiguous; b: fp32 [4D]; h0, c0: fp32 [B, D]
// or null (zeros); lens: int32 [B] or null (every row full length);
// hidden, cell: fp32 [B, T, D] contiguous. The plan (cs = blocks a cluster,
// rows = R rows a cluster, ku = the most units a block owns, rg = rows of
// a thread's tile, ks = slices of D, prefetch, smem bytes, resident,
// threads) comes from cuda_kernels.lstm_launch_plan; a plan that does not
// match this file's layout gives cudaErrorInvalidValue. Returns the
// cudaError_t of the launch.
extern "C" int ptt_fused_lstm_fwd(const float* x, long long sxb,
                                  long long sxt, const float* w,
                                  const float* b, const float* h0,
                                  const float* c0, const int* lens,
                                  float* hidden, float* cell, int B, int T,
                                  int D, int reverse, int cs, int rows,
                                  int ku, int rg, int ks, int prefetch,
                                  int smem, int resident, int threads,
                                  void* stream) {
  if (!plan_ok(D, cs, rows, ku, rg, ks, prefetch, smem, resident, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (resident)
    e = rg == 8 ? launch<true, 8>(x, sxb, sxt, w, b, h0, c0, lens, hidden,
                                  cell, B, T, D, reverse, cs, rows, ku, ks,
                                  prefetch, smem, s)
                : launch<true, 4>(x, sxb, sxt, w, b, h0, c0, lens, hidden,
                                  cell, B, T, D, reverse, cs, rows, ku, ks,
                                  prefetch, smem, s);
  else
    e = rg == 8 ? launch<false, 8>(x, sxb, sxt, w, b, h0, c0, lens, hidden,
                                   cell, B, T, D, reverse, cs, rows, ku, ks,
                                   prefetch, smem, s)
                : launch<false, 4>(x, sxb, sxt, w, b, h0, c0, lens, hidden,
                                   cell, B, T, D, reverse, cs, rows, ku, ks,
                                   prefetch, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cs` blocks of this kernel (resident or streamed,
// row tile rg, `smem` bytes of shared memory) the card runs at once, into
// *count (cudaOccupancyMaxActiveClusters). Returns the cudaError_t.
extern "C" int ptt_fused_lstm_max_clusters(int cs, int rg, int resident,
                                           int smem, int* count) {
  if (cs < 1 || cs > kMaxCluster || (rg != 4 && rg != 8) || smem < 0 ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (resident)
    e = rg == 8 ? max_clusters<true, 8>(cs, smem, count)
                : max_clusters<true, 4>(cs, smem, count);
  else
    e = rg == 8 ? max_clusters<false, 8>(cs, smem, count)
                : max_clusters<false, 4>(cs, smem, count);
  return static_cast<int>(e);
}
