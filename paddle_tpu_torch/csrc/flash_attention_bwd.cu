// Flash attention backward in fp32 for Hopper (sm_90a): two kernels. The
// bf16 kernels (bf16 wgmma) are flash_attention_bwd_dkdv_bf16.cu and
// flash_attention_bwd_dq_bf16.cu.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_kernels.py
// `_flash_bwd_dkdv_kernel` (:157) and `_flash_bwd_dq_kernel` (:201), both
// launched by `_flash_bwd` (:240): the standard flash recompute from the
// forward's saved log-sum-exp, p = exp(q.k * scale - lse), so the [T, T]
// matrix never reaches device memory. With g the output gradient and
// delta = rowsum(g * out) (computed by the caller, as the TPU path does
// outside its kernels):
//   dV = P^T G,  dS = P * (G V^T - delta) * scale,  dK = dS^T Q,  dQ = dS K.
//
// What bounds it. A valid (query, key) pair costs 8*D flops in dK/dV (S,
// dP, dV, dK) and 6*D in dQ (S, dP, dQ), against q, k, v, g read and dq,
// dk, dv written once: at T = 256, D = 64 about 100 flops per byte, so the
// bound is operations. The products run on the tensor cores in 3xTF32
// (below), three TF32 products for each fp32 one: the bound is the TF32
// peak over three (495 / 3 = 165 TFLOP/s on an H100 SXM), 2.5x the fp32
// CUDA-core peak (67 TFLOP/s).
//
// Why 3xTF32 and not plain TF32. The port computes in fp32 with TF32 off,
// and the card's check holds these kernels to 1e-4 of max(1, max |dX|).
// Emulated on the CPU for one head at T = 256, D = 64 against float64, the
// worst relative error over dQ, dK and dV is 8.9e-7 / 1.3e-6 in fp32
// (non-causal / causal), 5.8e-4 / 2.3e-3 in plain TF32 (a 10-bit mantissa
// on every operand), and 7.2e-7 / 7.0e-7 in 3xTF32. Each fp32 operand x is
// split into hi = tf32_rna(x) and lo = tf32_rna(x - hi); a product is
// lo*hi + hi*lo + hi*hi (the small terms first) in fp32 accumulators, which
// keeps about 21 bits of each operand.
//
// The design.
//   * Two kernels and no atomics, as the TPU split: the dK/dV kernel owns
//     one (batch*head, 64-key tile) and streams the query tiles; the dQ
//     kernel owns one (batch*head, 64-query tile) and streams the key
//     tiles. Each recomputes S and dP (14*D flops a pair in all instead of
//     10*D), and every sum stays in one block, in a fixed order.
//   * 128 threads, four warps of 16 owned rows, 32 streamed rows a tile.
//     The products are mma.sync.m16n8k8 TF32 with fragments loaded by hand
//     from shared memory: S^T = K Q^T and dP^T = V G^T (dK/dV kernel), S = Q K^T and
//     dP = G V^T (dQ kernel) reduce over D; the accumulators P^T and dS^T
//     (or P and dS) then feed dV += P^T G, dK += dS^T Q (dQ += dS K) as A
//     fragments with no data movement: an m16n8 accumulator holds columns
//     2t and 2t+1 of a row where an m16n8k8 A fragment holds k = t and
//     t + 4, so the reduction index is permuted (k = t <-> column 2t, k =
//     t + 4 <-> column 2t + 1) and the B fragments read the matching rows.
//   * Every tile in shared memory is [rows, D + 4] fp32: with a row pitch
//     of an odd number of 16-byte chunks, the fragment reads along D (row
//     lane / 4, column lane % 4: bank 4 (lane / 4) + lane % 4 mod 32) and
//     the permuted reads along the streamed rows (rows 2 (lane % 4) and
//     2 (lane % 4) + 1, column lane / 4: bank 8 (lane % 4) + lane / 4 (+ 4)
//     mod 32) are both free of bank conflicts, and every fragment address
//     is a per-thread base plus a constant.
//   * The owned tiles stay resident; the streamed tiles (q, g and the lse
//     and delta rows in dK/dV, k and v in dQ) pass through a two-stage
//     ring filled by cp.async (16 bytes a copy, zero-filled past the ragged
//     edge), so tile t + 1 loads while tile t computes.
//   * The grid runs the heads inside each tile index, longest causal blocks
//     first, so that the short ones fill the last wave.
//   * Tiles skip as before: the dK/dV kernel starts at the causal frontier
//     and does nothing for a key tile at or past the row's key length; the
//     dQ kernel stops at the key length and the causal frontier. Only the
//     diagonal, length-edge and T-edge tiles mask element by element. A
//     pair is masked BEFORE the exponential (a select, never inf * 0): on a
//     row with key length 0 the saved lse is about -1e30, and there every
//     gradient is 0, as in the TPU kernels.
// It reads q, k, v and g with their strides from the [B, T, H, D] layout
// (no transpose) and allocates nothing.
//
// The element type. Both kernels are templates on the element type E of
// q, k, v, g, dq, dk and dv (lse and delta stay f32), and the tiles are
// [rows, D + 16 / sizeof(E)] in shared memory; a 2-byte E would be exact
// in TF32 (its lo term 0, dropped from each product). Only E = float is
// instantiated: the bf16 kernels of the mixed-precision path are the
// wgmma sources named above, which replaced the bf16 instantiations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // 128
constexpr int kRows = kWarps * 16;     // owned rows per block: 64
constexpr int kSmemLimit = 232448;     // bytes of shared memory a block may use

// a bf16 operand is exact in TF32: its lo term is 0
template <typename E>
constexpr bool kExact = sizeof(E) == 2;

template <int D, typename E>
struct Cfg {
  // streamed rows per tile: 32 keeps K2 at D = 64 under 168 registers (3
  // blocks an SM; 64 rows took 213 and ran slower, flash_bwd_variants.py;
  // at D = 128 the dK, dV sums alone take 128 registers)
  static constexpr int BC = 32;
  static constexpr int LD = D + 16 / sizeof(E);    // elements per smem row
  static constexpr int KS = D / 8;                 // k-steps over D
  static constexpr int NT = BC / 8;                // n-tiles over a tile
  static constexpr int ND = D / 8;                 // n-tiles over D
  static constexpr int kTile = BC * LD;            // elements of one tile
  static constexpr int kOwned = kRows * LD;        // elements of an owned tile
  static constexpr int kE = sizeof(E);
  // dK/dV: K, V owned; per stage q, g tiles and the lse, delta rows (f32)
  static constexpr int kStageBytes = 2 * kTile * kE + 2 * BC * 4;
  static constexpr int kDkdvSmem = 2 * kOwned * kE + 2 * kStageBytes;
  // dQ: Q, G owned; per stage k, v tiles
  static constexpr int kDqSmem = kE * (2 * kOwned + 2 * 2 * kTile);
  static_assert(kDkdvSmem <= kSmemLimit && kDqSmem <= kSmemLimit,
                "shared memory plan exceeds the block limit");
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
};

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh;
};

// element (r, c) of a tile with row pitch LD
template <int LD>
__device__ __forceinline__ int at(int r, int c) {
  return r * LD + c;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing read, the 16 bytes zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of one head of a strided [B, T, H, D] tensor into a
// tile; rows at or past `limit` are zero-filled
template <int D, int ROWS, typename E>
__device__ __forceinline__ void load_tile(E* tile, const E* base,
                                          long long row_stride, int r0,
                                          int limit, int tid) {
  constexpr int LD = Cfg<D, E>::LD;
  constexpr int kPer = 16 / sizeof(E);  // elements a 16-byte copy moves
  constexpr int kChunks = D / kPer;
  for (int idx = tid; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kPer;
    const bool ok = r0 + r < limit;
    const E* src = ok ? base + (long long)(r0 + r) * row_stride + c : base;
    cp_async16(tile + at<LD>(r, c), src, ok);
  }
}

// [r0, r0 + n) of one [T] row of lse or delta; zero past T
__device__ __forceinline__ void load_vec(float* dst, const float* row, int r0,
                                         int n, int T, int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = r0 + i < T;
    cp_async4(dst + i, ok ? row + r0 + i : row, ok);
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 computes for every finite x, in two integer
// operations at the full ALU rate (the conversion instruction issues at a
// fraction of it; flash_bwd_variants.py times both)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float widen(float x) { return x; }

// two consecutive outputs
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x as a split operand: a widened bf16 value is its own hi, lo = 0
template <typename E>
__device__ __forceinline__ void split_in(E x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact<E>) {
    hi = __float_as_uint(widen(x));
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// d += a * b in 3xTF32: the small terms first, hi * hi last; the term of
// an exact operand's lo (0) is left out
template <bool EXACT_A = false, bool EXACT_B = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  if constexpr (!EXACT_A) mma(d, alo, bhi[0], bhi[1]);
  if constexpr (!EXACT_B) mma(d, ahi, blo[0], blo[1]);
  mma(d, ahi, bhi[0], bhi[1]);
}

// The A fragment (16 rows x 8 of D) of a tile at rows r0..r0+15,
// k-step ks: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
template <int LD, typename E>
__device__ __forceinline__ void frag_a(const E* tile, int r0, int ks,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int c = ks * 8 + t;
  split_in(tile[at<LD>(r0 + g, c)], hi[0], lo[0]);
  split_in(tile[at<LD>(r0 + g + 8, c)], hi[1], lo[1]);
  split_in(tile[at<LD>(r0 + g, c + 4)], hi[2], lo[2]);
  split_in(tile[at<LD>(r0 + g + 8, c + 4)], hi[3], lo[3]);
}

// The B fragment reducing over D (n = tile rows n0..n0+7, k-step ks):
// b0 (k t, n g), b1 (k t + 4, n g)
template <int LD, typename E>
__device__ __forceinline__ void frag_b_d(const E* tile, int n0, int ks,
                                         int g, int t, uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
  const int c = ks * 8 + t;
  split_in(tile[at<LD>(n0 + g, c)], hi[0], lo[0]);
  split_in(tile[at<LD>(n0 + g, c + 4)], hi[1], lo[1]);
}

// The B fragment reducing over the tile's rows with the permuted k
// (k t <-> row k0 + 2t, k t + 4 <-> row k0 + 2t + 1), n = D columns
// n0..n0+7
template <int LD, typename E>
__device__ __forceinline__ void frag_b_rows(const E* tile, int k0, int n0,
                                            int g, int t, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split_in(tile[at<LD>(k0 + 2 * t, n0 + g)], hi[0], lo[0]);
  split_in(tile[at<LD>(k0 + 2 * t + 1, n0 + g)], hi[1], lo[1]);
}

// An accumulator n-tile as the A fragment of the permuted k-step
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);  // (g, 2t)      -> (g, k t)
  split(c[2], hi[1], lo[1]);  // (g + 8, 2t)  -> (g + 8, k t)
  split(c[1], hi[2], lo[2]);  // (g, 2t + 1)  -> (g, k t + 4)
  split(c[3], hi[3], lo[3]);  // (g + 8, 2t + 1)
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_len, E* __restrict__ dk,
                      E* __restrict__ dv, int T, int H, Strides st,
                      float scale, int causal) {
  using C = Cfg<D, E>;
  constexpr int BC = C::BC, LD = C::LD, NT = C::NT, ND = C::ND;
  constexpr bool kEx = kExact<E>;
  extern __shared__ __align__(16) float smem[];
  E* ks_t = reinterpret_cast<E*>(smem);  // K [kRows, LD]
  E* vs_t = ks_t + C::kOwned;            // V [kRows, LD]
  // per stage: q, g tiles (E), then the lse and delta rows (f32)
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs_t + C::kOwned);
  constexpr int kStage = C::kStageBytes;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int wr = warp * 16;  // this warp's rows of the key tile
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));
  const E* qb = q + b * st.qsb + h * st.qsh;
  const E* kb = k + b * st.ksb + h * st.ksh;
  const E* vb = v + b * st.vsb + h * st.vsh;
  const E* gb = g + b * st.gsb + h * st.gsh;
  const float* lse_row = lse + (long long)bh * T;
  const float* delta_row = delta + (long long)bh * T;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  // query tiles that do any work: from the causal frontier (queries before
  // this key tile see none of its keys) to T; none when the whole key tile
  // lies at or past the row's key length
  const int n_tiles = (T + BC - 1) / BC;
  const int first = k0 >= len ? n_tiles : (causal ? k0 / BC : 0);

  if (first < n_tiles) {
    load_tile<D, kRows>(ks_t, kb, st.kst, k0, len, tid);
    load_tile<D, kRows>(vs_t, vb, st.vst, k0, len, tid);
    auto load_stage = [&](int tile, int s) {
      E* base = reinterpret_cast<E*>(ring + s * kStage);
      float* rows = reinterpret_cast<float*>(base + 2 * C::kTile);
      const int q0 = tile * BC;
      load_tile<D, BC>(base, qb, st.qst, q0, T, tid);
      load_tile<D, BC>(base + C::kTile, gb, st.gst, q0, T, tid);
      load_vec(rows, lse_row, q0, BC, T, tid);
      load_vec(rows + BC, delta_row, q0, BC, T, tid);
    };
    load_stage(first, 0);
    cp_commit();

    for (int tile = first; tile < n_tiles; ++tile) {
      const int s = (tile - first) & 1;
      if (tile + 1 < n_tiles) {
        load_stage(tile + 1, s ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const E* qs = reinterpret_cast<const E*>(ring + s * kStage);
      const E* gs = qs + C::kTile;
      const float* ls = reinterpret_cast<const float*>(gs + C::kTile);
      const float* ds_row = ls + BC;
      const int q0 = tile * BC;

      // S^T = K Q^T and dP^T = V G^T for this warp's 16 keys x BC queries
      float sa[NT][4], pa[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[n][i] = pa[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        uint32_t khi[4], klo[4], vhi[4], vlo[4];
        frag_a<LD>(ks_t, wr, kk, gi, ti, khi, klo);
        frag_a<LD>(vs_t, wr, kk, gi, ti, vhi, vlo);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_d<LD>(qs, n * 8, kk, gi, ti, bhi, blo);
          mma3<kEx, kEx>(sa[n], khi, klo, bhi, blo);
          frag_b_d<LD>(gs, n * 8, kk, gi, ti, bhi, blo);
          mma3<kEx, kEx>(pa[n], vhi, vlo, bhi, blo);
        }
      }

      // P^T and dS^T in place; mask only the edge and diagonal tiles
      const bool edge = k0 + kRows > len || q0 + BC > T ||
                        (causal && q0 < k0 + kRows - 1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n * 8 + 2 * ti + (i & 1);
          const int key = k0 + wr + gi + ((i & 2) ? 8 : 0);
          const int qp = q0 + col;
          const bool valid =
              !edge || (key < len && qp < T && (!causal || qp >= key));
          const float p = valid ? expf(sa[n][i] * scale - ls[col]) : 0.f;
          sa[n][i] = p;
          pa[n][i] = p * (pa[n][i] - ds_row[col]) * scale;
        }
      }

      // dV += P^T G and dK += dS^T Q over this tile's queries
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t phi[4], plo[4], shi[4], slo[4];
        acc_as_a(sa[j], phi, plo);
        acc_as_a(pa[j], shi, slo);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(gs, j * 8, n * 8, gi, ti, bhi, blo);
          mma3<false, kEx>(dva[n], phi, plo, bhi, blo);
          frag_b_rows<LD>(qs, j * 8, n * 8, gi, ti, bhi, blo);
          mma3<false, kEx>(dka[n], shi, slo, bhi, blo);
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

  // rows g and g + 8 of the warp, columns 2t and 2t + 1 of each n-tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = k0 + wr + gi + half * 8;
    if (kpos >= T) continue;
    const long long off = (((long long)b * T + kpos) * H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * ti;
      store2(dk + off + c, dka[n][2 * half], dka[n][2 * half + 1]);
      store2(dv + off + c, dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// at least 2 blocks an SM: without that floor ptxas held the D = 64
// variant to 128 registers (4 blocks) and spilled
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len, E* __restrict__ dq,
                    int T, int H, Strides st, float scale, int causal) {
  using C = Cfg<D, E>;
  constexpr int BC = C::BC, LD = C::LD, NT = C::NT, ND = C::ND;
  constexpr bool kEx = kExact<E>;
  extern __shared__ __align__(16) float smem[];
  E* qs_t = reinterpret_cast<E*>(smem);  // Q [kRows, LD]
  E* gs_t = qs_t + C::kOwned;            // G [kRows, LD]
  E* ring = gs_t + C::kOwned;            // per stage: k, v tiles
  constexpr int kStage = 2 * C::kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the last query tiles first: under the causal mask they see the most
  // key tiles (see the grid's order below)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int wr = warp * 16;  // this warp's rows of the query tile
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));
  const E* kb = k + b * st.ksb + h * st.ksh;
  const E* vb = v + b * st.vsb + h * st.vsh;

  // the lse and delta of this thread's two rows
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + wr + gi + half * 8;
    lse_r[half] = qp < T ? lse[(long long)bh * T + qp] : 0.f;
    delta_r[half] = qp < T ? delta[(long long)bh * T + qp] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[n][i] = 0.f;

  // key tiles that do any work: up to the row length, and for causal
  // attention up to this query tile's frontier
  int n_tiles = (len + BC - 1) / BC;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + BC - 1) / BC);

  if (n_tiles > 0) {
    load_tile<D, kRows>(qs_t, q + b * st.qsb + h * st.qsh, st.qst, q0, T, tid);
    load_tile<D, kRows>(gs_t, g + b * st.gsb + h * st.gsh, st.gst, q0, T, tid);
    auto load_stage = [&](int tile, int s) {
      E* base = ring + s * kStage;
      load_tile<D, BC>(base, kb, st.kst, tile * BC, len, tid);
      load_tile<D, BC>(base + C::kTile, vb, st.vst, tile * BC, len, tid);
    };
    load_stage(0, 0);
    cp_commit();

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s = tile & 1;
      if (tile + 1 < n_tiles) {
        load_stage(tile + 1, s ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const E* kt = ring + s * kStage;
      const E* vt = kt + C::kTile;
      const int kk0 = tile * BC;

      // S = Q K^T and dP = G V^T for this warp's 16 queries x BC keys
      float sa[NT][4], pa[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[n][i] = pa[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        uint32_t qhi[4], qlo[4], ghi[4], glo[4];
        frag_a<LD>(qs_t, wr, kk, gi, ti, qhi, qlo);
        frag_a<LD>(gs_t, wr, kk, gi, ti, ghi, glo);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_d<LD>(kt, n * 8, kk, gi, ti, bhi, blo);
          mma3<kEx, kEx>(sa[n], qhi, qlo, bhi, blo);
          frag_b_d<LD>(vt, n * 8, kk, gi, ti, bhi, blo);
          mma3<kEx, kEx>(pa[n], ghi, glo, bhi, blo);
        }
      }

      // P, then dS in place of dP; mask only the edge and diagonal tiles
      const bool edge = kk0 + BC > len || q0 + kRows > T ||
                        (causal && kk0 + BC - 1 > q0);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int half = (i & 2) ? 1 : 0;
          const int qp = q0 + wr + gi + half * 8;
          const int kp = kk0 + n * 8 + 2 * ti + (i & 1);
          const bool valid =
              !edge || (qp < T && kp < len && (!causal || kp <= qp));
          const float p =
              valid ? expf(sa[n][i] * scale - lse_r[half]) : 0.f;
          pa[n][i] = p * (pa[n][i] - delta_r[half]) * scale;
        }
      }

      // dQ += dS K over this tile's keys
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t shi[4], slo[4];
        acc_as_a(pa[j], shi, slo);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(kt, j * 8, n * 8, gi, ti, bhi, blo);
          mma3<false, kEx>(dqa[n], shi, slo, bhi, blo);
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + wr + gi + half * 8;
    if (qp >= T) continue;
    const long long off = (((long long)b * T + qp) * H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dq + off + n * 8 + 2 * ti, dqa[n][2 * half],
             dqa[n][2 * half + 1]);
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// once per process (the attribute is the function's, not the launch's)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int D, typename E>
cudaError_t launch_dkdv(const E* q, const E* k, const E* v, const E* g,
                        const float* lse, const float* delta,
                        const int* kv_len, E* dk, E* dv, int B, int T, int H,
                        const Strides& st, float scale, int causal,
                        cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = Cfg<D, E>::kDkdvSmem;
  const cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<D, E>, bytes, ready);
  if (err != cudaSuccess) return err;
  // blocks start in index order, x fastest: the heads inside a tile index,
  // so the causal mask's longest blocks (the first key tiles) start first
  // and the shortest fill the last wave
  dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_bwd_dkdv_kernel<D, E><<<grid, kThreads, bytes, stream>>>(
      q, k, v, g, lse, delta, kv_len, dk, dv, T, H, st, scale, causal);
  return cudaGetLastError();
}

template <int D, typename E>
cudaError_t launch_dq(const E* q, const E* k, const E* v, const E* g,
                      const float* lse, const float* delta, const int* kv_len,
                      E* dq, int B, int T, int H, const Strides& st,
                      float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = Cfg<D, E>::kDqSmem;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, E>, bytes, ready);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_bwd_dq_kernel<D, E><<<grid, kThreads, bytes, stream>>>(
      q, k, v, g, lse, delta, kv_len, dq, T, H, st, scale, causal);
  return cudaGetLastError();
}

Strides make_strides(long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh,
                     long long gsb, long long gst, long long gsh) {
  Strides st = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh};
  return st;
}

template <typename E>
int dkdv_entry(const E* q, const E* k, const E* v, const E* g,
               const float* lse, const float* delta, const int* kv_len,
               E* dk, E* dv, int B, int T, int H, int D, const Strides& st,
               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_dkdv<16>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H,
                            st, scale, causal, s);
      break;
    case 32:
      err = launch_dkdv<32>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H,
                            st, scale, causal, s);
      break;
    case 64:
      err = launch_dkdv<64>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H,
                            st, scale, causal, s);
      break;
    case 128:
      err = launch_dkdv<128>(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H,
                             st, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename E>
int dq_entry(const E* q, const E* k, const E* v, const E* g,
             const float* lse, const float* delta, const int* kv_len, E* dq,
             int B, int T, int H, int D, const Strides& st, float scale,
             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_dq<16>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st,
                          scale, causal, s);
      break;
    case 32:
      err = launch_dq<32>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st,
                          scale, causal, s);
      break;
    case 64:
      err = launch_dq<64>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st,
                          scale, causal, s);
      break;
    case 128:
      err = launch_dq<128>(q, k, v, g, lse, delta, kv_len, dq, B, T, H, st,
                           scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
  const Strides st = make_strides(qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                  gsb, gst, gsh);
  return dkdv_entry(q, k, v, g, lse, delta, kv_len, dk, dv, B, T, H, D, st,
                    scale, causal, stream);
}

// The same inputs; dq: fp32 [B, T, H, D] contiguous.
extern "C" int ptt_flash_attention_bwd_dq(
    const float* q, const float* k, const float* v, const float* g,
    const float* lse, const float* delta, const int* kv_len, float* dq,
    int B, int T, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long gsb, long long gst, long long gsh, float scale,
    int causal, void* stream) {
  const Strides st = make_strides(qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                  gsb, gst, gsh);
  return dq_entry(q, k, v, g, lse, delta, kv_len, dq, B, T, H, D, st, scale,
                  causal, stream);
}
