// Flash attention forward, fp32, for Hopper (sm_90a). The bf16 kernel
// (mixed precision, bf16 wgmma) is flash_attention_fwd_bf16.cu.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_flash_fwd_kernel` (:64, launched by `_flash_fwd` :116): exact softmax
// attention with an online (running max / denominator / accumulator)
// softmax, so the [T, T] score matrix never reaches device memory; key
// tiles past the causal frontier and past the row's key length are
// skipped; the row log-sum-exp is emitted for the backward pass.
//
// What bounds it. A valid (query, key) pair costs 4*D flops (S = Q K^T and
// O += P V) against q, out, the k and v rows below each length and lse,
// each moved once: at T = 256, D = 64 about 64 flops per byte, so the bound
// is operations. Both products run on the tensor cores in 3xTF32 (below),
// three TF32 products for each fp32 one: the bound is the TF32 peak over
// three (495 / 3 = 165 TFLOP/s on an H100 SXM), 2.5x the fp32 CUDA-core
// peak (67 TFLOP/s).
//
// Why 3xTF32 and not plain TF32. The port computes in fp32 with TF32 off,
// and the card's check holds this kernel to 1e-4 absolute on out and lse.
// Emulated on the CPU (tests/test_torch_flash_fwd.py: two heads at T =
// 256, D = 64, randn inputs, against the JAX kernel), the worst error over
// out and lse is 4.4e-4 (8.0e-4 causal) in plain TF32, a 10-bit mantissa
// on every operand, and 4.8e-7 (7.2e-7) in 3xTF32, as close as the plain
// fp32 version's 4.8e-7. Each fp32 operand x is split into hi =
// tf32_rna(x) and lo = tf32_rna(x - hi); a product is lo*hi + hi*lo +
// hi*hi (the small terms first) in fp32 accumulators, which keeps about
// 21 bits of each operand.
//
// The design (the dQ kernel of flash_attention_bwd.cu, less its second
// product, is the template; the helpers below are copies of its own, so
// that each source builds alone, as chip_smoke.py builds earlier kernels).
//   * One block owns one (batch*head, 64-query tile): 128 threads, four
//     warps of 16 query rows. Q, scaled, is split once into TF32 hi and lo
//     tiles in shared memory as it is loaded, so the 64 rows' A fragments
//     cost no rounding afterwards.
//   * K and V stream in tiles of 32 keys through a two-stage ring filled
//     by cp.async (16 bytes a copy, zero-filled past the ragged edge and
//     past the row's key length), so tile t + 1 loads while tile t
//     computes.
//   * S = Q K^T is mma.sync.m16n8k8 TF32 with fragments loaded by hand
//     from shared memory. The S accumulator then feeds O += P V as the A
//     fragment with no data movement: an m16n8 accumulator holds columns
//     2t and 2t+1 of a row where an m16n8k8 A fragment holds k = t and
//     t + 4, so the reduction index is permuted (k = t <-> key 2t, k =
//     t + 4 <-> key 2t + 1) and V's B fragments read the matching rows.
//   * Every tile in shared memory is [rows, D + 4]: with a row pitch of an
//     odd number of 16-byte chunks, the reads along D (row lane / 4,
//     column lane % 4) and the permuted reads along the keys (rows
//     2 (lane % 4) and 2 (lane % 4) + 1, column lane / 4) are both free
//     of bank conflicts.
//   * The online softmax runs in the accumulator's registers: each thread
//     holds two rows (lane / 4 and lane / 4 + 8) of its warp's 16, the row
//     max reduces over the four lanes of a quad by two shuffles, the
//     rescale exp(m - m_new) applies to O's fragments and to the thread's
//     share of the denominator, which is summed over the quad once, at
//     the end. A pair is masked BEFORE the exponential (a select, never
//     inf * 0), and only on the diagonal and length-edge tiles.
//   * The grid runs the heads inside each query tile index, the last query
//     tiles first: under the causal mask they see the most key tiles, so
//     the short blocks fill the last wave.
//   * There are no atomics, and every row's sums stay in one block in a
//     fixed order: two runs give the same bits.
// It reads q, k and v with their strides from the [B, T, H, D] layout (no
// transpose), masks the ragged T edge itself, and allocates nothing. A row
// whose key length is 0 gives out = 0 and lse = -1e30 + log(1e-30), the
// TPU kernel's `l_safe` values.
//
// bf16 (mixed precision). The kernel is a template on the element type E
// of q, k, v and out, as the TPU kernel takes bf16 tiles, widens them to
// f32 and writes out in the input's dtype (lse stays f32). K and V tiles
// reach shared memory as bf16 through the same cp.async ring (a copy
// cannot convert), [rows, D + 8] bf16: the row pitch is again an odd number
// of 16-byte chunks, and the fragment reads are free of bank conflicts
// (two lanes that read the two halves of one word share it). They widen to
// f32 as the fragments load; Q widens as it is scaled and split. A bf16
// value is exact in TF32 (8 significant bits against 11), so its lo term
// is 0: a product with a bf16 operand drops that operand's lo product,
// exactly (Q K^T and P V take two TF32 products, not three). Every
// product and sum stays f32; P is not rounded to bf16 before P V (the TPU
// kernel multiplies it in f32). out narrows to bf16 (round to nearest
// even) only at its store. Only the fp32 instantiation has an entry
// point now: flash_attention_fwd_bf16.cu replaced the bf16 one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // 128
constexpr int kRows = kWarps * 16;     // query rows per block: 64
constexpr int kSmemLimit = 232448;     // bytes of shared memory a block may use
constexpr float kNeg = -1e30f;         // the masked score and empty-row max

// a bf16 operand is exact in TF32: its lo term is 0
template <typename E>
constexpr bool kExact = sizeof(E) == 2;

template <int D, typename E>
struct Cfg {
  static constexpr int BC = 32;                    // keys per streamed tile
  static constexpr int LD = D + 16 / sizeof(E);    // elements per K/V row
  static constexpr int LDQ = D + 4;                // words per Q row
  static constexpr int KS = D / 8;                 // k-steps over D
  static constexpr int NT = BC / 8;                // n-tiles over a tile
  static constexpr int ND = D / 8;                 // n-tiles over D
  static constexpr int kTile = BC * LD;            // elements of one tile
  static constexpr int kOwned = kRows * LDQ;       // words of a Q tile
  // Q's hi and lo tiles; per stage the k and v tiles
  static constexpr int kSmem =
      4 * 2 * kOwned + 2 * 2 * kTile * (int)sizeof(E);
  static_assert(kSmem <= kSmemLimit,
                "shared memory plan exceeds the block limit");
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
};

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements at p (8- or 16-byte aligned), widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // the element at the lower address is the low half of each word
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

// two consecutive outputs, narrowed to E (bf16: round to nearest even)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 computes for every finite x, in two integer
// operations at the full ALU rate
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

// The A fragment (16 rows x 8 of D) of the split Q tiles at rows
// r0..r0+15, k-step ks: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)
template <int LD>
__device__ __forceinline__ void frag_a_split(const uint32_t* hi_t,
                                             const uint32_t* lo_t, int r0,
                                             int ks, int g, int t,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int i0 = at<LD>(r0 + g, ks * 8 + t);
  const int i1 = i0 + 8 * LD;
  hi[0] = hi_t[i0];
  lo[0] = lo_t[i0];
  hi[1] = hi_t[i1];
  lo[1] = lo_t[i1];
  hi[2] = hi_t[i0 + 4];
  lo[2] = lo_t[i0 + 4];
  hi[3] = hi_t[i1 + 4];
  lo[3] = lo_t[i1 + 4];
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
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const int* __restrict__ kv_len,
                 E* __restrict__ out, float* __restrict__ lse, int T,
                 int H, Strides st, float scale, int causal) {
  using C = Cfg<D, E>;
  constexpr int BC = C::BC, LD = C::LD, LDQ = C::LDQ, NT = C::NT,
                ND = C::ND;
  constexpr bool kEx = kExact<E>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* qhi_t = reinterpret_cast<uint32_t*>(smem);  // Q hi [kRows, LDQ]
  uint32_t* qlo_t = qhi_t + C::kOwned;                   // Q lo [kRows, LDQ]
  E* ring = reinterpret_cast<E*>(smem + 2 * C::kOwned);  // per stage: k, v
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

  // this thread's rows gi and gi + 8: O's fragments (columns 2t and 2t + 1
  // of each n-tile), the running max and the thread's share of the
  // denominator
  float oa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oa[n][i] = 0.f;
  float m_r[2] = {kNeg, kNeg};
  float l_r[2] = {0.f, 0.f};

  // key tiles that do any work: up to the row length, and for causal
  // attention up to this query tile's frontier
  int n_tiles = (len + BC - 1) / BC;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + BC - 1) / BC);

  if (n_tiles > 0) {
    auto load_stage = [&](int tile, int s) {
      E* base = ring + s * kStage;
      load_tile<D, BC>(base, kb, st.kst, tile * BC, len, tid);
      load_tile<D, BC>(base + C::kTile, vb, st.vst, tile * BC, len, tid);
    };
    load_stage(0, 0);
    cp_commit();

    // Q * scale (in f32, so not exact in TF32 even from bf16), split once
    // into its hi and lo tiles while the first K/V stage loads; rows past
    // T are zero
    const E* qb = q + b * st.qsb + h * st.qsh;
    constexpr int kChunks = D / 4;
    for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx - r * kChunks) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < T) x = load4(qb + (long long)(q0 + r) * st.qst + c);
      uint4 hi, lo;
      split(x.x * scale, hi.x, lo.x);
      split(x.y * scale, hi.y, lo.y);
      split(x.z * scale, hi.z, lo.z);
      split(x.w * scale, hi.w, lo.w);
      *reinterpret_cast<uint4*>(qhi_t + at<LDQ>(r, c)) = hi;
      *reinterpret_cast<uint4*>(qlo_t + at<LDQ>(r, c)) = lo;
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s = tile & 1;
      if (tile + 1 < n_tiles) {
        load_stage(tile + 1, s ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // this stage (and, first, the Q tiles) is in place
      const E* kt = ring + s * kStage;
      const E* vt = kt + C::kTile;
      const int kk0 = tile * BC;

      // S = (Q * scale) K^T for this warp's 16 queries x BC keys
      float sa[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        uint32_t qhi[4], qlo[4];
        frag_a_split<LDQ>(qhi_t, qlo_t, wr, ks, gi, ti, qhi, qlo);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_d<LD>(kt, n * 8, ks, gi, ti, bhi, blo);
          mma3<false, kEx>(sa[n], qhi, qlo, bhi, blo);
        }
      }

      // the online softmax; mask only the length-edge and diagonal tiles
      const bool edge = kk0 + BC > len || (causal && kk0 + BC - 1 > q0);
      auto valid = [&](int n, int i) {
        const int qp = q0 + wr + gi + ((i & 2) ? 8 : 0);
        const int kp = kk0 + n * 8 + 2 * ti + (i & 1);
        return !edge || (kp < len && (!causal || kp <= qp));
      };
      float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!valid(n, i)) sa[n][i] = kNeg;
          m_new[i >> 1] = fmaxf(m_new[i >> 1], sa[n][i]);
        }
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the four lanes of a quad hold one row
        m_new[half] = fmaxf(m_new[half],
                            __shfl_xor_sync(0xffffffffu, m_new[half], 1));
        m_new[half] = fmaxf(m_new[half],
                            __shfl_xor_sync(0xffffffffu, m_new[half], 2));
        corr[half] = expf(m_r[half] - m_new[half]);
        m_r[half] = m_new[half];
        l_r[half] *= corr[half];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = valid(n, i) ? expf(sa[n][i] - m_r[i >> 1]) : 0.f;
          l_r[i >> 1] += p;
          sa[n][i] = p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) oa[n][i] *= corr[i >> 1];

      // O += P V over this tile's keys
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t phi[4], plo[4];
        acc_as_a(sa[j], phi, plo);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(vt, j * 8, n * 8, gi, ti, bhi, blo);
          mma3<false, kEx>(oa[n], phi, plo, bhi, blo);
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

  // rows gi and gi + 8 of the warp, columns 2t and 2t + 1 of each n-tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_r[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = q0 + wr + gi + half * 8;
    if (qp >= T) continue;
    const float l_safe = fmaxf(l, 1e-30f);
    const long long off = (((long long)b * T + qp) * H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(out + off + n * 8 + 2 * ti, oa[n][2 * half] / l_safe,
             oa[n][2 * half + 1] / l_safe);
    }
    if (ti == 0) lse[(long long)bh * T + qp] = m_r[half] + logf(l_safe);
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
cudaError_t launch(const E* q, const E* k, const E* v, const int* kv_len,
                   E* out, float* lse, int B, int T, int H, const Strides& st,
                   float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = Cfg<D, E>::kSmem;
  const cudaError_t err = allow_smem(flash_fwd_kernel<D, E>, bytes, ready);
  if (err != cudaSuccess) return err;
  // blocks start in index order, x fastest: the heads inside a query tile
  // index, so the causal mask's longest blocks (the last query tiles)
  // start first and the shortest fill the last wave
  dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_fwd_kernel<D, E><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kv_len, out, lse, T, H, st, scale, causal);
  return cudaGetLastError();
}

template <typename E>
int fwd_entry(const E* q, const E* k, const E* v, const int* kv_len, E* out,
              float* lse, int B, int T, int H, int D, const Strides& st,
              float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch<16>(q, k, v, kv_len, out, lse, B, T, H, st, scale, causal,
                       s);
      break;
    case 32:
      err = launch<32>(q, k, v, kv_len, out, lse, B, T, H, st, scale, causal,
                       s);
      break;
    case 64:
      err = launch<64>(q, k, v, kv_len, out, lse, B, T, H, st, scale, causal,
                       s);
      break;
    case 128:
      err = launch<128>(q, k, v, kv_len, out, lse, B, T, H, st, scale,
                        causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
  const Strides st = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  return fwd_entry(q, k, v, kv_len, out, lse, B, T, H, D, st, scale, causal,
                   stream);
}
