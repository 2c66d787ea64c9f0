// Flash attention backward, dQ, in bf16 for Hopper (sm_90a): q, k, v, g
// and dq bf16, lse and delta fp32, every product a bf16 wgmma on the
// tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_flash_bwd_dq_kernel` (:201, launched by `_flash_bwd` :240) on bf16
// tiles, the JAX package's mixed-precision path: the flash recompute from
// the forward's saved log-sum-exp, p = exp(q.k * scale - lse), so the
// [T, T] matrix never reaches device memory. With g the output gradient
// and delta = rowsum(g * out) (computed by the caller, as the TPU path does
// outside its kernels):
//   dS = P * (G V^T - delta) * scale,  dQ = dS K.
// The TPU kernel widens the bf16 tiles to f32 and multiplies and sums in
// f32, dS included; this kernel keeps that precision (below). dK and dV
// are flash_attention_bwd_dkdv_bf16.cu's; the fp32 kernels are
// flash_attention_bwd.cu.
//
// What bounds it. A valid (query, key) pair costs 6*D flops (S, dP, dQ)
// against q, g, dq, the k and v rows below each length (2 bytes an
// element), lse and delta (4), each moved once: at T = 256, D = 64 about
// 150 flops per byte, under the 295 at which the bf16 tensor cores (989
// TFLOP/s on an H100 SXM) and not the memory (3.35 TB/s) would bound it.
// So the bound is bytes: 0.0127 ms at the training shape [32, 256, 8, 64].
//
// Precision. S = Q K^T and dP = G V^T multiply bf16 values: one bf16 wgmma
// each, exact products and f32 sums; the scale goes onto the f32
// accumulator, folded with log2(e) into the exponent (exp2). dS is f32 and
// not a bf16 value: it splits into hi = bf16(x) and lo = bf16(x - hi), and
// dQ += dS K is two wgmma (lo, then hi): about 16 bits of dS, an error
// near 2^-17, as close to the TPU kernel's f32 as its f32 sums can tell
// (rounding dS once to bf16 would leave 2^-9:
// tests/test_torch_flash_bf16_split.py). 8 D bf16 flops for the 6 D
// useful ones: at the training shape about 0.0087 ms at the bf16 peak,
// under the 0.0127 ms its bytes take.
//
// The design (Hopper's warpgroup products; FlashAttention-3's register
// reuse), the bf16 K2's turned around.
//   * One block is one warpgroup (128 threads) and owns one (batch*head,
//     64-query tile), queries on wgmma's M: Q and G stay resident in
//     shared memory, loaded once by TMA, and the block's lse and delta
//     rows sit in registers, loaded once. K and V stream past in tiles of
//     64 keys through a TMA ring on mbarriers (three stages, two at D =
//     128), K's and V's copies completing on barriers of their own, from
//     key tile 0 to the row's key length or the causal frontier. S is
//     issued once K has landed and dP once V has, in commit groups of
//     their own, so the exponential runs while dP does (3% faster at the
//     training shape than waiting for both: flash_bf16_variants.py).
//   * S and dP take Q, G and K, V from shared memory, all K-major (D
//     contiguous, as they lie in device memory). Their accumulators'
//     layout (rows g and g + 8 of each warp's 16 queries, key columns 8j +
//     2t and 8j + 2t + 1) is the A-fragment layout of dQ += dS K, whose
//     reduction runs over those keys: dS is packed in place and never
//     touches shared memory. K is that product's B operand MN-major (D
//     contiguous along N), read from the very tile S read K-major.
//   * Shared memory holds each tile as wgmma's descriptors read it: rows
//     of W = min(2 D, 128) bytes, D cut into column blocks of W / 2
//     elements, each row's 16-byte chunks permuted by the swizzle's XOR.
//     TMA copies the [B, T, H, D] views with that swizzle, through tensor
//     maps the host encodes at each launch (cuTensorMapEncodeTiled through
//     the runtime's driver entry point; by value in the kernel's
//     parameters, so a CUDA graph captures them); rows past T read as
//     zeros. Keys at or past the row's length load as they are and are
//     masked.
//   * wgmma.fence, commit_group and wait_group bracket every product, and
//     no accumulator or A fragment is touched between an issue and its
//     wait (ptxas would serialise the products otherwise; chip_smoke.py
//     --ptxas fails on that).
//   * Only the diagonal, length-edge and T-edge tiles mask element by
//     element, a pair masked BEFORE the exponential (a select, never inf *
//     0). A row with key length 0 runs no tile and gets dQ = 0, as in the
//     TPU kernel.
//   * dQ leaves as bf16 (rounded to nearest even once), staged in Q's
//     tile for one bulk tensor store that writes no row past T. There are
//     no atomics: every sum stays in one block, in a fixed order.
//   * The grid runs the heads inside each query tile index, the last
//     query tiles first: under the causal mask they see the most key
//     tiles, so the long blocks lead and the short ones fill the last
//     wave.
// It reads q, k, v and g with their strides from the [B, T, H, D] layout
// (the last dim contiguous, every stride a multiple of 16 bytes, as TMA
// needs) and allocates nothing.
// Its helpers are copies of flash_attention_bwd_dkdv_bf16.cu's: each
// source builds alone.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroups = 1;          // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64 * kGroups;  // query rows a block, 64 a group
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout of a tile of R rows x D bf16, as wgmma's
// descriptors read it: rows of W bytes (W = min(2 D, 128), the widest
// swizzle a row fills), D cut into column blocks of W / 2 elements stored
// one after another (R * W bytes each), and in each block the 16-byte
// chunks of a row permuted by XOR with bits 7.. of their offset (the
// hardware's 128-, 64- or 32-byte swizzle). Tiles start on 1024 bytes, so
// offsets and shared addresses agree in those bits.
template <int D>
struct Sw {
  static_assert(D % 16 == 0 && D <= 128, "head dim: 16, 32, 64 or 128");
  static constexpr int W = D >= 64 ? 128 : 2 * D;
  static constexpr int EPR = W / 2;  // elements a row of a column block
  // the descriptor's layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t kMode = W == 128 ? 1 : (W == 64 ? 2 : 3);
};

// byte offset of element (r, d) (d a multiple of 8) in a tile of R rows
template <int D, int R>
__device__ __forceinline__ uint32_t sw_off(int r, int d) {
  constexpr int W = Sw<D>::W, EPR = Sw<D>::EPR;
  const int cb = d / EPR;
  uint32_t byte = r * W + (d - cb * EPR) * 2;
  byte ^= ((byte >> 7) & (W / 16 - 1)) << 4;
  return cb * R * W + byte;
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

// a K-major operand (rows along M or N, D along the reduction) at its
// k-step ks: 16 elements of D, +32 bytes inside a swizzled row; 8-row
// groups SBO = 8 W apart (LBO unused)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  constexpr int W = Sw<D>::W, EPR = Sw<D>::EPR;
  const int d0 = ks * 16;
  const int cb = d0 / EPR;
  return make_desc(tile + cb * R * W + (d0 - cb * EPR) * 2, 16, 8 * W,
                   Sw<D>::kMode);
}

// an MN-major B operand (the tile's rows along the reduction, D along N):
// rows r0..r0+15, column block cb; 8-row groups SBO = 8 W apart, column
// blocks LBO = R W apart
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int r0, int cb) {
  constexpr int W = Sw<D>::W;
  return make_desc(tile + cb * R * W + r0 * W, R * W, 8 * W, Sw<D>::kMode);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// until every commit group but the last is done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers an
// in-flight wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// (x0, x1) as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi), the
// element at the lower address in the low half of each word
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An accumulator of m64nNk16 (rows g and g + 8 of the warp's 16, columns
// 8j + 2t and 8j + 2t + 1: element 4j + i) as the A fragments of the next
// product, whose reduction runs over those columns: for k-step c, words
// (g, 16c + 2t), (g + 8, 16c + 2t), (g, 16c + 8 + 2t), (g + 8, 16c + 8 +
// 2t), which are elements 8c + 2r and 8c + 2r + 1 for word r
template <int N>
__device__ __forceinline__ void to_a(const float (&acc)[N / 2],
                                     uint32_t (&hi)[N / 16][4],
                                     uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(acc[8 * c + 2 * r], acc[8 * c + 2 * r + 1], hi[c][r], lo[c][r]);
}

// 2^x by the hardware's approximation (about 2 ulp; no range handling:
// x at or below -126 gives 0, which a masked or vanishing p is anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This warp's 16 rows (wr..wr+15) of a block's [kRows, D] output tile,
// from its accumulators (element 4j + i of acc[n]: row wr + gi + 8 (i >>
// 1), column n NW + 8j + 2 ti + (i & 1)) times mul[i >> 1], as bf16
// (round to nearest even) into the swizzled tile at `tile`, from which
// one bulk tensor copy stores the block's rows
template <int D, int NW, int NH>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&acc)[NH][NW / 2],
                                           const float (&mul)[2], int wr,
                                           int lane) {
  const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = n * NW + 8 * j;
        *reinterpret_cast<__nv_bfloat162*>(
            tile + sw_off<D, kRows>(wr + gi + 8 * hf, c) + 4 * ti) =
            __floats2bfloat162_rn(acc[n][4 * j + 2 * hf] * mul[hf],
                                  acc[n][4 * j + 2 * hf + 1] * mul[hf]);
      }
}

// wgmma.mma_async m64nNk16, bf16 operands, f32 accumulators (d: N / 2 a
// thread); the scale-d predicate from `acc` (0: d = A B)
template <int N>
struct Mma;


// ---- TMA: tensor maps encoded on the host; bulk tensor copies that
// complete on an mbarrier ----

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (nothing links against the driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled& fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  fn = cached;
  return cudaSuccess;
}

// The tensor map of one strided [B, T, H, D] bf16 tensor (element strides
// sb, st, sh, each a multiple of 8; the last dim contiguous), read in
// boxes of `rows` rows of one head and W / 2 columns, swizzled as Sw<D>
// lays a tile out; rows past T read as zeros
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int B, int T,
                       int H, long long sb, long long st, long long sh,
                       int rows) {
  EncodeTiled fn;
  const cudaError_t err = encoder(fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Sw<D>::EPR, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Sw<D>::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Sw<D>::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// the barriers' initialisation, visible to the copies that complete on them
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival a phase waits for, and the bytes it then expects
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the barrier's phase of this parity has completed; a phase that
// never completes (a copy that never lands) traps after 2^32 cycles (2 s
// or more) instead of holding the card
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// rows [r0, r0 + R) of head h of batch b from the tensor map into a
// swizzled tile, one copy a column block, completing on `bar`
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t tile,
                                         const CUtensorMap* map, int b,
                                         int h, int r0, uint32_t bar) {
  constexpr int W = Sw<D>::W, EPR = Sw<D>::EPR;
#pragma unroll
  for (int cb = 0; cb < D / EPR; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            tile + cb * R * W),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(cb * EPR), "r"(h), "r"(r0),
        "r"(b), "r"(bar)
        : "memory");
}

// this thread's writes to shared memory, visible to the copies' (async
// proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a swizzled tile of R rows into rows [r0, r0 + R) of head h of batch b
// through the tensor map (rows past T are not written), one copy a column
// block; returns once the copies have read the tile
template <int D, int R>
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t tile, int b, int h,
                                          int r0) {
  constexpr int W = Sw<D>::W, EPR = Sw<D>::EPR;
#pragma unroll
  for (int cb = 0; cb < D / EPR; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, "
        "%2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(cb * EPR), "r"(h), "r"(r0), "r"(b), "r"(tile + cb * R * W)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
template <>
struct Mma<16> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
  }
  // A in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<32> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
  }
  // A in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
  }
  // A in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <int D>
struct Cfg {
  static constexpr int BC = 64;  // keys a streamed tile
  // K/V tiles in the ring (Q, G and two stages fill 96 KB at D = 128)
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int NB = BC / 64;           // S, dP wgmmas across a tile
  static constexpr int NW = D >= 64 ? 64 : D;  // N of one dQ wgmma
  static constexpr int NH = D / NW;            // dQ wgmmas across D
  static constexpr int kOwnedBytes = kRows * D * 2;
  static constexpr int kTileBytes = BC * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // k, v
  // Q, G, the ring, their barriers (Q and G's, then each stage's K and V),
  // and 1024 bytes to align the base
  static constexpr int kSmem =
      1024 + 2 * kOwnedBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
  static_assert(BC % 64 == 0 && kStages >= 2, "tile plan");
  static_assert(kOwnedBytes % 1024 == 0 && kTileBytes % 1024 == 0,
                "tiles must start on 1024 bytes");
  static_assert(kSmem <= kSmemLimit,
                "shared memory plan exceeds the block limit");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap dqmap,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len, int T, int H,
                         float scale, int causal) {
  using C = Cfg<D>;
  constexpr int BC = C::BC, NB = C::NB, NW = C::NW, NH = C::NH;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem + (base - raw);
  const uint32_t q_s = base;  // Q [kRows, D], swizzled; then dQ
  const uint32_t g_s = base + C::kOwnedBytes;        // G [kRows, D]
  const uint32_t ring = base + 2 * C::kOwnedBytes;   // per stage: K, V
  // Q and G's barrier, then each stage's K and V barriers
  const uint32_t bars = ring + S * C::kStageBytes;
  auto kbar = [&](int tile) { return bars + 8 * (1 + 2 * (tile % S)); };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the last query tiles first: under the causal mask they see the most
  // key tiles (see the grid's order below)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x;
  const int grp = tid >> 7;  // this thread's warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int wr = warp * 16;  // this warp's rows of the query tile
  // this group's Q and G rows: the A operands of S and dP
  const uint32_t q_g = q_s + grp * 64 * Sw<D>::W;
  const uint32_t g_g = g_s + grp * 64 * Sw<D>::W;
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));
  const float c2 = scale * kLog2e;  // S to the exponent's base-2 units

  // this thread's queries wr + gi and wr + gi + 8: lse in the exponent's
  // base-2 units, and delta (0 past T)
  float ml[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + wr + gi + 8 * hf;
    ml[hf] = qp < T ? lse[(long long)bh * T + qp] * kLog2e : 0.f;
    dr[hf] = qp < T ? delta[(long long)bh * T + qp] : 0.f;
  }
  // dQ's accumulators (element 4j + i of dqa[n]: query gi + 8 (i >> 1),
  // column n NW + 8j + 2 ti + (i & 1))
  float dqa[NH][NW / 2];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) dqa[n][i] = 0.f;
  // S, then P; dP, then dS: element 4j + i of sa[n] is key 64 n + 8j +
  // 2 ti + (i & 1)
  float sa[NB][32], pa[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[n][i] = pa[n][i] = 0.f;
  uint32_t dh[NB][4][4], dl[NB][4][4];  // dS's bf16 halves, as A fragments

  // key tiles that do any work: up to the row length, and for causal
  // attention up to this query tile's frontier
  int n_tiles = (len + BC - 1) / BC;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + BC - 1) / BC);

  if (n_tiles > 0) {
    // one thread issues every copy (TMA: the tile's rows of K and V, rows
    // past T zero), K's and V's completing on barriers of their own
    auto load_stage = [&](int tile) {
      const uint32_t kt = ring + (tile % S) * C::kStageBytes;
      const uint32_t bar = kbar(tile);
      bar_expect(bar, C::kTileBytes);
      tma_tile<D, BC>(kt, &kmap, b, h, tile * BC, bar);
      bar_expect(bar + 8, C::kTileBytes);
      tma_tile<D, BC>(kt + C::kTileBytes, &vmap, b, h, tile * BC, bar + 8);
    };
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= 2 * S; ++i) bar_init(bars + 8 * i);
      bar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      // Q and G, then the first S - 1 tiles
      bar_expect(bars, 2 * C::kOwnedBytes);
      tma_tile<D, kRows>(q_s, &qmap, b, h, q0, bars);
      tma_tile<D, kRows>(g_s, &gmap, b, h, q0, bars);
      for (int t = 0; t < S - 1 && t < n_tiles; ++t) load_stage(t);
    }
    bar_wait(bars, 0);

    for (int tile = 0; tile < n_tiles; ++tile) {
      // every thread is done with the stage the next copy refills
      __syncthreads();
      if (tid == 0 && tile + S - 1 < n_tiles) load_stage(tile + S - 1);
      bar_wait(kbar(tile), (tile / S) & 1);
      const uint32_t kt = ring + (tile % S) * C::kStageBytes;
      const uint32_t vt = kt + C::kTileBytes;
      const int kk0 = tile * BC;

      // S = Q K^T, then dP = G V^T once V has landed (64 queries x BC
      // keys each), in commit groups of their own: P is computed while dP
      // runs
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        hold(sa[n]);
        hold(pa[n]);
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          Mma<64>::ss(sa[n], desc_k<D, kRows>(q_g, ks),
                      desc_k<D, BC>(kt + n * 64 * Sw<D>::W, ks), ks);
      wg_commit();
      bar_wait(kbar(tile) + 8, (tile / S) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          Mma<64>::ss(pa[n], desc_k<D, kRows>(g_g, ks),
                      desc_k<D, BC>(vt + n * 64 * Sw<D>::W, ks), ks);
      wg_commit();
      wg_wait1();
#pragma unroll
      for (int n = 0; n < NB; ++n) hold(sa[n]);

      // P in place of S (0 where a pair is masked); mask only the
      // length-edge, T-edge and diagonal tiles
      const bool edge = kk0 + BC > len || q0 + kRows > T ||
                        (causal && kk0 + BC - 1 > q0);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hf = (e >> 1) & 1;
          const int qp = q0 + wr + gi + 8 * hf;
          const int kp = kk0 + n * 64 + (e >> 2) * 8 + 2 * ti + (e & 1);
          const bool valid =
              !edge || (qp < T && kp < len && (!causal || kp <= qp));
          sa[n][e] = valid ? ex2(fmaf(sa[n][e], c2, -ml[hf])) : 0.f;
        }
      wg_wait();
#pragma unroll
      for (int n = 0; n < NB; ++n) hold(pa[n]);

      // dS = P (dP - delta) scale in place of dP, split into A fragments
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          pa[n][e] = sa[n][e] * (pa[n][e] - dr[(e >> 1) & 1]) * scale;
        to_a<64>(pa[n], dh[n], dl[n]);
      }

      // dQ += dS K over this tile's keys: dS's lo half, then its hi half
#pragma unroll
      for (int n = 0; n < NH; ++n) hold(dqa[n]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        hold(dh[n]);
        hold(dl[n]);
      }
      wg_fence();
#pragma unroll
      for (int c = 0; c < BC / 16; ++c)
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const uint64_t kd = desc_mn<D, BC>(kt, 16 * c, n);
          Mma<NW>::rs(dqa[n], dl[c / 4][c % 4], kd, 1);
          Mma<NW>::rs(dqa[n], dh[c / 4][c % 4], kd, 1);
        }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int n = 0; n < NH; ++n) hold(dqa[n]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        hold(dh[n]);
        hold(dl[n]);
      }
    }
  }

  // every group is done with Q: its tile takes dQ
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  stage_rows<D, NW, NH>(sbase, dqa, one, wr, lane);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) tma_store<D, kRows>(&dqmap, q_s, b, h, q0);
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

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh;
};

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* g, const float* lse, const float* delta,
                   const int* kv_len, bf16* dq, int B, int T, int H,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = Cfg<D>::kSmem;
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, bytes, ready);
  if (err != cudaSuccess) return err;
  // the tensor maps, by value into the kernel's parameters (so a CUDA
  // graph captures them)
  CUtensorMap qm, km, vm, gm, dqm;
  err = tensor_map<D>(&qm, q, B, T, H, st.qsb, st.qst, st.qsh, kRows);
  if (err == cudaSuccess)
    err = tensor_map<D>(&gm, g, B, T, H, st.gsb, st.gst, st.gsh, kRows);
  if (err == cudaSuccess)
    err = tensor_map<D>(&km, k, B, T, H, st.ksb, st.kst, st.ksh,
                        Cfg<D>::BC);
  if (err == cudaSuccess)
    err = tensor_map<D>(&vm, v, B, T, H, st.vsb, st.vst, st.vsh,
                        Cfg<D>::BC);
  // dQ: contiguous [B, T, H, D]
  if (err == cudaSuccess)
    err = tensor_map<D>(&dqm, dq, B, T, H, (long long)T * H * D,
                        (long long)H * D, D, kRows);
  if (err != cudaSuccess) return err;
  // blocks start in index order, x fastest: the heads inside a query tile
  // index, so the causal mask's longest blocks (the last query tiles)
  // start first and the shortest fill the last wave
  dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, gm, dqm, lse, delta, kv_len, T, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g: bf16 [B, T, H, D] with the given element strides (the last
// dim contiguous, every row 16-byte aligned), D 16, 32, 64 or 128; lse,
// delta: fp32 [B, H, T] contiguous; kv_len: int32 [B] or null (all T); dq:
// bf16 [B, T, H, D] contiguous. Returns the cudaError_t of the launch.
extern "C" int ptt_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int* kv_len, void* dq, int B,
    int T, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long gsb, long long gst, long long gsh, float scale,
    int causal, void* stream) {
  const Strides st = {qsb, qst, qsh, ksb, kst, ksh,
                      vsb, vst, vsh, gsb, gst, gsh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch<16>(qp, kp, vp, gp, lse, delta, kv_len, dqp, B, T, H, st,
                       scale, causal, s);
      break;
    case 32:
      err = launch<32>(qp, kp, vp, gp, lse, delta, kv_len, dqp, B, T, H, st,
                       scale, causal, s);
      break;
    case 64:
      err = launch<64>(qp, kp, vp, gp, lse, delta, kv_len, dqp, B, T, H, st,
                       scale, causal, s);
      break;
    case 128:
      err = launch<128>(qp, kp, vp, gp, lse, delta, kv_len, dqp, B, T, H,
                        st, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
