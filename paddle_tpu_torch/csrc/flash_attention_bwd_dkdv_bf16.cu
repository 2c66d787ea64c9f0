// Flash attention backward, dK and dV, in bf16 for Hopper (sm_90a): q, k,
// v, g, dk and dv bf16, lse and delta fp32, every product a bf16 wgmma on
// the tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_flash_bwd_dkdv_kernel` (:157, launched by `_flash_bwd` :240) on bf16
// tiles, the JAX package's mixed-precision path: the flash recompute from
// the forward's saved log-sum-exp, p = exp(q.k * scale - lse), so the
// [T, T] matrix never reaches device memory. With g the output gradient
// and delta = rowsum(g * out) (computed by the caller, as the TPU path does
// outside its kernels):
//   dV = P^T G,  dS = P * (G V^T - delta) * scale,  dK = dS^T Q.
// The TPU kernel widens the bf16 tiles to f32 and multiplies and sums in
// f32, P and dS included; this kernel keeps that precision (below). dQ is
// the K3 of flash_attention_bwd.cu; the fp32 kernels are there too.
//
// What bounds it. A valid (query, key) pair costs 8*D flops (S, dP, dV,
// dK) against q, g, dk, dv (2 bytes an element), lse and delta (4), each
// moved once: at T = 256, D = 64 about 170 flops per byte, under the 295
// at which the bf16 tensor cores (989 TFLOP/s on an H100 SXM) and not the
// memory (3.35 TB/s) would bound it. So the bound is bytes.
//
// Precision. S^T = K Q^T and dP^T = V G^T multiply bf16 values: one bf16
// wgmma each, exact products and f32 sums; the scale goes onto the f32
// accumulator, folded with log2(e) into the exponent (exp2). P^T and dS^T
// are f32 and not bf16 values: each splits into hi = bf16(x) and lo =
// bf16(x - hi), and dV += P^T G, dK += dS^T Q are two wgmma each (lo,
// then hi): about 16 bits of P and dS, an error near 2^-17, as close to
// the TPU kernel's f32 as its f32 sums can tell. 6 bf16 products for 4
// useful ones: at the training shape about 0.013 ms at the bf16 peak,
// under the 0.0152 ms its bytes take.
//
// The design (Hopper's warpgroup products; FlashAttention-3's register
// reuse).
//   * One block is one warpgroup (128 threads) and owns one (batch*head,
//     64-key tile), keys on wgmma's M: K and V stay resident in shared
//     memory, and the query tiles (with their lse and delta rows) stream
//     past from the causal frontier, through a three-stage ring (two at
//     D = 128).
//   * S^T and dP^T take K, V and Q, G from shared memory, all K-major (D
//     contiguous, as they lie in device memory). Their accumulators'
//     layout (rows g and g + 8 of each warp's 16 keys, query columns 8j +
//     2t and 8j + 2t + 1) is the A-fragment layout of dV += P^T G and dK
//     += dS^T Q, whose reduction runs over those queries: P^T and dS^T
//     are packed in place and never touch shared memory. G and Q are
//     their B operands MN-major (D contiguous along N), read from the
//     very tiles S^T and dP^T read K-major.
//   * Shared memory holds each tile as wgmma's descriptors read it: rows
//     of W = min(2 D, 128) bytes, D cut into column blocks of W / 2
//     elements, each row's 16-byte chunks permuted by the swizzle's XOR.
//   * K, V and the q and g tiles arrive by TMA: one thread issues
//     cp.async.bulk.tensor copies of the [B, T, H, D] views, whose tensor
//     maps the host encodes at each launch (cuTensorMapEncodeTiled through
//     the runtime's driver entry point; by value in the kernel's
//     parameters, so a CUDA graph captures them) with the layout's
//     swizzle; rows past T read as zeros; each stage's copies complete on
//     an mbarrier. The lse and delta rows (4-byte aligned only) come by
//     cp.async, a group a stage. Keys at or past the row's length load as
//     they are and are masked. (With every tile copied by cp.async the
//     kernel took 15% longer at the training shape.)
//   * 64 streamed queries a tile (32 at D = 128, where the dK and dV sums
//     alone take 128 registers a thread).
//   * wgmma.fence, commit_group and wait_group bracket every product, and
//     no accumulator or A fragment is touched between an issue and its
//     wait (ptxas would serialise the products otherwise; chip_smoke.py
//     --ptxas fails on that).
//   * A key tile at or past the row's key length does nothing; only the
//     diagonal, length-edge and T-edge tiles mask element by element, a
//     pair masked BEFORE the exponential (a select, never inf * 0): a row
//     with key length 0 gets gradients 0, as in the TPU kernel. There are
//     no atomics: every sum stays in one block, in a fixed order.
// It reads q, k, v and g with their strides from the [B, T, H, D] layout
// (the last dim contiguous, every stride a multiple of 16 bytes, as TMA
// needs) and allocates nothing.
// Its helpers are copies of flash_attention_fwd_bf16.cu's: each source
// builds alone.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroups = 1;          // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64 * kGroups;  // key rows a block, 64 a group
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
  static constexpr int BQ = D == 128 ? 32 : 64;  // queries a streamed tile
  static constexpr int kStages = 3;              // query tiles in the ring
  static constexpr int NW = D >= 64 ? 64 : D;    // N of one dV / dK wgmma
  static constexpr int NH = D / NW;              // such wgmmas across D
  static constexpr int kOwnedBytes = kRows * D * 2;
  static constexpr int kTileBytes = BQ * D * 2;
  // per stage: the q and g tiles, then the lse and delta rows (f32),
  // rounded up so the next stage's tiles start on 1024 bytes
  static constexpr int kStageBytes =
      (2 * kTileBytes + 2 * BQ * 4 + 1023) / 1024 * 1024;
  // K, V, the ring, their barriers, and 1024 bytes to align the base
  static constexpr int kSmem =
      1024 + 2 * kOwnedBytes + kStages * kStageBytes + 8 * (1 + kStages);
  static_assert(kStages >= 2, "tile plan");
  static_assert(kOwnedBytes % 1024 == 0 && kTileBytes % 1024 == 0,
                "tiles must start on 1024 bytes");
  static_assert(kSmem <= kSmemLimit,
                "shared memory plan exceeds the block limit");
};

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, gsb, gst, gsh;
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// [r0, r0 + n) of one [T] row of lse or delta; zero past T
__device__ __forceinline__ void load_vec(uint32_t dst, const float* row,
                                         int r0, int n, int T, int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = r0 + i < T;
    cp_async4(dst + 4 * i, ok ? row + r0 + i : row, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const __grid_constant__ CUtensorMap dkmap,
                           const __grid_constant__ CUtensorMap dvmap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ kv_len, int T, int H,
                           float scale, int causal) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, NW = C::NW, NH = C::NH;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem + (base - raw);
  // K and V [kRows, D], swizzled; then dK and dV
  const uint32_t k_s = base;
  const uint32_t v_s = base + C::kOwnedBytes;
  const int ring = 2 * C::kOwnedBytes;  // per stage: q, g, lse, delta
  // the K, V barrier, then each stage's
  const uint32_t bars = base + ring + S * C::kStageBytes;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int grp = tid >> 7;  // this thread's warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int wr = warp * 16;  // this warp's rows of the key tile
  // this group's K and V rows: the A operands of S^T and dP^T
  const uint32_t k_g = k_s + grp * 64 * Sw<D>::W;
  const uint32_t v_g = v_s + grp * 64 * Sw<D>::W;
  int len = kv_len ? kv_len[b] : T;
  len = max(0, min(len, T));
  const float c2 = scale * kLog2e;  // S to the exponent's base-2 units

  // this thread's keys wr + gi and wr + gi + 8: dK's and dV's accumulators
  // (element 4j + i of dka[n]: key gi + 8 (i >> 1), column n NW + 8j +
  // 2 ti + (i & 1))
  float dka[NH][NW / 2], dva[NH][NW / 2];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) dka[n][i] = dva[n][i] = 0.f;
  // S^T then P^T, dP^T then dS^T: element 4j + i is query 8j + 2 ti + (i & 1)
  float sa[BQ / 2], pa[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sa[i] = pa[i] = 0.f;
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4];  // P^T's bf16 halves, as A
  uint32_t dh[BQ / 16][4], dl[BQ / 16][4];  // dS^T's

  // query tiles that do any work: from the causal frontier (queries before
  // this key tile see none of its keys) to T; none when the whole key tile
  // lies at or past the row's key length
  const int n_tiles = (T + BQ - 1) / BQ;
  const int first = k0 >= len ? n_tiles : (causal ? k0 / BQ : 0);

  if (first < n_tiles) {
    const float* lse_row = lse + (long long)bh * T;
    const float* delta_row = delta + (long long)bh * T;
    // one thread issues the tiles' copies (TMA: K, V, and each query
    // tile's q and g rows, rows past T zero), each completing on its
    // barrier; every thread copies its share of the lse and delta rows
    // (cp.async, a group a stage)
    auto load_stage = [&](int tile) {
      const int i = tile - first;
      const uint32_t qt = base + ring + (i % S) * C::kStageBytes;
      const uint32_t rows = qt + 2 * C::kTileBytes;
      const int q0 = tile * BQ;
      if (tid == 0) {
        const uint32_t bar = bars + 8 * (1 + i % S);
        bar_expect(bar, 2 * C::kTileBytes);
        tma_tile<D, BQ>(qt, &qmap, b, h, q0, bar);
        tma_tile<D, BQ>(qt + C::kTileBytes, &gmap, b, h, q0, bar);
      }
      load_vec(rows, lse_row, q0, BQ, T, tid);
      load_vec(rows + 4 * BQ, delta_row, q0, BQ, T, tid);
    };
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= S; ++i) bar_init(bars + 8 * i);
      bar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      bar_expect(bars, 2 * C::kOwnedBytes);
      tma_tile<D, kRows>(k_s, &kmap, b, h, k0, bars);
      tma_tile<D, kRows>(v_s, &vmap, b, h, k0, bars);
    }
    // the first S - 1 query tiles
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (first + t < n_tiles) load_stage(first + t);
      cp_commit();
    }
    bar_wait(bars, 0);

    for (int tile = first; tile < n_tiles; ++tile) {
      const int i = tile - first;
      cp_wait<S - 2>();
      // this tile's lse and delta rows are in place, and every thread is
      // done with the stage the next copies refill
      __syncthreads();
      if (tile + S - 1 < n_tiles) load_stage(tile + S - 1);
      cp_commit();
      bar_wait(bars + 8 * (1 + i % S), (i / S) & 1);
      const int s = i % S;
      const uint32_t qt = base + ring + s * C::kStageBytes;
      const uint32_t gt = qt + C::kTileBytes;
      const float* ls = reinterpret_cast<const float*>(
          sbase + ring + s * C::kStageBytes + 2 * C::kTileBytes);
      const float* ds_row = ls + BQ;
      const int q0 = tile * BQ;

      // S^T = K Q^T and dP^T = V G^T: 64 keys x BQ queries each
      hold(sa);
      hold(pa);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Mma<BQ>::ss(sa, desc_k<D, kRows>(k_g, ks), desc_k<D, BQ>(qt, ks),
                    ks);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Mma<BQ>::ss(pa, desc_k<D, kRows>(v_g, ks), desc_k<D, BQ>(gt, ks),
                    ks);
      wg_commit();
      wg_wait();
      hold(sa);
      hold(pa);

      // P^T in place; mask only the edge and diagonal tiles
      const bool edge = k0 + kRows > len || q0 + BQ > T ||
                        (causal && q0 < k0 + kRows - 1);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = (e >> 2) * 8 + 2 * ti + (e & 1);
        const int key = k0 + wr + gi + ((e & 2) ? 8 : 0);
        const int qp = q0 + col;
        const bool valid =
            !edge || (key < len && qp < T && (!causal || qp >= key));
        sa[e] = valid ? ex2(fmaf(sa[e], c2, -ls[col] * kLog2e)) : 0.f;
      }
      to_a<BQ>(sa, ph, pl);

      // dV += P^T G over this tile's queries (the lo half, then the hi
      // half), issued before dS^T is computed, which overlaps it
#pragma unroll
      for (int n = 0; n < NH; ++n) hold(dva[n]);
      hold(ph);
      hold(pl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c)
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const uint64_t gd = desc_mn<D, BQ>(gt, 16 * c, n);
          Mma<NW>::rs(dva[n], pl[c], gd, 1);
          Mma<NW>::rs(dva[n], ph[c], gd, 1);
        }
      wg_commit();

      // dS^T = P^T (dP^T - delta) scale, in place (0 where P^T is)
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = (e >> 2) * 8 + 2 * ti + (e & 1);
        pa[e] = sa[e] * (pa[e] - ds_row[col]) * scale;
      }
      to_a<BQ>(pa, dh, dl);

      // dK += dS^T Q: the lo half, then the hi half
#pragma unroll
      for (int n = 0; n < NH; ++n) hold(dka[n]);
      hold(dh);
      hold(dl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c)
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const uint64_t qd = desc_mn<D, BQ>(qt, 16 * c, n);
          Mma<NW>::rs(dka[n], dl[c], qd, 1);
          Mma<NW>::rs(dka[n], dh[c], qd, 1);
        }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        hold(dka[n]);
        hold(dva[n]);
      }
      hold(ph);
      hold(pl);
      hold(dh);
      hold(dl);
    }
  }

  // every group is done with K and V: their tiles take dK and dV
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  stage_rows<D, NW, NH>(sbase, dka, one, wr, lane);
  stage_rows<D, NW, NH>(sbase + C::kOwnedBytes, dva, one, wr, lane);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    tma_store<D, kRows>(&dkmap, k_s, b, h, k0);
    tma_store<D, kRows>(&dvmap, v_s, b, h, k0);
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

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* g, const float* lse, const float* delta,
                   const int* kv_len, bf16* dk, bf16* dv, int B, int T,
                   int H, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = Cfg<D>::kSmem;
  cudaError_t err = allow_smem(flash_bwd_dkdv_bf16_kernel<D>, bytes, ready);
  if (err != cudaSuccess) return err;
  // the tensor maps, by value into the kernel's parameters (so a CUDA
  // graph captures them)
  CUtensorMap qm, km, vm, gm, dkm, dvm;
  err = tensor_map<D>(&qm, q, B, T, H, st.qsb, st.qst, st.qsh, Cfg<D>::BQ);
  if (err == cudaSuccess)
    err = tensor_map<D>(&km, k, B, T, H, st.ksb, st.kst, st.ksh, kRows);
  if (err == cudaSuccess)
    err = tensor_map<D>(&vm, v, B, T, H, st.vsb, st.vst, st.vsh, kRows);
  if (err == cudaSuccess)
    err = tensor_map<D>(&gm, g, B, T, H, st.gsb, st.gst, st.gsh,
                        Cfg<D>::BQ);
  // dK and dV: contiguous [B, T, H, D]
  const long long sb = (long long)T * H * D, sr = (long long)H * D;
  if (err == cudaSuccess)
    err = tensor_map<D>(&dkm, dk, B, T, H, sb, sr, D, kRows);
  if (err == cudaSuccess)
    err = tensor_map<D>(&dvm, dv, B, T, H, sb, sr, D, kRows);
  if (err != cudaSuccess) return err;
  // blocks start in index order, x fastest: the heads inside a tile index,
  // so the causal mask's longest blocks (the first key tiles) start first
  // and the shortest fill the last wave
  dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_bwd_dkdv_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, gm, dkm, dvm, lse, delta, kv_len, T, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g: bf16 [B, T, H, D] with the given element strides (the last
// dim contiguous, every row 16-byte aligned), D 16, 32, 64 or 128; lse,
// delta: fp32 [B, H, T] contiguous; kv_len: int32 [B] or null (all T); dk,
// dv: bf16 [B, T, H, D] contiguous. Returns the cudaError_t of the launch.
extern "C" int ptt_flash_attention_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int* kv_len, void* dk,
    void* dv, int B, int T, int H, int D, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, long long gsb, long long gst, long long gsh,
    float scale, int causal, void* stream) {
  const Strides st = {qsb, qst, qsh, ksb, kst, ksh,
                      vsb, vst, vsh, gsb, gst, gsh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch<16>(qp, kp, vp, gp, lse, delta, kv_len, dkp, dvp, B, T, H,
                       st, scale, causal, s);
      break;
    case 32:
      err = launch<32>(qp, kp, vp, gp, lse, delta, kv_len, dkp, dvp, B, T, H,
                       st, scale, causal, s);
      break;
    case 64:
      err = launch<64>(qp, kp, vp, gp, lse, delta, kv_len, dkp, dvp, B, T, H,
                       st, scale, causal, s);
      break;
    case 128:
      err = launch<128>(qp, kp, vp, gp, lse, delta, kv_len, dkp, dvp, B, T,
                        H, st, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
