#!/usr/bin/env python3
"""What K9's (masked sequence pool) design choices cost: time the kernel
under pinned launch plans on one NVIDIA card.

    python3 k9_ablation.py

K9 (paddle_tpu_torch/csrc/masked_pool_fwd.cu) at its three timing shapes,
SQRT pool, ragged lengths from `case_inputs` (one row of T, one of 1):
the conv net's serving dispatch x [8, 256, 32], a wide [128, 256, 512]
(warm, and cold: the calls rotate over copies of x whose total exceeds
COLD_BYTES, so that no call finds its rows in the 50 MB L2) and a long
[4, 4096, 512]. At each:
  * the default plan (cuda_kernels.pool_launch_plan on this card);
  * every cluster size CS 1, 2, 4, 8 pinned, with register loads and with
    the bulk copy: the BULK variant of the source (its load loop replaced
    by cp.async.bulk copies of the block's span into shared memory, two
    16 KB stages on mbarriers, summed from there) under the plan's CS
    with one tile of every column;
  * SPEC, a variant that issues a thread's first batch of loads before
    the row's length arrives (over the block's steps cut to T) and drops
    the steps at or past the length after it, at the default plan;
  * 16 loads a thread in flight instead of 8, and __launch_bounds__(256,
    8) (32 registers: 8 blocks an SM), each planned with its own
    occupancy;
  * 4-byte loads (vec 1: the plan of an unaligned x) against 16-byte ones,
    at the default CS;
  * x.sum(1), and the launch floor: an empty hand-written kernel (one
    block, and the default plan's grid as clusters of its CS).
The variants with a plan other than the default also check their result
against the plain version (SQRT, 1e-4).
Times: a CUDA graph of ITERS calls replayed REPS times after warm-up,
CUDA events, the median over replays divided by ITERS.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np

ITERS, REPS = 20, 7
SEED = 0
# (what, B, T, F): serving is the conv net's bucket (8, 256) at 32 filters
SHAPES = (("serving", 8, 256, 32), ("wide", 128, 256, 512),
          ("long", 4, 4096, 512))
COLD_BYTES = 150 * 2 ** 20   # the rotated copies of x hold more than this
K9_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "paddle_tpu_torch", "csrc", "masked_pool_fwd.cu")
# the bulk copy: helpers inserted before the kernel, and the kernel's
# register loads replaced by them where x is read as float4
_KERNEL = "template <int VEC>\n__global__"
_LOADS = """  V acc = sum_loads(xc, sxt / VEC, t0 + ty, t1, lt, ok);
"""
BULK_HELPERS = r"""constexpr int kPiece = 1024;  // float4s of one bulk stage (16 KB)

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// spins until the phase of `parity` has completed; a copy that never
// lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned int parity) {
  unsigned int done;
  int tries = 0;
  do {
    if (++tries > (1 << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float4* dst, const float4* src,
                                          unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the block's steps [t0, t1) of a row, one contiguous span of `cols`
// float4s a step, copied in 16 KB pieces through a two-stage ring and
// summed from shared memory; every thread of the block calls it
__device__ __forceinline__ float4 sum_bulk(const float4* __restrict__ xr,
                                           int cols, int t0, int t1, int tx,
                                           int ty, int lt, bool ok,
                                           float4* ring,
                                           unsigned long long* bar) {
  float4 acc;
  zero(acc);
  const int per = kPiece / cols;
  const int n = max(t1 - t0, 0);
  const int pieces = (n + per - 1) / per;
  const float4* src = xr + (long long)t0 * cols;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int p = 0; p < min(2, pieces); ++p)
      bulk_copy(ring + p * kPiece, src + (long long)p * per * cols,
                min(per, n - p * per) * cols * 16, &bar[p]);
  for (int p = 0; p < pieces; ++p) {
    const int s = p & 1;
    mbar_wait(&bar[s], (p >> 1) & 1);
    const int m = min(per, n - p * per);
    const float4* buf = ring + s * kPiece;
    if (ok)
      for (int q = ty; q < m; q += lt) add(acc, buf[q * cols + tx]);
    __syncthreads();
    if (threadIdx.x == 0 && p + 2 < pieces)
      bulk_copy(ring + s * kPiece, src + (long long)(p + 2) * per * cols,
                min(per, n - (p + 2) * per) * cols * 16, &bar[s]);
  }
  return acc;
}

"""
BULK_LOADS = """  __shared__ __align__(128) float4 ring[2 * kPiece];
  __shared__ __align__(8) unsigned long long bar[2];
  V acc;
  if constexpr (VEC == 4)
    acc = sum_bulk(reinterpret_cast<const float4*>(x + (long long)row * sxb),
                   F / 4, t0, t1, tx, ty, lt, ok, ring, bar);
  else
    acc = sum_loads(xc, sxt / VEC, t0 + ty, t1, lt, ok);
"""
# the speculative first batch: its loads wait for no length
SPEC_HELPERS = r"""template <typename V>
__device__ __forceinline__ V sum_spec(const V* __restrict__ xc,
                                      long long st, int t0, int first,
                                      int t1, int lt, bool ok) {
  V acc;
  zero(acc);
  if (!ok) return acc;
  for (int base = t0, lim = first; base < lim;
       base += kUnroll * lt, lim = t1) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * lt;
      if (t < lim)
        v[u] = __ldg(xc + t * st);
      else
        zero(v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * lt >= t1) zero(v[u]);
#pragma unroll
    for (int s = 1; s < kUnroll; s *= 2)
#pragma unroll
      for (int u = 0; u < kUnroll; u += 2 * s) add(v[u], v[u + s]);
    add(acc, v[0]);
  }
  return acc;
}

"""
SPEC_LOADS = """  V acc = sum_spec(xc, sxt / VEC, t0 + ty, min(t0 + chunk, T), t1, lt,
                   ok);
"""
# variant -> [(the text as it is, the text that replaces it)]
EDITS = {"bulk": [(_KERNEL, BULK_HELPERS + _KERNEL), (_LOADS, BULK_LOADS)],
         "spec": [(_KERNEL, SPEC_HELPERS + _KERNEL), (_LOADS, SPEC_LOADS)],
         "unroll 16": [("constexpr int kUnroll = 8;",
                        "constexpr int kUnroll = 16;")],
         "8 blocks an SM": [("__launch_bounds__(kThreads)\nmasked_pool",
                             "__launch_bounds__(kThreads, 8)\nmasked_pool")]}
# the variants whose registers, and so the blocks an SM holds, differ:
# planned with their own occupancy query
OWN_OCCUPANCY = ("unroll 16", "8 blocks an SM")
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
// an empty kernel: `grid` blocks of 256 threads in clusters of `cs`
extern "C" int ptt_empty(int grid, int cs, void* stream) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  config.gridDim = dim3(grid);
  config.blockDim = dim3(256);
  config.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&config, empty_kernel);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
"""


def variant_source(name, path=K9_SRC):
    """K9's source with the EDITS of variant `name` made (each text must
    be there once)."""
    with open(path) as f:
        src = f.read()
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError("k9_ablation: %r no longer matches %s once; "
                             "update EDITS" % (old[:40], path))
        src = src.replace(old, new)
    return src


def nvcc_lib(ck, build_dir, stem, source):
    """Compile `source` into build_dir/lib<stem>.so and load it."""
    src = os.path.join(build_dir, stem + ".cu")
    lib_path = os.path.join(build_dir, "lib%s.so" % stem)
    with open(src, "w") as f:
        f.write(source)
    out = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v",
                          "-shared", src, "-o", lib_path],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s%s"
                           % (stem, out.stdout, out.stderr))
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("k9_ablation: ptxas %s: %s" % (stem, line.strip()))
    return ctypes.CDLL(lib_path)


def empty_lib(ck, build_dir):
    """The empty kernel, built and bound: fn(grid, cs, stream)."""
    lib = nvcc_lib(ck, build_dir, "ptt_empty", EMPTY_SRC)
    lib.ptt_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ptt_empty.restype = ctypes.c_int
    return lib


def launch_floor(torch, ck, lib, x, grid=1, cs=1):
    """A function launching the empty kernel on x's stream."""
    def run():
        err = lib.ptt_empty(grid, cs, ck._stream_of(x))
        if err:
            raise RuntimeError("the empty kernel failed to launch "
                               "(cudaError %d)" % err)
    return run


def baseline_pool(torch, ck, lib):
    """A function with masked_pool's signature launching the bc496a2 K9
    (one block per row and feature tile, rows on grid.y) from `lib`; no
    launch count (it is on no path)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_masked_pool_fwd.argtypes = [P, L, L, P, P, I, I, I, I, P]
    lib.ptt_masked_pool_fwd.restype = I

    def run(x, lens, ptype="SQRT"):
        b, t, f = x.shape
        out = torch.empty((b, f), dtype=torch.float32, device=x.device)
        err = lib.ptt_masked_pool_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), lens.data_ptr(),
            out.data_ptr(), b, t, f, ck.POOL_TYPES.index(ptype),
            ck._stream_of(x))
        if err:
            raise RuntimeError("the baseline K9 failed to launch "
                               "(cudaError %d)" % err)
        return out
    return run


def case_lens(b, t, seed):
    """Ragged lengths in [1, T], the first row T and the last 1."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    return lens.tolist()


def case_inputs(torch, b, t, f, seed=SEED, copies=1):
    """`copies` N(0, 1) tensors x [B, T, F] and int32 lengths on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    xs = [torch.randn((b, t, f), generator=g, device="cuda")
          for _ in range(copies)]
    lens = torch.tensor(case_lens(b, t, seed), dtype=torch.int32,
                        device="cuda")
    return xs, lens


def cold_copies(b, t, f):
    """Copies of an fp32 x [B, T, F] whose total exceeds COLD_BYTES."""
    return max(2, -(-COLD_BYTES // (4 * b * t * f)) + 1)


def rotating_ms(torch, fns, iters=ITERS, reps=REPS):
    """Device time of one call, in ms: `iters` calls captured in one CUDA
    graph, call i being fns[i % len(fns)] (one function: warm; functions
    on copies of the input that overflow L2: cold), replayed `reps` times
    after warm-up, timed by CUDA events; the median over replays divided
    by `iters`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    del graph
    return statistics.median(times)


def describe(plan):
    """One line of a K9 launch plan."""
    return ("CS=%d vec=%d lf=%d lt=%d tiles=%d chunk=%d grid=%s (%d blocks "
            "an SM)" % (plan["cs"], plan["vec"], plan["lf"], plan["lt"],
                        plan["tiles"], plan["chunk"], plan["grid"],
                        plan["blocks_per_sm"]))


def plan_variants(torch, ck, x, libs):
    """{name: (plan, build)}: the default plan (build "base": the
    package's library), each CS with register loads and, where the span
    is contiguous and F <= 1024, with the bulk copy under one tile of
    every column (build "bulk"), the speculative first batch at the
    default plan (build "spec"), the OWN_OCCUPANCY builds planned with
    their own occupancy query, and vec 1 at the default CS."""
    b, t, f = x.shape
    default = ck.pool_plan_of(x)
    out = {"default": (default, "base")}
    for cs in ck.POOL_CLUSTERS:
        plan = ck.pool_plan_of(x, cs=cs)
        out["CS=%d registers" % cs] = (plan, "base")
        if plan["vec"] == 4 and x.stride(1) == f and plan["cols"] <= 256:
            lf = 1
            while lf < plan["cols"]:
                lf *= 2
            out["CS=%d bulk" % cs] = (dict(
                plan, lf=lf, lt=ck.POOL_THREADS // lf, tiles=1,
                grid=(b * cs, 1)), "bulk")
    out["spec"] = (default, "spec")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for name in OWN_OCCUPANCY:
        out[name] = (ck.pool_launch_plan(
            b, t, f, x.stride(0), x.stride(1), x.data_ptr() % 16 == 0, sms,
            blocks_per_sm=occupancy(libs[name], default["vec"])), name)
    # the plan of an unaligned x at the default CS
    out["vec 1"] = (ck.pool_launch_plan(
        b, t, f, x.stride(0), x.stride(1), False, sms, cs=default["cs"],
        blocks_per_sm=occupancy(libs["base"], 1)), "base")
    return out


def occupancy(lib, vec):
    """The blocks of `lib`'s vec kernel an SM holds at once."""
    n = ctypes.c_int(0)
    err = lib.ptt_masked_pool_blocks_per_sm(vec, ctypes.byref(n))
    if err:
        raise RuntimeError("k9_ablation: occupancy query failed (cudaError "
                           "%d)" % err)
    return n.value


def run(torch, ck):
    """Every variant at every shape; prints one line each and returns
    {(shape, variant): ms}."""
    lib = ck.build()
    tmp = tempfile.mkdtemp(prefix="ptt_k9_ablation_")
    res = {}
    try:
        empty = empty_lib(ck, tmp)
        libs = {"base": lib}
        for name in EDITS:
            libs[name] = nvcc_lib(ck, tmp, "ptt_pool_" + name.replace(
                " ", "_"), variant_source(name))
            ck._bind_pool(libs[name])
        for what, b, t, f in SHAPES:
            xs, lens = case_inputs(torch, b, t, f)
            x = xs[0]
            variants = plan_variants(torch, ck, x, libs)
            cold = None
            if what == "wide":
                cold, _ = case_inputs(torch, b, t, f,
                                      copies=cold_copies(b, t, f))
            for name, (plan, build) in variants.items():
                vlib = libs[build]
                out = torch.empty((b, f), device="cuda")
                want = ck.masked_pool_plain(x, lens, "SQRT")
                got = ck._launch_pool(vlib, plan, x, lens, "SQRT", out)
                err = (got - want).abs().max().item()
                if not err <= 1e-4:
                    raise SystemExit("k9_ablation: %s %s is %r away from "
                                     "the plain version" % (what, name, err))
                ms = rotating_ms(torch, [
                    lambda plan=plan, vlib=vlib: ck._launch_pool(
                        vlib, plan, x, lens, "SQRT", out)])
                res[(what, name)] = ms
                line = "k9_ablation: %-8s x [%d,%d,%d] %-15s %s: %.4f ms" % (
                    what, b, t, f, name, describe(plan), ms)
                if cold is not None:
                    cms = rotating_ms(torch, [
                        lambda plan=plan, vlib=vlib, c=c: ck._launch_pool(
                            vlib, plan, c, lens, "SQRT", out) for c in cold])
                    res[(what + " cold", name)] = cms
                    line += ", cold %.4f ms" % cms
                print(line, flush=True)
            ms = rotating_ms(torch, [lambda: x.sum(1)])
            res[(what, "x.sum(1)")] = ms
            line = "k9_ablation: %-8s x [%d,%d,%d] x.sum(1): %.4f ms" % (
                what, b, t, f, ms)
            if cold is not None:
                cms = rotating_ms(torch, [lambda c=c: c.sum(1) for c in cold])
                res[(what + " cold", "x.sum(1)")] = cms
                line += ", cold %.4f ms" % cms
            print(line, flush=True)
            plan = variants["default"][0]
            for grid, cs in ((1, 1), (plan["grid"][0] * plan["grid"][1],
                                      plan["cs"])):
                ms = rotating_ms(torch, [launch_floor(torch, ck, empty, x,
                                                      grid, cs)])
                res[(what, "empty %d/%d" % (grid, cs))] = ms
                print("k9_ablation: %-8s empty kernel, %d blocks in clusters "
                      "of %d: %.4f ms" % (what, grid, cs, ms), flush=True)
            del xs, cold
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("k9_ablation: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip().splitlines()[0] if out.stdout.strip()
          else "nvidia-smi printed nothing")
    run(torch, ck)
    return 0


if __name__ == "__main__":
    sys.exit(main())
