#!/usr/bin/env python3
"""Why the bf16 flash kernels (K1 forward, K2 dK/dV) are built as they are:
time design alternatives and ablations of
paddle_tpu_torch/csrc/flash_attention_fwd_bf16.cu and
flash_attention_bwd_dkdv_bf16.cu beside them on one NVIDIA card.

    python3 flash_bf16_variants.py [--fwd-baseline SRC] [--bwd-baseline SRC]
                                   [--clock]

Each variant is its kernel's source with lines replaced (VARIANTS for
other designs, each held to its plain version within chip_smoke's
BF16_KERNEL_TOL before it is timed; ABLATIONS for products or the
exponential switched off, to see what each costs: their results are
wrong and only timed; none skips a copy, whose barrier would then wait
for ever), built by nvcc into a temporary directory, all at once, and
called through the port's C interface (chip_smoke.flash_bf16_call).
`--clock` adds the current kernels with clock64() read at the ends of
their phases (CLOCK): the cycles a block spends in each.
`--fwd-baseline SRC` / `--bwd-baseline SRC` (default: `git show
bb43ba4:<source>` when the
checkout has its history) add the bf16 K1 / K2 that the wgmma ones
replaced. Shapes: chip_smoke.flash_timing_shapes (the serving batch with
ragged lengths, the Transformer training step's [32, 256, 8, 64] without
and with the causal mask). Times: chip_smoke.time_ms (a CUDA graph of 20
calls, median of 7 replays), every kernel twice, in turns.
"""
import argparse
import concurrent.futures
import ctypes
import sys
import tempfile

import chip_smoke as cs

SRCS = {"fwd": cs.FLASH_BF16_SRC, "dkdv": cs.DKDV_BF16_SRC}
# two warpgroups a block (128 rows) sharing each streamed tile
_GROUPS = ("constexpr int kGroups = 1;", "constexpr int kGroups = 2;")
_BC128 = ("  static constexpr int BC = 64;       // keys a streamed tile",
          "  static constexpr int BC = 128;      // keys a streamed tile")
# P's hi half by truncation (one byte permute packs both; |x - hi| < 2^-7
# |x|), lo rounded to nearest: about 2^-16 of x, one conversion a pair
# instead of two
_TRUNC = ("  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);\n"
          "  const float2 hf = __bfloat1622float2(h);\n"
          "  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, "
          "x1 - hf.y);\n"
          "  hi = *reinterpret_cast<const uint32_t*>(&h);\n",
          "  const float h0 = __uint_as_float(__float_as_uint(x0) & "
          "0xFFFF0000u);\n"
          "  const float h1 = __uint_as_float(__float_as_uint(x1) & "
          "0xFFFF0000u);\n"
          "  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - h0, "
          "x1 - h1);\n"
          "  hi = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), "
          "0x7632);\n")
_DKDV_3 = ("__global__ void __launch_bounds__(kThreads)\n"
           "flash_bwd_dkdv_bf16_kernel(",
           "__global__ void __launch_bounds__(kThreads, 3)\n"
           "flash_bwd_dkdv_bf16_kernel(")
_DV_WAIT = ("      wg_commit();\n\n      // dS^T = P^T (dP^T - delta) scale",
            "      wg_commit();\n      wg_wait();\n      hold(ph);\n"
            "      hold(pl);\n\n      // dS^T = P^T (dP^T - delta) scale")
# kernel -> variant -> [(text of the source, the text that replaces it)]
VARIANTS = {
    "fwd": {
        # three stages in the K/V ring instead of two
        "3 stages": [(
            "  static constexpr int kStages = 2;   // K/V tiles in the ring",
            "  static constexpr int kStages = 3;   // K/V tiles in the ring")],
        "4 stages": [(
            "  static constexpr int kStages = 2;   // K/V tiles in the ring",
            "  static constexpr int kStages = 4;   // K/V tiles in the ring")],
        # 128 keys a tile: two S wgmmas of N = 64 each k-step
        "128 keys a tile": [_BC128],
        # two warpgroups a block (128 query rows) sharing each K/V tile
        "2 warpgroups": [_GROUPS],
        "2 warpgroups, 128 keys": [_GROUPS, _BC128],
        # exp2f (its range handling) in place of the hardware's ex2.approx
        "exp2f": [("ex2(fmaf(sa[n][e], c2, -mc[hf]))",
                   "exp2f(fmaf(sa[n][e], c2, -mc[hf]))")],
        "hi by truncation": [_TRUNC],
        # at most 96 registers: 5 blocks an SM
        "5 blocks an SM": [(
            "__global__ void __launch_bounds__(kThreads)\n"
            "flash_fwd_bf16_kernel(",
            "__global__ void __launch_bounds__(kThreads, 5)\n"
            "flash_fwd_bf16_kernel(")],
        # P rounded once to bf16 (FlashAttention's precision): one P V
        # product instead of two
        "P rounded once": [(
            "          Mma<NW>::rs(o[n], pl[c / 4][c % 4], vd, 1);\n", "")],
    },
    "dkdv": {
        "2 stages": [(
            "  static constexpr int kStages = 3;              // query tiles "
            "in the ring",
            "  static constexpr int kStages = 2;              // query tiles "
            "in the ring")],
        "4 stages": [(
            "  static constexpr int kStages = 3;              // query tiles "
            "in the ring",
            "  static constexpr int kStages = 4;              // query tiles "
            "in the ring")],
        # 32 streamed queries a tile at every D (64 below D = 128)
        "32 queries a tile": [(
            "  static constexpr int BQ = D == 128 ? 32 : 64;  // queries a "
            "streamed tile",
            "  static constexpr int BQ = 32;                  // queries a "
            "streamed tile")],
        # two warpgroups a block (128 keys) sharing each Q/G tile
        "2 warpgroups": [_GROUPS],
        "exp2f": [("ex2(fmaf(sa[e], c2, -ls[col] * kLog2e))",
                   "exp2f(fmaf(sa[e], c2, -ls[col] * kLog2e))")],
        "hi by truncation": [_TRUNC],
        # at most 168 registers: 3 blocks an SM
        "3 blocks an SM": [_DKDV_3],
        # dV's products waited for before dS is computed (its halves
        # then die first: fewer registers), alone and at 3 blocks an SM
        "dV waited first": [_DV_WAIT],
        "dV waited first, 3 blocks an SM": [_DV_WAIT, _DKDV_3],
        # P and dS rounded once to bf16: one dV and one dK product
        "P, dS rounded once": [
            ("          Mma<NW>::rs(dva[n], pl[c], gd, 1);\n", ""),
            ("          Mma<NW>::rs(dka[n], dl[c], qd, 1);\n", "")],
    },
}
ABLATIONS = {
    "fwd": {
        "no exponential": [(
            "valid(n, e) ? ex2(fmaf(sa[n][e], c2, -mc[hf])) : 0.f;",
            "valid(n, e) ? fmaf(sa[n][e], c2, -mc[hf]) : 0.f;")],
        "no P V": [(
            "          Mma<NW>::rs(o[n], pl[c / 4][c % 4], vd, 1);\n"
            "          Mma<NW>::rs(o[n], ph[c / 4][c % 4], vd, 1);\n", "")],
        "no S": [(
            "          Mma<64>::ss(sa[n], desc_k<D, kRows>(q_g, ks),\n"
            "                      desc_k<D, BC>(kt + n * 64 * Sw<D>::W, ks), "
            "ks);\n", "")],
    },
    "dkdv": {
        "no exponential": [(
            "valid ? ex2(fmaf(sa[e], c2, -ls[col] * kLog2e)) : 0.f;",
            "valid ? fmaf(sa[e], c2, -ls[col] * kLog2e) : 0.f;")],
        "no dV, dK": [
            ("          Mma<NW>::rs(dva[n], pl[c], gd, 1);\n"
             "          Mma<NW>::rs(dva[n], ph[c], gd, 1);\n", ""),
            ("          Mma<NW>::rs(dka[n], dl[c], qd, 1);\n"
             "          Mma<NW>::rs(dka[n], dh[c], qd, 1);\n", "")],
        "no S, dP": [
            ("        Mma<BQ>::ss(sa, desc_k<D, kRows>(k_g, ks), "
             "desc_k<D, BQ>(qt, ks),\n                    ks);\n", ""),
            ("        Mma<BQ>::ss(pa, desc_k<D, kRows>(v_g, ks), "
             "desc_k<D, BQ>(gt, ks),\n                    ks);\n", "")],
    },
}
BASELINE_SRCS = {"fwd": cs.FLASH_SRC, "dkdv": cs.FLASH_BWD_SRC}

# `--clock`: the current kernels with clock64() read by thread 0 of each
# block at the ends of its phases, the cycles summed over blocks into a
# __device__ array (CLOCK_PHASES, then the count of blocks) that
# ptt_clock_read copies out: where a block's time goes
CLOCK_PHASES = ("first copies", "later copies", "S products",
                "softmax, split", "second products", "epilogue")
_CLK = "      CLK(%d)\n"
_CLOCK_COMMON = [
    ("template <int D>\n__global__ void __launch_bounds__(kThreads)",
     "__device__ unsigned long long g_clk[8];\n"
     "#define CLK(i) { const long long now = clock64(); "
     "clk_a[i] += now - clk_t; clk_t = now; }\n\n"
     "template <int D>\n__global__ void __launch_bounds__(kThreads)"),
    ("  const float c2 = scale * kLog2e;  // S to the exponent's base-2 units"
     "\n",
     "  const float c2 = scale * kLog2e;  // S to the exponent's base-2 units"
     "\n  long long clk_t = clock64(), clk_a[6] = {0, 0, 0, 0, 0, 0};\n"),
    ("}\n\n// Dynamic shared memory above 48 KB needs",
     "  CLK(5)\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 6; ++i)\n"
     "      atomicAdd(&g_clk[i], (unsigned long long)clk_a[i]);\n"
     "    atomicAdd(&g_clk[6], 1ull);\n"
     "  }\n"
     "}\n\n// Dynamic shared memory above 48 KB needs"),
]
_CLOCK_READ = (
    "\nextern \"C\" int ptt_clock_read(unsigned long long* out) {\n"
    "  const cudaError_t err =\n"
    "      cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n"
    "  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
    "  return static_cast<int>(err != cudaSuccess ? err : cudaMemcpyToSymbol(\n"
    "      g_clk, zero, sizeof(zero)));\n"
    "}\n")
CLOCK = {
    "fwd": _CLOCK_COMMON + [
        ("  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;\n",
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;\n"
         "  const int first = 0;\n"),
        ("      bar_wait(kbar(tile), (tile / S) & 1);\n",
         "      bar_wait(kbar(tile), (tile / S) & 1);\n"
         "      CLK(tile == first ? 0 : 1)\n"),
        ("      wg_wait();\n#pragma unroll\n"
         "      for (int n = 0; n < NB; ++n) hold(sa[n]);\n",
         "      wg_wait();\n" + _CLK % 2 + "#pragma unroll\n"
         "      for (int n = 0; n < NB; ++n) hold(sa[n]);\n"),
        ("      wg_fence();\n#pragma unroll\n"
         "      for (int c = 0; c < BC / 16; ++c)",
         _CLK % 3 + "      wg_fence();\n#pragma unroll\n"
         "      for (int c = 0; c < BC / 16; ++c)"),
        ("      wg_wait();\n#pragma unroll\n"
         "      for (int n = 0; n < NH; ++n) hold(o[n]);\n",
         "      wg_wait();\n" + _CLK % 4 + "#pragma unroll\n"
         "      for (int n = 0; n < NH; ++n) hold(o[n]);\n")],
    "dkdv": _CLOCK_COMMON + [
        ("      bar_wait(bars + 8 * (1 + i % S), (i / S) & 1);\n",
         "      bar_wait(bars + 8 * (1 + i % S), (i / S) & 1);\n"
         "      CLK(tile == first ? 0 : 1)\n"),
        ("      wg_wait();\n      hold(sa);\n      hold(pa);\n",
         "      wg_wait();\n" + _CLK % 2 + "      hold(sa);\n"
         "      hold(pa);\n"),
        ("      wg_fence();\n#pragma unroll\n"
         "      for (int c = 0; c < BQ / 16; ++c)",
         _CLK % 3 + "      wg_fence();\n#pragma unroll\n"
         "      for (int c = 0; c < BQ / 16; ++c)"),
        ("      wg_wait();\n#pragma unroll\n"
         "      for (int n = 0; n < NH; ++n) {\n        hold(dka[n]);",
         "      wg_wait();\n" + _CLK % 4 + "#pragma unroll\n"
         "      for (int n = 0; n < NH; ++n) {\n        hold(dka[n]);")],
}


def edited(source, path, name, edits):
    for old, new in edits:
        cs.check(old in source, "variant %r: %r is not in %s"
                 % (name, old, path))
        source = source.replace(old, new)
    return source


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fwd-baseline", metavar="SRC",
                    help="the bb43ba4 flash_attention_fwd.cu (its bf16 K1) "
                    "to time beside the variants")
    ap.add_argument("--bwd-baseline", metavar="SRC",
                    help="the bb43ba4 flash_attention_bwd.cu (its bf16 K2)")
    ap.add_argument("--clock", action="store_true",
                    help="also print the cycles a block spends in each "
                    "phase (CLOCK_PHASES) of the current kernels")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bf16_variants: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck

    print(cs.card_line())
    texts = {}   # (part, name, checked) -> source
    for part, path in SRCS.items():
        with open(path) as f:
            source = f.read()
        for table, checked in ((VARIANTS, True), (ABLATIONS, False)):
            for name, edits in table[part].items():
                texts[(part, name, checked)] = edited(source, path, name,
                                                      edits)
        base = cs.baseline_source(
            args.fwd_baseline if part == "fwd" else args.bwd_baseline,
            cs.FLASH_BF16_BASELINE_COMMIT, BASELINE_SRCS[part])
        if base is not None:
            texts[(part, "%s kernel" % cs.FLASH_BF16_BASELINE_COMMIT,
                   True)] = base

    def build(item):
        (part, name, _), text = item
        lib = cs.build_baseline(ck, text, tempfile.mkdtemp(
            prefix="ptt_flash_bf16_variant_"), "ptt_variant", name)
        call = cs.flash_bf16_call(torch, ck, lib, part)
        if name != "clock":
            return call
        lib.ptt_clock_read.argtypes = [ctypes.c_void_p]
        lib.ptt_clock_read.restype = ctypes.c_int
        return call, lib.ptt_clock_read

    clocks = {}
    if args.clock:
        for part, path in SRCS.items():
            with open(path) as f:
                text = edited(f.read(), path, "clock", CLOCK[part])
            texts[(part, "clock", False)] = text + _CLOCK_READ
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = dict(zip(texts, pool.map(build, texts.items())))
    for part in SRCS:
        if (part, "clock", False) in built:
            clocks[part] = built.pop((part, "clock", False))
    fns = {"fwd": {("current", True): ck.flash_attention_fwd},
           "dkdv": {("current", True): ck.flash_attention_bwd_dkdv}}
    for (part, name, checked), fn in built.items():
        fns[part][(name, checked)] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    wrong = set()
    for what, (b, t, h, d, lens), causal in cs.flash_timing_shapes():
        q, k, v, g = cs.flash_bf16_inputs(torch, gen, b, t, h, d, False, 4)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref_out, ref_lse = ck.flash_attention_fwd_plain(q, k, v, kv, causal)
        delta = ck.flash_delta(g, ref_out)
        bargs = (q, k, v, ref_lse, delta, g, kv, causal)
        ref = {"fwd": (ref_out, ref_lse),
               "dkdv": ck.flash_attention_bwd_plain(*bargs)[1:]}
        calls = {"fwd": lambda fn: fn(q, k, v, kv, causal),
                 "dkdv": lambda fn: fn(*bargs)}
        for part, table in fns.items():
            errs = {}
            for (name, checked), fn in table.items():
                got = calls[part](fn)
                torch.cuda.synchronize()
                errs[name] = cs.rel_err(
                    [x.float() for x in got[:1 if part == "fwd" else 2]],
                    [x.float() for x in ref[part][:1 if part == "fwd"
                                                  else 2]])
                if part == "fwd":
                    errs[name] = max(errs[name], (got[1] - ref_lse).abs()
                                     .max().item())
                if checked and not errs[name] <= cs.BF16_KERNEL_TOL:
                    wrong.add((part, name))
                    print("flash_bf16_variants: %s %s causal=%s %r disagrees "
                          "with the plain version by %r: not timed"
                          % (part, what, causal, name, errs[name]))
            times = {key: [] for key in table if (part, key[0]) not in wrong}
            for _ in range(2):
                for key, fn in table.items():
                    times[key].append(cs.time_ms(
                        torch, lambda fn=fn: calls[part](fn)))
            for (name, checked), runs in times.items():
                print("flash_bf16_variants: %s %s [%d,%d,%d,%d] causal=%s "
                      "%-30s %s ms, mean %.4f ms; err %.3e%s"
                      % (part, what, b, t, h, d, causal, name,
                         " / ".join("%.4f" % x for x in runs),
                         sum(runs) / len(runs), errs[name],
                         "" if checked else " (ablation)"))
        for part, (fn, read) in clocks.items():
            buf = (ctypes.c_ulonglong * 8)()
            calls[part](fn)
            torch.cuda.synchronize()
            cs.check(read(buf) == 0, "ptt_clock_read failed")
            for _ in range(5):
                calls[part](fn)
            torch.cuda.synchronize()
            cs.check(read(buf) == 0, "ptt_clock_read failed")
            print("flash_bf16_variants: %s %s causal=%s cycles a block: %s"
                  % (part, what, causal, ", ".join(
                      "%s %.0f" % (name, buf[i] / max(1, buf[6]))
                      for i, name in enumerate(CLOCK_PHASES))))
        del q, k, v, g
        torch.cuda.empty_cache()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
