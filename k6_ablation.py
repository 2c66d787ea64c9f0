#!/usr/bin/env python3
"""Where K6's time goes, and what its launch plan's choices cost: time the
fused-LSTM kernel with parts of each step switched off and under other
plans, on one NVIDIA card. Also K8's (masked softmax) two choices.

    python3 k6_ablation.py

K6 at the sequence path's shapes: a serving dispatch x [8, 256, 512] and a
training step's [128, 64, 512] (D = 128, full lengths).
  * plans: the default (cuda_kernels.lstm_launch_plan on this card) and
    every cluster size CS 2, 4, 8, 16 (16 where the card runs it) with R
    rows a cluster from 1 to 32, the slices of D as the plan picks them;
  * residency: the default plan, whose occupancy query asks at its own
    shared memory, against the plan from a query padded to one block an
    SM (ONE_BLOCK_SMEM), launched at its own size and launched padded;
  * parts: each variant is paddle_tpu_torch/csrc/fused_lstm_fwd.cu with a
    few lines replaced (a loop by an empty one, the cluster barrier by a
    block barrier), built by nvcc into a temporary directory and launched
    through the same C interface with the default plan. The variants
    compute wrong results: only their times mean anything. "floor" keeps
    only the exchange of h through distributed shared memory and the
    cluster barrier (and the block barrier) of every step: the least a
    step of this design costs, whatever the arithmetic.
K8 (csrc/masked_softmax_fwd.cu) at the translator's decoder step x [16,
48] and a wide [2048, 256]: 1-16 warps (rows) a block; loading the whole
row (the loads need not wait for the length) against only the valid
steps (the default); dividing each element by the sum against
multiplying by its reciprocal (the default); expf against the fast
exponential __expf (the default).
Times: a CUDA graph of `ITERS` launches replayed 5 times after warm-up,
CUDA events, the median over replays divided by ITERS.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "paddle_tpu_torch", "csrc")
K6_SRC = os.path.join(CSRC, "fused_lstm_fwd.cu")
K8_SRC = os.path.join(CSRC, "masked_softmax_fwd.cu")
D = 128
SHAPES = ((8, 256), (128, 64))      # (B, T) of x [B, T, 4D]
K8_SHAPES = ((16, 48), (2048, 256))  # x [N, T]

_STEP_ARRIVE = ("      cluster_arrive();\n      Walk io",
                "      __syncthreads();\n      Walk io")
# without the step's cluster barrier one closes the launch, so that no
# block exits while a peer still stores into it
_STEP_WAIT = ("      cluster_wait();\n    }\n  }\n}",
              "      __syncthreads();\n    }\n  }\n  cluster_arrive();\n"
              "  cluster_wait();\n}")
# (what is switched off, [(the text as it is, the text that replaces it)])
PARTS = {
    "gate product": [
        ("item < tiles * ks_n; item += kThreads, it.next()) {",
         "item < 0; item += kThreads, it.next()) {")],
    "cell update": [
        ("const bool valid = t < lens_s[r];", "const bool valid = false;")],
    "exchange": [
        ("for (int p = 1; p < cs; ++p)", "for (int p = 1; p < 1; ++p)")],
    "output writes": [
        ("i < nrows * nu; i += kThreads, io.next()) {",
         "i < 0; i += kThreads, io.next()) {")],
    "x prefetch": [("if (prefetch && k < T) {", "if (false) {")],
    "cluster barrier": [_STEP_ARRIVE, _STEP_WAIT],
    "fast math": [
        ("return __fdividef(1.f, 1.f + __expf(-v));",
         "return 1.f / (1.f + expf(-v));"),
        ("return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));",
         "return tanhf(v);")],
}
# variant name -> the parts it switches off
VARIANTS = {
    "base": [],
    **{"no " + part: [part] for part in PARTS},
    "floor": ["gate product", "cell update", "output writes", "x prefetch"],
    "block barriers alone": ["gate product", "cell update", "output writes",
                             "x prefetch", "exchange", "cluster barrier"],
}
# the entry point takes a plan whose shared memory is exactly its layout's;
# this variant takes more, for a launch padded to one block an SM
PADDED = {"padded launch": [("return bytes == smem && bytes <= kSmemLimit;",
                             "return bytes <= smem && smem <= kSmemLimit;")]}
# more than half an SM's 228 KB of shared memory: one block an SM
ONE_BLOCK_SMEM = 117 * 1024
K8_PARTS = {"whole row": [("const int lim = len;", "const int lim = T;")],
            "division": [("o[e] = v[i][e] * inv;",
                          "o[e] = v[i][e] / denom;")],
            "accurate exp": [("? __expf(v[i][e] - m) : 0.f;",
                              "? expf(v[i][e] - m) : 0.f;")]}
K8_VARIANTS = {"base": [], "whole row": ["whole row"],
               "division": ["division"], "accurate exp": ["accurate exp"]}
ITERS = {8: 5, 128: 10}


def variant_sources(path, parts_table, variants):
    with open(path) as f:
        src = f.read()
    out = {}
    for name, parts in variants.items():
        text = src
        for part in parts:
            for old, new in parts_table[part]:
                if old not in text:
                    raise ValueError("k6_ablation: %r no longer matches %s; "
                                     "update the parts table" % (old, path))
                text = text.replace(old, new)
        out[name] = text
    return out


def build_all(ck, tmp, sources):
    """nvcc every source at once into tmp; {name: ctypes library}."""
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(tmp, "v%d.cu" % i)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-shared", path, "-o",
             path[:-3] + ".so"]), path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise SystemExit("k6_ablation: nvcc failed for %s" % name)
        libs[name] = ctypes.CDLL(so)
    return libs


def graph_ms(torch, fn, iters, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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


def occupancy(lib, cs, rg, resident, smem):
    """The clusters of this shape the card runs at once (0: refused)."""
    n = ctypes.c_int(0)
    err = lib.ptt_fused_lstm_max_clusters(cs, rg, int(resident), smem,
                                          ctypes.byref(n))
    return n.value if err == 0 else 0


def active_clusters(lib, plan):
    return occupancy(lib, plan["cs"], plan["rg"], plan["resident"],
                     plan["smem"])


def describe(plan):
    """One line of a K6 launch plan."""
    return ("CS=%d R=%d clusters=%d grid=%d ks=%d rg=%d smem=%d %s%s "
            "waves=%d" % (plan["cs"], plan["rows"], plan["clusters"],
                          plan["grid"], plan["ks"], plan["rg"], plan["smem"],
                          "resident" if plan["resident"] else "streamed",
                          " prefetch" if plan["prefetch"] else "",
                          plan["waves"]))


def run_k6(torch, ck, libs):
    """The plan sweep, the residency and the parts at both shapes. Returns
    {(B, T): {"default": ms, "plans": {(cs, R): ms}, "residency": {name:
    ms}, "parts": {variant: ms}}}."""
    lib = libs["base"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b, t in SHAPES:
        x = torch.randn((b, t, 4 * D), generator=g, device="cuda") * 0.5
        w = torch.randn((D, 4 * D), generator=g, device="cuda") * 0.1
        bias = torch.randn((4 * D,), generator=g, device="cuda") * 0.1
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        iters = ITERS[b]
        default = ck.lstm_plan_on_card(lib, b, D, x.device)

        def timed(use_lib, plan):
            return graph_ms(torch, lambda: ck._launch_lstm(
                use_lib, plan, x, w, bias, None, None, lens, False), iters)

        res = {"default_plan": describe(default), "plans": {}, "parts": {}}
        res["default"] = timed(lib, default)
        print("k6_ablation: B=%d T=%d default plan %s: %.4f ms, %.3f us a "
              "step" % (b, t, describe(default), res["default"],
                        res["default"] * 1e3 / t), flush=True)
        for cs in (2, 4, 8, 16):
            for rows in (1, 2, 4, 8, 16, 32):
                if rows > b:
                    continue
                plan = ck.lstm_launch_plan(b, D, sms, cs=cs, rows=rows)
                at_once = active_clusters(lib, plan)
                if at_once < 1:
                    print("k6_ablation: B=%d CS=%d R=%d: the card runs no "
                          "such cluster" % (b, cs, rows))
                    continue
                ms = timed(lib, plan)
                res["plans"][(cs, rows)] = ms
                print("k6_ablation: B=%d T=%d plan %s (%d clusters, %d at "
                      "once): %.4f ms, %.3f us a step"
                      % (b, t, describe(plan), plan["clusters"], at_once, ms,
                         ms * 1e3 / t), flush=True)
        # residency: the default plan asks the occupancy at its own shared
        # memory, where its registers may already hold one block an SM;
        # against it the plan from a query padded to one block an SM,
        # launched at its own size and padded
        padded_query = ck.lstm_launch_plan(
            b, D, sms, active=lambda cs, rg, resident, smem: occupancy(
                lib, cs, rg, resident, max(smem, ONE_BLOCK_SMEM)))
        padded = dict(padded_query,
                      smem=max(padded_query["smem"], ONE_BLOCK_SMEM))
        res["residency"] = {
            "own size": res["default"],
            "padded query": timed(lib, padded_query),
            "padded query and launch": timed(libs["padded launch"], padded)}
        print("k6_ablation: B=%d T=%d residency: %d clusters at once at the "
              "plan's %d bytes, %d padded to %d; padded query's plan %s"
              % (b, t, active_clusters(lib, default), default["smem"],
                 occupancy(lib, default["cs"], default["rg"],
                           default["resident"], ONE_BLOCK_SMEM),
                 ONE_BLOCK_SMEM, describe(padded_query)))
        for name, ms in res["residency"].items():
            print("k6_ablation: B=%d T=%d residency %-24s %.4f ms, %.3f us "
                  "a step" % (b, t, name, ms, ms * 1e3 / t), flush=True)
        for name in VARIANTS:
            vlib = libs[name]
            ms = timed(vlib, default)
            res["parts"][name] = ms
            print("k6_ablation: B=%d T=%d %-22s %.4f ms, %.3f us a step"
                  % (b, t, name, ms, ms * 1e3 / t), flush=True)
        out[(b, t)] = res
        del x
    return out


def run_k8(torch, ck, libs):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    out = {}
    for n, t in K8_SHAPES:
        x = torch.randn((n, t), generator=g, device="cuda") * 3
        lens = torch.randint(1, t + 1, (n,), generator=g, device="cuda",
                             dtype=torch.int32)
        y = torch.empty_like(x)
        for name, lib in libs.items():
            for warps in (1, 2, 4, 8, 16):
                ms = graph_ms(torch, lambda lib=lib, warps=warps:
                              lib.ptt_masked_softmax_fwd(
                                  x.data_ptr(), x.stride(0), lens.data_ptr(),
                                  y.data_ptr(), n, t, warps,
                                  ck._stream_of(x)), 20, 7)
                out[(n, t, name, warps)] = ms
                print("k6_ablation: K8 x [%d, %d] %-16s %2d warps a block: "
                      "%.4f ms" % (n, t, name, warps, ms), flush=True)
        ms = graph_ms(torch, lambda: torch.softmax(x, 1), 20, 7)
        print("k6_ablation: K8 x [%d, %d] torch.softmax: %.4f ms"
              % (n, t, ms), flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("k6_ablation: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip().splitlines()[0] if out.stdout.strip()
          else "nvidia-smi printed nothing")
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="ptt_k6_ablation_")
    try:
        sources = {"k6 " + k: v for k, v in variant_sources(
            K6_SRC, {**PARTS, **PADDED},
            {**VARIANTS, "padded launch": ["padded launch"]}).items()}
        sources.update({"k8 " + k: v for k, v in variant_sources(
            K8_SRC, K8_PARTS, K8_VARIANTS).items()})
        libs = build_all(ck, tmp, sources)
        k6 = {}
        for name, lib in libs.items():
            if name.startswith("k6 "):
                ck._bind_lstm(lib)
                k6[name[3:]] = lib
            else:
                lib.ptt_masked_softmax_fwd.argtypes = [
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
                lib.ptt_masked_softmax_fwd.restype = ctypes.c_int
        run_k6(torch, ck, k6)
        run_k8(torch, ck, {name[3:]: lib for name, lib in libs.items()
                           if name.startswith("k8 ")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def floor_lib(ck, build_dir):
    """The "floor" variant of K6 built into build_dir and bound (for
    chip_smoke.py's K6 row)."""
    src = variant_sources(K6_SRC, PARTS, {"floor": VARIANTS["floor"]})
    lib = build_all(ck, build_dir, src)["floor"]
    ck._bind_lstm(lib)
    return lib


def step_floor_ms(torch, ck, lib, x, w, bias, lens, timer):
    """The floor variant's time on these inputs with the plan fused_lstm
    takes for them, timed by timer(torch, fn): one launch of T steps that
    only exchange h and pass the cluster barrier."""
    plan = ck.lstm_plan_on_card(ck.build(), x.shape[0], w.shape[0], x.device)
    return timer(torch, lambda: ck._launch_lstm(lib, plan, x, w, bias, None,
                                                None, lens, False))


if __name__ == "__main__":
    sys.exit(main())
