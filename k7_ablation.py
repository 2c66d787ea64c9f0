#!/usr/bin/env python3
"""Where K7's time goes: time the fused-LSTMP kernel with parts of each
step switched off, on one NVIDIA card.

    python3 k7_ablation.py

Each variant is paddle_tpu_torch/csrc/fused_lstmp_fwd.cu with a few lines
replaced (the grid barriers by block barriers, a loop by an empty one),
built by nvcc into a temporary directory and launched through the same C
interface and launch plan as the port's wrapper, at the acoustic path's
x [8, 512, 4096] and [32, 512, 4096] (D 1024, P 512, full lengths). The
variants compute wrong results: only their times mean anything, and a
part's cost is read as base minus the variant without it (the parts
overlap across blocks, so the differences need not add up). Times are
CUDA events around 5 back-to-back launches, the median of 5 repeats.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

SRC = "paddle_tpu_torch/csrc/fused_lstmp_fwd.cu"
D, P, T = 1024, 512, 512

# (what is switched off, the line as it is, the line that replaces it)
PARTS = {
    "barriers": [
        ("grid_barrier(count, target);  // h_new complete",
         "__syncthreads();"),
        ("if (k + 1 < T) grid_barrier(count, target);  // r complete",
         "__syncthreads();")],
    "A: r staging": [
        ("for (int i = tid; i < Pp * rv4; i += kThreads) {",
         "for (int i = tid; i < 0; i += kThreads) {")],
    "A: gate product": [
        ("      if (ks < KS) {\n        float acc",
         "      if (ks < 0) {\n        float acc")],
    "A: slice sums": [
        ("for (int i = tid; i < nb * nc; i += kThreads) {",
         "for (int i = tid; i < 0; i += kThreads) {")],
    "A: cell update": [
        ("for (int i = tid; i < nb * nu; i += kThreads) {",
         "for (int i = tid; i < 0; i += kThreads) {")],
    "B: h staging": [
        ("for (int i = tid; i < nbh * dv; i += kThreads)\n"
         "        cp_async16_cg(h_s",
         "for (int i = tid; i < 0; i += kThreads)\n"
         "        cp_async16_cg(h_s")],
    "B: projection": [
        ("          for (int i = sd; i < dv; i += sdn) {",
         "          for (int i = sd; i < 0; i += sdn) {")],
}
_A = ["A: r staging", "A: gate product", "A: slice sums", "A: cell update"]
_B = ["B: h staging", "B: projection"]
# variant name -> the parts it switches off
VARIANTS = {
    "base": [],
    **{"no " + part: [part] for part in PARTS},
    "phase A alone": ["barriers"] + _B,
    "phase B alone": ["barriers"] + _A,
    "barriers alone": _A + _B,
}


def build(ck, tmp):
    with open(SRC) as f:
        src = f.read()
    procs = {}
    for name, parts in VARIANTS.items():
        text = src
        for part in parts:
            for old, new in PARTS[part]:
                if old not in text:
                    raise SystemExit("k7_ablation: %r no longer matches %s; "
                                     "update PARTS" % (old, SRC))
                text = text.replace(old, new)
        path = os.path.join(tmp, "v%d.cu" % len(procs))
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-shared", path, "-o",
             path[:-3] + ".so"]), path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise SystemExit("k7_ablation: nvcc failed for %s" % name)
        lib = ctypes.CDLL(so)
        ck._bind_lstmp(lib)
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip().splitlines()[0] if out.stdout.strip()
          else "nvidia-smi printed nothing")
    tmp = tempfile.mkdtemp(prefix="ptt_k7_ablation_")
    try:
        libs = build(ck, tmp)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b in (8, 32):
            x = torch.randn((b, T, 4 * D), generator=g, device="cuda") * 0.5
            w = torch.randn((P, 4 * D), generator=g, device="cuda") * 0.05
            wp = torch.randn((D, P), generator=g, device="cuda") * 0.04
            bias = torch.randn((4 * D,), generator=g, device="cuda") * 0.1
            lens = torch.full((b,), T, dtype=torch.int32, device="cuda")
            plan = ck.lstmp_launch_plan(b, D, P, sms)
            for name, lib in libs.items():
                def launch(lib=lib):
                    ck._launch_lstmp(lib, plan, x, w, wp, bias, None, None,
                                     lens, False)
                for _ in range(2):
                    launch()
                torch.cuda.synchronize()
                times = []
                for _ in range(5):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(5):
                        launch()
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1) / 5)
                ms = statistics.median(times)
                print("k7_ablation: B=%d %-18s %.4f ms  %.2f us a step"
                      % (b, name, ms, ms * 1e3 / T), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
