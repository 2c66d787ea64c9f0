#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --ptxas         # also print nvcc's `ptxas -v`

Transformer-base runs at its full depth (6+6 layers) and width, with random
weights from the fixed seed SEED.

Phases, each reported on lines of its own; any failure exits non-zero:

1. device   — refuse to run without CUDA; print the card's name and power
              limit as nvidia-smi reports them.
2. build    — compile the hand-written kernels from paddle_tpu_torch/csrc
              (nvcc, one process per source) and report the seconds.
3. kernels  — hold each kernel against its plain PyTorch version on the
              card at the main path's shapes (max |kernel - plain| <= 1e-4:
              fp32 with a different summation order), and time the kernel,
              the plain version and one library call computing the same
              function (CUDA graph of 20 calls, CUDA events, warmup,
              median), beside the least time the card could take (bound).
4. serving  — the main path: build Transformer-base scoring (vocab 30000,
              d_model 512, 8 heads, 6+6 layers, d_inner 2048, T=256) with
              the port's layers, run its startup program on the card from
              a seed, save it with save_inference_model, serve it with
              InferenceEngine(batch_buckets=[1, 4, 8]) and answer 16
              concurrent requests (source and target lengths 32-256).
              Checks: every answer finite; each equals run_direct at the
              bucket its future recorded (<= 1e-5); one answer matches a
              CPU run of the same saved model (plain versions, atol 1e-3);
              the flash and layer-norm kernels launched exactly once per
              fused_attention / layer_norm op of every engine dispatch.

The last lines are one JSON object listing every kernel, the card line,
and `{"ok": true, "device": {...}}`.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# published peaks (NVIDIA data sheets): fp32 outside the tensor cores in
# FLOP/s, device memory in bytes/s
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H100", 67e12, 3.35e12), ("H200", 67e12, 4.8e12))
KERNEL_TOL = 1e-4       # fp32, different summation order than the plain
BUCKET_TOL = 1e-5       # coalesced vs run_direct at the same bucket
CPU_TOL = 1e-3          # card vs CPU through 12 fp32 layers
SEED = 0                # weights, kernel inputs and requests
N_LAYER = 6             # encoder and decoder depth of Transformer-base

# the main path's model: Transformer-base (bench.py's configuration)
MODEL = dict(vocab=30000, max_length=256, d_model=512, n_head=8, d_key=64,
             d_inner=2048)

FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
LN_SRC = "paddle_tpu_torch/csrc/layer_norm_fwd.cu"
FLASH_TPU = "paddle_tpu/ops/pallas_kernels.py:64 (_flash_fwd_kernel, " \
    "launched by _flash_fwd :116)"
LN_TPU = "paddle_tpu/ops/pallas_kernels.py:451 (_ln_kernel, launched by " \
    "_ln_fwd_call :464)"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    """`name, power.limit` of the first card, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi unavailable (%s)" % e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "nvidia-smi printed nothing"


def peaks_for(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    return PEAKS[2][1], PEAKS[2][2]


def time_ms(torch, fn, iters=20, reps=7):
    """Device time of one call, in ms: `iters` calls captured in one CUDA
    graph (so the host's launch cost is not in the number), the graph
    replayed `reps` times after warmup and timed by CUDA events; the median
    over replays, divided by `iters`. Inputs stay in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
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


def eager_ms(torch, fn, iters=20, reps=7):
    """Time of one call as a Python caller sees it back to back (host
    launch cost included): CUDA events around `iters` eager calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def bound(flops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --------------------------------------------------------------- kernels --

def flash_work(b, t, h, d, lens, causal):
    """(flops, bytes) this input needs: 4*D flops per valid (query, key)
    pair; q read, k/v rows below each length read, out and lse written."""
    pairs = 0
    for n in lens:
        n = max(0, min(int(n), t))
        if causal:
            pairs += sum(min(n, q + 1) for q in range(t))
        else:
            pairs += n * t
    valid_rows = sum(max(0, min(int(n), t)) for n in lens)
    nbytes = 4 * (b * t * h * d            # q
                  + 2 * valid_rows * h * d  # k, v rows that matter
                  + b * t * h * d           # out
                  + b * h * t               # lse
                  + b)                      # kv_len
    return 4 * d * pairs * h, nbytes


def run_kernels(torch, ck, peak_flops, peak_bw):
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    results = {}

    # K1: flash attention forward
    flash_err = 0.0
    cases = [(8, 256, 8, 64, [256, 0, 37, 129, 200, 64, 255, 96]),
             (2, 40, 2, 16, [17, 0])]
    main_inputs = None
    for b, t, h, d, lens in cases:
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   for _ in range(3))
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        for causal in (False, True):
            for kv_len in (kv, None):
                out, lse = ck.flash_attention_fwd(q, k, v, kv_len, causal)
                ref, ref_lse = ck.flash_attention_fwd_plain(q, k, v, kv_len,
                                                            causal)
                torch.cuda.synchronize()
                err = max((out - ref).abs().max().item(),
                          (lse - ref_lse).abs().max().item())
                print("kernels: flash B=%d T=%d H=%d D=%d causal=%s "
                      "kv_len=%s max_abs_err=%.3e"
                      % (b, t, h, d, causal,
                         "ragged" if kv_len is not None else "full", err))
                check(np.isfinite(err) and err <= KERNEL_TOL,
                      "flash_attention_fwd disagrees with its plain version "
                      "by %r (tolerance %r)" % (err, KERNEL_TOL))
                flash_err = max(flash_err, err)
        if main_inputs is None:
            main_inputs = (q, k, v, kv, lens)
    q, k, v, kv, lens = main_inputs
    b, t, h, d = q.shape
    mask = (torch.arange(t, device=dev)[None, :]
            < kv.long()[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flops, nbytes = flash_work(b, t, h, d, lens, False)
    bms, bby = bound(flops, nbytes, peak_flops, peak_bw)
    c_flops, c_bytes = flash_work(b, t, h, d, lens, True)
    c_bms, _ = bound(c_flops, c_bytes, peak_flops, peak_bw)
    results["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU,
        "shape": "q,k,v [%d,%d,%d,%d] fp32, kv_len %s" % (b, t, h, d, lens),
        "max_abs_err": flash_err,
        "ms": time_ms(torch, lambda: ck.flash_attention_fwd(q, k, v, kv)),
        "plain_ms": time_ms(
            torch, lambda: ck.flash_attention_fwd_plain(q, k, v, kv)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        "bound_ms": bms, "bound_by": bby,
        "causal_ms": time_ms(
            torch, lambda: ck.flash_attention_fwd(q, k, v, kv, True)),
        "causal_plain_ms": time_ms(
            torch, lambda: ck.flash_attention_fwd_plain(q, k, v, kv, True)),
        "causal_bound_ms": c_bms,
        "eager_ms": eager_ms(
            torch, lambda: ck.flash_attention_fwd(q, k, v, kv)),
    }

    # K5: layer norm forward
    n, dm = 2048, 512
    x = torch.randn((n, dm), generator=g, device=dev)
    sc = torch.randn((dm,), generator=g, device=dev)
    bi = torch.randn((dm,), generator=g, device=dev)
    y, mean, var = ck.layer_norm_fwd(x, sc, bi, 1e-5)
    ry, rmean, rvar = ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)
    torch.cuda.synchronize()
    ln_err = max((y - ry).abs().max().item(),
                 (mean - rmean).abs().max().item(),
                 (var - rvar).abs().max().item())
    print("kernels: layer_norm N=%d D=%d max_abs_err=%.3e" % (n, dm, ln_err))
    check(np.isfinite(ln_err) and ln_err <= KERNEL_TOL,
          "layer_norm_fwd disagrees with its plain version by %r" % ln_err)
    bms, bby = bound(8 * n * dm, 4 * (2 * n * dm + 2 * dm + 2 * n),
                     peak_flops, peak_bw)
    results["layer_norm_fwd"] = {
        "name": "layer_norm_fwd", "route": "cuda", "source": LN_SRC,
        "replaces": LN_TPU, "shape": "x [%d,%d] fp32" % (n, dm),
        "max_abs_err": ln_err,
        "ms": time_ms(torch, lambda: ck.layer_norm_fwd(x, sc, bi, 1e-5)),
        "plain_ms": time_ms(
            torch, lambda: ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)),
        "library_ms": time_ms(
            torch, lambda: F.layer_norm(x, (dm,), sc, bi, 1e-5)),
        "bound_ms": bms, "bound_by": bby,
        "eager_ms": eager_ms(
            torch, lambda: ck.layer_norm_fwd(x, sc, bi, 1e-5)),
    }
    for r in results.values():
        print("kernels: %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
              "bound_ms=%.4f (%s) eager_ms=%.4f"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"], r["eager_ms"]))
    return results


# --------------------------------------------------------------- serving --

def run_serving(torch, card, n_layer=N_LAYER):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import InferenceEngine

    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        predict = transformer.transformer(
            vocab, vocab, t_max, n_layer=n_layer, n_head=MODEL["n_head"],
            d_key=MODEL["d_key"], d_value=MODEL["d_key"],
            d_model=MODEL["d_model"], d_inner_hid=MODEL["d_inner"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("serving: built Transformer-base scoring (%d+%d layers, %d "
          "parameters) and ran its startup program on %s in %.1f s"
          % (n_layer, n_layer, n_params, exe.device,
             time.perf_counter() - t0))

    rng = np.random.RandomState(SEED)
    requests = []
    for _ in range(16):
        s = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        tg = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        requests.append(transformer.prepare_batch([s], [tg], t_max))

    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        t0 = time.perf_counter()
        program = fluid.io.save_inference_model(
            model_dir, transformer.SCORING_FEED_NAMES, [predict], exe, main,
            scope=scope)
        del scope
        ops = program.global_block().ops
        n_flash = sum(op.type == "fused_attention" for op in ops)
        n_ln = sum(op.type == "layer_norm" and bool(op.inputs.get("Scale"))
                   and bool(op.inputs.get("Bias")) for op in ops)
        print("serving: saved the inference model (%d ops: %d "
              "fused_attention, %d layer_norm) in %.1f s"
              % (len(ops), n_flash, n_ln, time.perf_counter() - t0))
        # per layer pair: encoder self, decoder causal self and cross
        # attention; 2 encoder + 3 decoder layer norms, plus the two final
        # ones (18 and 32 at 6+6 layers)
        check(n_flash == 3 * n_layer and n_ln == 5 * n_layer + 2,
              "the scoring program has %d fused_attention and %d layer_norm "
              "ops, expected %d and %d"
              % (n_flash, n_ln, 3 * n_layer, 5 * n_layer + 2))

        t0 = time.perf_counter()
        engine = InferenceEngine(model_dir, batch_buckets=[1, 4, 8])
        torch.cuda.synchronize()
        print("serving: engine loaded and warmed up in %.1f s"
              % (time.perf_counter() - t0))
        try:
            answers, latencies, futures = [None] * 16, [None] * 16, \
                [None] * 16
            errors = []
            barrier = threading.Barrier(16)

            def client(i):
                try:
                    barrier.wait()
                    ts = time.perf_counter()
                    fut = engine.submit(requests[i])
                    answers[i] = fut.result(600).numpy()[predict.name]
                    latencies[i] = time.perf_counter() - ts
                    futures[i] = fut
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

            # the counts: zero just before the main path, read just after
            ck.reset_launch_counts()
            batches0 = engine.metrics.snapshot()["batches_total"]
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(16)]
            tw = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - tw
            counts = ck.launch_counts()
            snap = engine.metrics.snapshot()
            check(not any(th.is_alive() for th in threads),
                  "a client thread did not finish")
            check(not errors, "requests failed: %s" % errors)
            batches = snap["batches_total"] - batches0
            print("serving: launches %s over %d engine dispatches"
                  % (counts, batches))
            check(counts["flash_attention_fwd"] == n_flash * batches,
                  "flash kernel launched %d times, expected %d x %d"
                  % (counts["flash_attention_fwd"], n_flash, batches))
            check(counts["layer_norm_fwd"] == n_ln * batches,
                  "layer-norm kernel launched %d times, expected %d x %d"
                  % (counts["layer_norm_fwd"], n_ln, batches))

            for i, a in enumerate(answers):
                check(a.shape == (1, t_max, vocab) and np.isfinite(a).all(),
                      "answer %d: shape %s, finite=%s"
                      % (i, a.shape, np.isfinite(a).all()))
            bucket_diff = 0.0
            for i, fut in enumerate(futures):
                direct, _ = engine.run_direct(requests[i],
                                              batch_bucket=fut.bucket[0])
                bucket_diff = max(bucket_diff, float(np.abs(
                    direct[predict.name] - answers[i]).max()))
            print("serving: coalesced vs run_direct at the same bucket: "
                  "max diff %.3e (buckets %s)"
                  % (bucket_diff, sorted(set(f.bucket[0] for f in futures))))
            check(bucket_diff <= BUCKET_TOL,
                  "coalesced answers differ from run_direct by %r"
                  % bucket_diff)
        finally:
            engine.close()

        t0 = time.perf_counter()
        cpu = InferenceEngine(model_dir, device="cpu", batch_buckets=[1],
                              warmup=False)
        try:
            ref = cpu.run_direct(requests[0])[0][predict.name]
        finally:
            cpu.close()
        cpu_diff = float(np.abs(ref - answers[0]).max())
        print("serving: request 0 on the card vs on the CPU (plain "
              "versions, same weights): max diff %.3e (%.1f s)"
              % (cpu_diff, time.perf_counter() - t0))
        check(cpu_diff <= CPU_TOL, "card and CPU disagree by %r" % cpu_diff)

    trg_tokens = int(sum(int(r["trg_len"].sum()) for r in requests))
    lat_ms = sorted(x * 1e3 for x in latencies)
    serving = {
        "requests": 16, "batches": batches,
        "occupancy": snap["mean_batch_occupancy"],
        "row_utilization": snap["row_utilization"],
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "wall_s": wall, "scored_tokens": trg_tokens,
        "scored_tokens_per_s": trg_tokens / wall,
        "bucket_max_diff": bucket_diff, "cpu_max_diff": cpu_diff,
        "card": card,
    }
    print("serving: " + json.dumps(serving))
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("all", "kernels"), default="all")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register/shared-memory report")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks_for(name)
    print("device: %s | torch %s, CUDA %s | peaks used for bounds: %.0f "
          "TFLOP/s fp32, %.2f TB/s" % (card, torch.__version__,
                                       torch.version.cuda, peak_flops / 1e12,
                                       peak_bw / 1e12))

    t0 = time.perf_counter()
    ck.build(verbose=args.ptxas)
    print("build: %s in %.1f s" % (os.path.relpath(ck.build_info.path),
                                   time.perf_counter() - t0))
    if args.ptxas:
        print(ck.build_info.log)

    kernels = run_kernels(torch, ck, peak_flops, peak_bw)
    counts = {}
    if args.only == "all":
        counts = run_serving(torch, card)
        for kname, r in kernels.items():
            r["launches"] = counts[kname]
            check(r["launches"] > 0, "%s never launched on the main path"
                  % kname)
    for r in kernels.values():
        r.setdefault("launches", None)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    if args.only == "all":
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
