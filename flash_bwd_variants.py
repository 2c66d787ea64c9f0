#!/usr/bin/env python3
"""Why the flash backward kernels (K2: dK/dV, K3: dQ) are built as they
are: time design alternatives of paddle_tpu_torch/csrc/flash_attention_bwd.cu
beside it on one NVIDIA card.

    python3 flash_bwd_variants.py [--baseline SRC]

Each variant is the source with lines replaced (VARIANTS), built by nvcc
into a temporary directory and called through the port's C interface
(chip_smoke.flash_bwd_baseline). Every variant computes the same
gradients: each is held to flash_attention_bwd_plain within chip_smoke's
KERNEL_TOL before it is timed. `--baseline SRC` (default: `git show
0ba7d56:<source>` when the checkout has its history) adds the fp32
CUDA-core kernels that the tensor-core ones replaced. Shapes: the
Transformer training step's q, k, v, g [32, 256, 8, 64], full lengths,
without and with the causal mask. Times: chip_smoke.time_ms (a CUDA graph
of 20 calls, median of 7 replays), every variant twice, in turns.
"""
import argparse
import sys
import tempfile

import chip_smoke as cs

SRC = cs.FLASH_BWD_SRC
# variant -> [(text of the source, the text that replaces every copy)]
VARIANTS = {
    # TF32 rounding by the conversion instruction instead of integer ops
    "cvt.rna.tf32 rounding": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;")],
    # 64 streamed rows a tile (32 at D = 128) instead of 32
    "64 streamed rows": [(
        "  static constexpr int BC = 32;",
        "  static constexpr int BC = (D == 128) ? 32 : 64;")],
    # the grid's tiles inside each head, ascending (the earlier order)
    "tiles inside each head": [
        ("const int bh = blockIdx.x;", "const int bh = blockIdx.y;"),
        ("blockIdx.y * kRows", "blockIdx.x * kRows"),
        ("(gridDim.y - 1 - blockIdx.y) * kRows", "blockIdx.x * kRows"),
        ("dim3 grid(B * H, (T + kRows - 1) / kRows);",
         "dim3 grid((T + kRows - 1) / kRows, B * H);")],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="SRC",
                    help="the fp32 CUDA-core flash_attention_bwd.cu to time "
                    "beside the variants")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck

    print(cs.card_line())
    with open(SRC) as f:
        source = f.read()
    texts = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            cs.check(old in text, "variant %r: %r is not in %s"
                     % (name, old, SRC))
            text = text.replace(old, new)
        texts[name] = text
    base = cs.baseline_source(args.baseline, cs.FLASH_BWD_BASELINE_COMMIT,
                              SRC)
    if base is not None:
        texts["%s (fp32 CUDA cores)" % cs.FLASH_BWD_BASELINE_COMMIT] = base
    fns = {"current": (ck.flash_attention_bwd_dkdv,
                       ck.flash_attention_bwd_dq)}
    for name, text in texts.items():
        fns[name] = cs.flash_bwd_baseline(torch, ck, text, tempfile.mkdtemp(
            prefix="ptt_flash_variant_"))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    b, t, h, d = (cs.TRAIN_BATCH, cs.MODEL["max_length"], cs.MODEL["n_head"],
                  cs.MODEL["d_key"])
    for causal in (False, True):
        q, k, v, g = (torch.randn((b, t, h, d), generator=gen, device=dev)
                      for _ in range(4))
        kv = torch.full((b,), t, dtype=torch.int32, device=dev)
        out, lse = ck.flash_attention_fwd(q, k, v, kv, causal)
        delta = ck.flash_delta(g, out)
        args_ = (q, k, v, lse, delta, g, kv, causal)
        ref = ck.flash_attention_bwd_plain(*args_)
        times = {name: ([], []) for name in fns}
        for name, (dkdv, dq) in fns.items():
            got = tuple(dkdv(*args_))
            got_q = dq(*args_)
            got_q = got_q if isinstance(got_q, tuple) else (got_q,)
            torch.cuda.synchronize()
            err = max(cs.rel_err(got, ref[1:]), cs.rel_err(got_q, ref[:1]))
            cs.check(err <= cs.KERNEL_TOL, "variant %r disagrees with the "
                     "plain version by %r" % (name, err))
        for _ in range(2):
            for name, (dkdv, dq) in fns.items():
                times[name][0].append(cs.time_ms(torch, lambda: dkdv(*args_)))
                times[name][1].append(cs.time_ms(torch, lambda: dq(*args_)))
        for name, (t2, t3) in times.items():
            print("flash_bwd_variants: [%d,%d,%d,%d] causal=%s %-32s K2 %s "
                  "ms, K3 %s ms, sum %.4f ms"
                  % (b, t, h, d, causal, name,
                     " / ".join("%.4f" % x for x in t2),
                     " / ".join("%.4f" % x for x in t3),
                     sum(t2) / len(t2) + sum(t3) / len(t3)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
