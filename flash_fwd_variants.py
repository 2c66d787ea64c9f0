#!/usr/bin/env python3
"""Why the flash forward kernel (K1) is built as it is: time design
alternatives of paddle_tpu_torch/csrc/flash_attention_fwd.cu beside it on
one NVIDIA card.

    python3 flash_fwd_variants.py [--baseline SRC]

Each variant is the source with lines replaced (VARIANTS), built by nvcc
into a temporary directory and called through the port's C interface
(chip_smoke.flash_fwd_baseline). Every variant computes the same
attention: each is held to flash_attention_fwd_plain within chip_smoke's
KERNEL_TOL before it is timed. `--baseline SRC` (default: `git show
db823af:<source>` when the checkout has its history) adds the fp32
CUDA-core kernel that the tensor-core one replaced. Shapes: the serving
batch q, k, v [8, 256, 8, 64] with ragged lengths, and the Transformer
training step's [32, 256, 8, 64] at full lengths without and with the
causal mask. Times: chip_smoke.time_ms (a CUDA graph of 20 calls, median
of 7 replays), every variant twice, in turns.
"""
import argparse
import sys
import tempfile

import chip_smoke as cs

SRC = cs.FLASH_SRC
# variant -> [(text of the source, the text that replaces every copy)]
VARIANTS = {
    # eight warps: 128 query rows a block instead of 64
    "128 query rows, 8 warps": [(
        "constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    # 64 streamed keys a tile (32 at D = 128) instead of 32
    "64 keys a tile": [(
        "  static constexpr int BC = 32;",
        "  static constexpr int BC = (D == 128) ? 32 : 64;")],
    # TF32 rounding by the conversion instruction instead of integer ops
    "cvt.rna.tf32 rounding": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;")],
    # the hardware's approximate exponential for p (what the softmax's
    # exponentials cost)
    "__expf for p": [(
        "valid(n, i) ? expf(sa[n][i] - m_r[i >> 1]) : 0.f",
        "valid(n, i) ? __expf(sa[n][i] - m_r[i >> 1]) : 0.f")],
    # the grid's query tiles inside each head, ascending
    "tiles inside each head": [
        ("const int bh = blockIdx.x;", "const int bh = blockIdx.y;"),
        ("(gridDim.y - 1 - blockIdx.y) * kRows", "blockIdx.x * kRows"),
        ("dim3 grid(B * H, (T + kRows - 1) / kRows);",
         "dim3 grid((T + kRows - 1) / kRows, B * H);")],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="SRC",
                    help="the fp32 CUDA-core flash_attention_fwd.cu to time "
                    "beside the variants")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA card", file=sys.stderr)
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
    base = cs.baseline_source(args.baseline, cs.FLASH_FWD_BASELINE_COMMIT,
                              SRC)
    if base is not None:
        texts["%s (fp32 CUDA cores)" % cs.FLASH_FWD_BASELINE_COMMIT] = base
    fns = {"current": ck.flash_attention_fwd}
    for name, text in texts.items():
        fns[name] = cs.flash_fwd_baseline(torch, ck, text, tempfile.mkdtemp(
            prefix="ptt_flash_variant_"))

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for what, (b, t, h, d, lens), causal in cs.flash_timing_shapes():
        q, k, v = cs.flash_inputs(torch, gen, b, t, h, d, False, 3)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = ck.flash_attention_fwd_plain(q, k, v, kv, causal)
        for name, fn in fns.items():
            got = fn(q, k, v, kv, causal)
            torch.cuda.synchronize()
            err = max((a - r).abs().max().item() for a, r in zip(got, ref))
            cs.check(err <= cs.KERNEL_TOL, "variant %r disagrees with the "
                     "plain version by %r" % (name, err))
        times = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                times[name].append(cs.time_ms(
                    torch, lambda fn=fn: fn(q, k, v, kv, causal)))
        for name, runs in times.items():
            print("flash_fwd_variants: %s [%d,%d,%d,%d] causal=%s %-28s K1 "
                  "%s ms, mean %.4f ms"
                  % (what, b, t, h, d, causal, name,
                     " / ".join("%.4f" % x for x in runs),
                     sum(runs) / len(runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
