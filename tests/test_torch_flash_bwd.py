"""The arithmetic of the flash backward kernels (K2: dK, dV; K3: dQ) on the
CPU, where the CUDA kernels cannot run.

`csrc/flash_attention_bwd.cu` computes every product on the tensor cores
in 3xTF32: each fp32 operand x splits into hi = tf32_rna(x) and lo =
tf32_rna(x - hi), and a product is lo*hi + hi*lo + hi*hi in fp32
accumulators. These tests emulate that in torch (TF32 rounding to nearest,
ties away, on the float32 bits; products of TF32 values are exact in fp32,
so a float32 matmul of them adds as the accumulators do, in another order)
and hold the emulated backward against jax.vjp of the JAX package's flash
kernels (its dK/dV and dQ Pallas kernels in interpret mode) at T = 256,
D = 64, causal and not, with an empty and a ragged row:
- 3xTF32 agrees within 1e-5 of max(1, max |dX|) (chip_smoke.py's rel_err);
- plain TF32 (hi*hi alone) misses chip_smoke.py's KERNEL_TOL = 1e-4 there:
  the stated reason for the split.
Inputs are made with numpy from a seed and handed to both packages.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

B, T, H, D = 2, 256, 2, 64
LENS = [0, 201]          # an empty row and a ragged one
SPLIT_TOL = 1e-5         # 3xTF32 against the JAX kernels
KERNEL_TOL = 1e-4        # chip_smoke.py's bound for the card's kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32, and the kernel's integer form of it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, mode):
    """a @ b as the kernel computes it: "3xtf32" (lo*hi + hi*lo, then
    hi*hi) or "tf32" (hi*hi alone)."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    if mode == "tf32":
        return ahi @ bhi
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def emulated_bwd(q, k, v, g, lse, delta, kv_len, causal, mode):
    """(dq, dk, dv) [B, T, H, D] of the kernels' recompute with every
    product in `mode`: S = Q K^T, dP = G V^T, P = exp(S * scale - lse) on
    valid pairs (masked before the exponential), dS = P (dP - delta)
    scale, dV = P^T G, dK = dS^T Q, dQ = dS K."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, g))  # [B,H,T,D]
    s = product(qh, kh.transpose(-1, -2), mode) * scale
    valid = ck._valid_pairs(b, t, q.device, kv_len, causal)
    p = torch.where(valid, torch.exp(torch.where(valid, s - lse[..., None],
                                                 torch.zeros_like(s))),
                    torch.zeros_like(s))
    dp = product(gh, vh.transpose(-1, -2), mode)
    ds = p * (dp - delta[..., None]) * scale
    dv = product(p.transpose(-1, -2), gh, mode)
    dk = product(ds.transpose(-1, -2), qh, mode)
    dq = product(ds, kh, mode)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def rel_err(got, want):
    """chip_smoke.py's measure: max |got - want| over max(1, max |want|)."""
    return max(float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
               for g, w in zip(got, want))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, g, causal):
    def f(q, k, v):
        return pk.flash_attention(q, k, v, causal=causal,
                                  kv_len=jnp.asarray(LENS, jnp.int32),
                                  interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.fixture(scope="module", params=[False, True], ids=["full", "causal"])
def case(request):
    """One input, its JAX gradients and the emulated ones in both modes."""
    causal = request.param
    q, k, v, g = _inputs(40 + causal)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    lens = torch.tensor(LENS, dtype=torch.int32)
    out, lse = ck.flash_attention_fwd_plain(tq, tk, tv, lens, causal)
    delta = ck.flash_delta(tg, out)
    emu = {mode: [x.numpy() for x in emulated_bwd(tq, tk, tv, tg, lse, delta,
                                                  lens, causal, mode)]
           for mode in ("3xtf32", "tf32")}
    plain = [x.numpy() for x in ck.flash_attention_bwd_plain(
        tq, tk, tv, lse, delta, tg, lens, causal)]
    return dict(causal=causal, want=_jax_grads(q, k, v, g, causal), emu=emu,
                plain=plain)


def test_tf32_rounds_to_nearest_ties_away():
    """The rounding the kernel computes with two integer operations: 10
    mantissa bits kept, a tie (bit 12 set, the 12 below clear) away from
    zero, the low 13 bits cleared; and hi + lo carries 21 bits of x."""
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    x = torch.tensor([0x1000, 0x0FFF, 0x1001, 0x3000], dtype=torch.int32) \
        + one
    got = tf32(x.view(torch.float32)).view(torch.int32) - one
    assert got.tolist() == [0x2000, 0, 0x2000, 0x4000]
    neg = tf32(-x.view(torch.float32))
    assert torch.equal(neg, -tf32(x.view(torch.float32)))
    r = torch.from_numpy(np.random.RandomState(5).randn(4096)
                         .astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert float(((hi + lo - r).abs() / r.abs()).max()) < 2.0 ** -21


def test_split_tf32_backward_matches_the_jax_kernels(case):
    """3xTF32 within 1e-5 of the JAX kernels' vjp, and the empty row's
    gradients exactly 0 (masked before the exponential)."""
    for name, got, want in zip("qkv", case["emu"]["3xtf32"], case["want"]):
        assert got.shape == want.shape
        assert rel_err([got], [want]) <= SPLIT_TOL, "d" + name
        assert np.all(got[0] == 0.0), "d" + name


def test_split_tf32_backward_matches_the_plain_version(case):
    """... and within 1e-5 of the port's plain version, which the card's
    kernels are held to."""
    assert rel_err(case["emu"]["3xtf32"], case["plain"]) <= SPLIT_TOL


def test_plain_tf32_backward_misses_the_kernel_tolerance(case):
    """hi*hi alone (plain TF32) lands beyond KERNEL_TOL of the JAX
    kernels: why the kernels split every operand."""
    assert rel_err(case["emu"]["tf32"], case["want"]) > KERNEL_TOL
    # and 3xTF32 is at least ten times closer
    assert rel_err(case["emu"]["3xtf32"], case["want"]) * 10 < \
        rel_err(case["emu"]["tf32"], case["want"])


def test_the_kernel_source_splits_its_products_and_copies_asynchronously():
    """What the CPU cannot run, read from the source: tensor-core TF32
    products, cp.async copies, no atomics, and the rounding emulated
    above."""
    import os
    with open(os.path.join(ck.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        src = f.read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cp.async.cg.shared.global" in src
    assert "cp.async.wait_group" in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code and "atom." not in code
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in src


def test_the_variant_script_still_matches_the_source():
    """flash_bwd_variants.py replaces text of the kernel source literally:
    each must be there, or the script times nothing."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import flash_bwd_variants
    finally:
        sys.path.remove(root)
    with open(os.path.join(root, flash_bwd_variants.SRC)) as f:
        src = f.read()
    for name, edits in flash_bwd_variants.VARIANTS.items():
        for old, new in edits:
            assert old in src and new not in src, (name, old)
