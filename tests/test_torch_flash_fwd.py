"""The arithmetic of the flash forward kernel (K1) on the CPU, where the
CUDA kernel cannot run.

`csrc/flash_attention_fwd.cu` computes both products (S = (Q * scale)
K^T and O += P V) on the tensor cores in 3xTF32: each fp32 operand x
splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a product is
lo*hi + hi*lo + hi*hi in fp32 accumulators. Between them runs the online
softmax, one key tile at a time. These tests emulate that walk in torch
(TF32 rounding to nearest, ties away, on the float32 bits; products of
TF32 values are exact in fp32, so a float32 matmul of them adds as the
accumulators do, in another order), over tiles of 32 keys (the kernel's)
and of 64, and hold it against the JAX package's Pallas forward in
interpret mode at T = 256, D = 64, causal and not, with an empty and a
ragged row:
- 3xTF32 agrees within 1e-5 on out and lse, and the empty row is out 0,
  lse -1e30 + log(1e-30) exactly (masked before the exponential);
- plain TF32 (hi*hi alone) misses chip_smoke.py's KERNEL_TOL = 1e-4 there:
  the stated reason for the split.
Inputs are made with numpy from a seed and handed to both packages.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

B, T, H, D = 2, 256, 2, 64
LENS = [0, 201]          # an empty row and a ragged one
SPLIT_TOL = 1e-5         # 3xTF32 against the JAX kernel
KERNEL_TOL = 1e-4        # chip_smoke.py's bound for the card's kernels
NEG = -1e30              # the masked score and the empty row's max


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


def emulated_fwd(q, k, v, kv_len, causal, mode, tile):
    """(out [B, T, H, D], lse [B, H, T]) of the kernel's walk with every
    product in `mode`: Q * scale split once, then per key tile S = Q K^T,
    invalid pairs set to -1e30 and their p to 0 (a select before the
    exponential), m_new = max(m, row max), the old sums rescaled by
    exp(m - m_new), l += sum p, O += P V; last out = O / max(l, 1e-30)
    and lse = m + log(max(l, 1e-30))."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    qs = qh * scale
    qpos = torch.arange(t)[:, None]
    lens = kv_len.reshape(b, 1, 1, 1).long()
    m = torch.full((b, h, t, 1), NEG)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    for k0 in range(0, t, tile):
        kpos = torch.arange(k0, min(k0 + tile, t))[None, :]
        valid = kpos[None, None] < lens
        if causal:
            valid = valid & (kpos <= qpos)[None, None]
        s = product(qs, kh[:, :, k0:k0 + tile].transpose(-1, -2), mode)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + product(p, vh[:, :, k0:k0 + tile], mode)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (o / l_safe).transpose(1, 2), (m + torch.log(l_safe))[..., 0]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _jax_fwd(q, k, v, causal):
    """(out [B, T, H, D], lse [B, H, T]) of the JAX package's Pallas
    forward in interpret mode at its default 128-row blocks."""
    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D)

    lens = jnp.asarray(np.repeat(LENS, H).astype(np.int32))
    out, lse = pk._flash_fwd(to_bh(q), to_bh(k), to_bh(v), lens,
                             1.0 / math.sqrt(D), causal, 128, 128, True)
    out = np.asarray(out).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    return out, np.asarray(lse).reshape(B, H, T)


def _err(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


@pytest.fixture(scope="module", params=[False, True], ids=["full", "causal"])
def case(request):
    """One input, the JAX kernel's out and lse, the plain version's, and
    the emulated ones in both modes over 32- and 64-key tiles."""
    causal = request.param
    q, k, v = _inputs(50 + causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lens = torch.tensor(LENS, dtype=torch.int32)
    emu = {(mode, tile): [x.numpy() for x in emulated_fwd(
        tq, tk, tv, lens, causal, mode, tile)]
        for mode in ("3xtf32", "tf32") for tile in (32, 64)}
    plain = [x.numpy() for x in ck.flash_attention_fwd_plain(
        tq, tk, tv, lens, causal)]
    return dict(causal=causal, want=_jax_fwd(q, k, v, causal), emu=emu,
                plain=plain)


@pytest.mark.parametrize("tile", [32, 64])
def test_split_tf32_forward_matches_the_jax_kernel(case, tile):
    """3xTF32 within 1e-5 of the JAX kernel on out and lse, and the empty
    row exactly out 0, lse -1e30 + log(1e-30) (in fp32: -1e30)."""
    out, lse = case["emu"][("3xtf32", tile)]
    assert out.shape == case["want"][0].shape
    assert lse.shape == case["want"][1].shape
    assert _err((out, lse), case["want"]) <= SPLIT_TOL
    assert np.all(out[0] == 0.0)
    assert np.all(lse[0] == np.float32(NEG) + np.float32(math.log(1e-30)))


@pytest.mark.parametrize("tile", [32, 64])
def test_split_tf32_forward_matches_the_plain_version(case, tile):
    """... and within 1e-5 of the port's plain version, which the card's
    kernel is held to."""
    assert _err(case["emu"][("3xtf32", tile)], case["plain"]) <= SPLIT_TOL


def test_plain_tf32_forward_misses_the_kernel_tolerance(case):
    """hi*hi alone (plain TF32) lands beyond KERNEL_TOL of the JAX kernel:
    why the kernel splits every operand; 3xTF32 is ten times closer at
    least."""
    for tile in (32, 64):
        plain_tf32 = _err(case["emu"][("tf32", tile)], case["want"])
        split3 = _err(case["emu"][("3xtf32", tile)], case["want"])
        assert plain_tf32 > KERNEL_TOL
        assert split3 * 10 < plain_tf32


def test_the_kernel_source_splits_its_products_and_copies_asynchronously():
    """What the CPU cannot run, read from the source: tensor-core TF32
    products, cp.async copies, no atomics, the rounding emulated above,
    the longest causal query tiles first and the empty row's values."""
    with open(os.path.join(ck.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cp.async.cg.shared.global" in src
    assert "cp.async.wait_group" in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code and "atom." not in code
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in src
    assert "(gridDim.y - 1 - blockIdx.y) * kRows" in code
    assert "fmaxf(l, 1e-30f)" in code and "kNeg = -1e30f" in code
    assert "extern \"C\" int ptt_flash_attention_fwd(" in src


def test_the_variant_script_still_matches_the_source():
    """flash_fwd_variants.py replaces text of the kernel source literally:
    each must be there, or the script times nothing."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import flash_fwd_variants
    finally:
        sys.path.remove(root)
    with open(os.path.join(root, flash_fwd_variants.SRC)) as f:
        src = f.read()
    for name, edits in flash_fwd_variants.VARIANTS.items():
        for old, new in edits:
            assert old in src and new not in src, (name, old)
