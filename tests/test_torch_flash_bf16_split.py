"""The arithmetic of the bf16 wgmma kernels (K1 forward, K2 dK/dV, K3 dQ)
on the CPU, where the CUDA kernels cannot run.

`csrc/flash_attention_fwd_bf16.cu`, `csrc/flash_attention_bwd_dkdv_bf16.cu`
and `csrc/flash_attention_bwd_dq_bf16.cu` multiply bf16 operands on the
tensor cores (wgmma) with f32 sums. A bf16
value times a bf16 value is exact in f32, so S = Q K^T (and dP = G V^T)
is one product of the unscaled bf16 tiles, the scale applied to the f32
result, folded with log2(e) into exp2. P (and, in the backward, dS) is
f32 and not a bf16 value: the kernels split it into hi = bf16(x) and lo =
bf16(x - hi) and multiply both halves, so P keeps about 16 bits. These
tests emulate that walk in torch (a float32 matmul of bf16 values has
exact products and f32 sums, in another order than the tensor cores),
over the kernels' tiles (the forward's 64 keys and its 128-key variant;
dK/dV's 64 and 32 queries; dQ's 64 keys and its 128-key variant), and
hold it on bf16-representable
inputs at B = 2, T = 256, H = 2, D = 64, causal and not, with an empty
and a ragged row:
- against the JAX package's Pallas forward and its dK/dV and dQ kernels
  (jax.vjp of flash_attention) in interpret mode, which compute in f32
  from the same values, and against the port's plain versions: within
  SPLIT_TOL (out and lse absolute, dQ, dK and dV relative to max(1, max
  |dX|)); the
  empty row exactly out 0 and lse -1e30 + log(1e-30), its gradients 0;
- rounding P (and dS) once to bf16, one product each, misses SPLIT_TOL
  by ten times at least: why the kernels split;
- the sources issue bf16 wgmma and no TF32 mma.sync, and
  flash_bf16_variants.py's text edits still match them.
Inputs are made with numpy from a seed and handed to both packages.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

B, T, H, D = 2, 256, 2, 64
LENS = [0, 201]          # an empty row and a ragged one
# the split against f32 (measured: at most 6.4e-6 on out and lse, 3.0e-6
# on dK and dV; rounding P and dS once: 7.7e-4 to 3.6e-3): f32 sums in
# another order, and P's lo half rounded to bf16 (2^-17 of P)
SPLIT_TOL = 2e-5
NEG = -1e30              # the masked score and the empty row's max
LOG2E = 1.4426950408889634
EMPTY_LSE = np.float32(NEG) + np.float32(math.log(1e-30))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(x):
    """float32 -> the nearest bf16 value (ties to even), as float32: the
    kernels' cvt.rn.bf16x2.f32."""
    return x.to(torch.bfloat16).float()


def split(x):
    """x = hi + lo + (an error of about 2^-17 |x|), hi and lo bf16 values;
    x - hi is exact in f32."""
    hi = bf16(x)
    return hi, bf16(x - hi)


def product(p, b, once):
    """p @ b as the kernels compute it when p is f32 and b bf16: both
    halves of the split (lo first), or p rounded once."""
    if once:
        return bf16(p) @ b
    hi, lo = split(p)
    return lo @ b + hi @ b


def _valid(b, kpos, qpos, lens, causal):
    valid = kpos[None, None] < lens.reshape(b, 1, 1, 1)
    if causal:
        valid = valid & (kpos <= qpos)[None, None]
    return valid


def emulated_fwd(q, k, v, kv_len, causal, tile, once=False):
    """(out [B, T, H, D], lse [B, H, T]) of the kernel's walk over key
    tiles of `tile`: S = Q K^T of the unscaled bf16 tiles, invalid pairs
    set to -1e30 and their p to 0 (a select before the exponential), m
    the running max of the raw scores, p = exp2(S c - m c) with c =
    scale log2(e), the old sums rescaled by exp2((m - m_new) c), l += sum
    p, O += P V with P split (or rounded once); last out = O / max(l,
    1e-30) and lse = m scale + log(l), or -1e30 + log(1e-30) where l =
    0."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c2 = scale * LOG2E
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    qpos = torch.arange(t)[:, None]
    lens = kv_len.long()
    m = torch.full((b, h, t, 1), NEG)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    for k0 in range(0, t, tile):
        kpos = torch.arange(k0, min(k0 + tile, t))[None, :]
        valid = _valid(b, kpos, qpos, lens, causal)
        s = qh @ kh[:, :, k0:k0 + tile].transpose(-1, -2)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c2)
        p = torch.where(valid, torch.exp2(s * c2 - m_new * c2),
                        torch.zeros_like(s))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + product(p, vh[:, :, k0:k0 + tile], once)
        m = m_new
    out = o / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m * scale + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float(EMPTY_LSE)))
    return out.transpose(1, 2), lse[..., 0]


def emulated_dkdv(q, k, v, g, lse, delta, kv_len, causal, tile, once=False):
    """(dk, dv) [B, T, H, D] of the dK/dV kernel's walk over query tiles of
    `tile`: S^T = K Q^T and dP^T = V G^T of the bf16 tiles, P^T =
    exp2(S^T c - lse log2(e)) on valid pairs (0 elsewhere, a select),
    dS^T = P^T (dP^T - delta) scale, dV += P^T G and dK += dS^T Q with
    P^T and dS^T split (or rounded once)."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c2 = scale * LOG2E
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, g))
    kpos = torch.arange(t)[:, None]
    lens = kv_len.long()
    dk = torch.zeros((b, h, t, d))
    dv = torch.zeros((b, h, t, d))
    for q0 in range(0, t, tile):
        qs, gs = qh[:, :, q0:q0 + tile], gh[:, :, q0:q0 + tile]
        qpos = torch.arange(q0, min(q0 + tile, t))[None, :]
        valid = kpos[None, None] < lens.reshape(b, 1, 1, 1)
        if causal:
            valid = valid & (qpos >= kpos)[None, None]
        st = kh @ qs.transpose(-1, -2)                   # [B, H, Tk, tile]
        dpt = vh @ gs.transpose(-1, -2)
        ls = lse[:, :, None, q0:q0 + tile]
        p = torch.where(valid, torch.exp2(st * c2 - ls * LOG2E),
                        torch.zeros_like(st))
        ds = p * (dpt - delta[:, :, None, q0:q0 + tile]) * scale
        dv = dv + product(p, gs, once)
        dk = dk + product(ds, qs, once)
    return dk.transpose(1, 2), dv.transpose(1, 2)


def emulated_dq(q, k, v, g, lse, delta, kv_len, causal, tile, once=False):
    """dq [B, T, H, D] of the dQ kernel's walk over key tiles of `tile`
    (from key 0 up to the row's length): S = Q K^T and dP = G V^T of the
    bf16 tiles, P = exp2(S c - lse log2(e)) on valid pairs (0 elsewhere, a
    select), dS = P (dP - delta) scale, dQ += dS K with dS split (or
    rounded once)."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c2 = scale * LOG2E
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, g))
    qpos = torch.arange(t)[:, None]
    lens = kv_len.long()
    ls, dl = lse[..., None], delta[..., None]
    dq = torch.zeros((b, h, t, d))
    for k0 in range(0, t, tile):
        ks, vs = kh[:, :, k0:k0 + tile], vh[:, :, k0:k0 + tile]
        kpos = torch.arange(k0, min(k0 + tile, t))[None, :]
        valid = _valid(b, kpos, qpos, lens, causal)
        s = qh @ ks.transpose(-1, -2)                    # [B, H, T, tile]
        dp = gh @ vs.transpose(-1, -2)
        p = torch.where(valid, torch.exp2(s * c2 - ls * LOG2E),
                        torch.zeros_like(s))
        dq = dq + product(p * (dp - dl) * scale, ks, once)
    return dq.transpose(1, 2)


def rel_err(got, want):
    """chip_smoke.py's measure: max |got - want| over max(1, max |want|)."""
    return max(float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
               for g, w in zip(got, want))


def _err(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _inputs(seed):
    """randn rounded to bf16, as float32 (exact): q, k, v, g."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(4)]


def _jax(q, k, v, g, causal):
    """The JAX package's Pallas forward (out, lse) at its 128-row blocks
    and the dK, dV and dQ of jax.vjp through its flash kernels, in
    interpret mode, from the same float32 values."""
    def to_bh(x):
        return jnp.asarray(x.numpy()).transpose(0, 2, 1, 3).reshape(
            B * H, T, D)

    lens = jnp.asarray(np.repeat(LENS, H).astype(np.int32))
    out, lse = pk._flash_fwd(to_bh(q), to_bh(k), to_bh(v), lens,
                             1.0 / math.sqrt(D), causal, 128, 128, True)
    out = np.asarray(out).reshape(B, H, T, D).transpose(0, 2, 1, 3)

    def f(q, k, v):
        return pk.flash_attention(q, k, v, causal=causal,
                                  kv_len=jnp.asarray(LENS, jnp.int32),
                                  interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(g.numpy()))
    return (out, np.asarray(lse).reshape(B, H, T)), (np.asarray(dk),
                                                     np.asarray(dv)), \
        (np.asarray(dq),)


@pytest.fixture(scope="module", params=[False, True], ids=["full", "causal"])
def case(request):
    """One input, the JAX kernels' answers, the plain versions', and the
    emulated walks: forward over 64- and 128-key tiles, dK/dV over 64-
    and 32-query tiles, dQ over 64- and 128-key tiles, split and rounded
    once."""
    causal = request.param
    q, k, v, g = _inputs(60 + causal)
    lens = torch.tensor(LENS, dtype=torch.int32)
    out, lse = ck.flash_attention_fwd_plain(q, k, v, lens, causal)
    delta = ck.flash_delta(g, out)
    plain_dq, *plain_grads = ck.flash_attention_bwd_plain(
        q, k, v, lse, delta, g, lens, causal)
    jax_fwd, jax_grads, jax_dq = _jax(q, k, v, g, causal)
    emu = {}
    for once in (False, True):
        for tile in (64, 128):
            emu[("fwd", tile, once)] = [x.numpy() for x in emulated_fwd(
                q, k, v, lens, causal, tile, once)]
        for tile in (64, 32):
            emu[("dkdv", tile, once)] = [x.numpy() for x in emulated_dkdv(
                q, k, v, g, lse, delta, lens, causal, tile, once)]
        for tile in (64, 128):
            emu[("dq", tile, once)] = [emulated_dq(
                q, k, v, g, lse, delta, lens, causal, tile, once).numpy()]
    return dict(causal=causal, emu=emu,
                jax={"fwd": jax_fwd, "dkdv": jax_grads, "dq": jax_dq},
                plain={"fwd": (out.numpy(), lse.numpy()),
                       "dkdv": [x.numpy() for x in plain_grads],
                       "dq": [plain_dq.numpy()]})


def _error(case, part, tile, once, against):
    got = case["emu"][(part, tile, once)]
    want = case[against][part]
    return _err(got, want) if part == "fwd" else rel_err(got, want)


@pytest.mark.parametrize("tile", [64, 128])
def test_split_forward_matches_the_jax_kernel(case, tile):
    """out and lse within SPLIT_TOL of the JAX kernel; the empty row
    exactly out 0 and lse -1e30 + log(1e-30)."""
    out, lse = case["emu"][("fwd", tile, False)]
    assert out.shape == case["jax"]["fwd"][0].shape
    assert lse.shape == case["jax"]["fwd"][1].shape
    assert _error(case, "fwd", tile, False, "jax") <= SPLIT_TOL
    assert np.all(out[0] == 0.0)
    assert np.all(lse[0] == EMPTY_LSE)


@pytest.mark.parametrize("tile", [64, 128])
def test_split_forward_matches_the_plain_version(case, tile):
    """... and of the port's plain version, which the card's kernel is
    held to."""
    assert _error(case, "fwd", tile, False, "plain") <= SPLIT_TOL


@pytest.mark.parametrize("tile", [64, 32])
def test_split_dkdv_matches_the_jax_kernel(case, tile):
    """dK and dV within SPLIT_TOL of max(1, max |dX|) of jax.vjp through
    the JAX kernels; the empty row's gradients exactly 0."""
    dk, dv = case["emu"][("dkdv", tile, False)]
    assert dk.shape == dv.shape == case["jax"]["dkdv"][0].shape
    assert _error(case, "dkdv", tile, False, "jax") <= SPLIT_TOL
    assert not dk[0].any() and not dv[0].any()


@pytest.mark.parametrize("tile", [64, 32])
def test_split_dkdv_matches_the_plain_version(case, tile):
    assert _error(case, "dkdv", tile, False, "plain") <= SPLIT_TOL


@pytest.mark.parametrize("tile", [64, 128])
def test_split_dq_matches_the_jax_kernel(case, tile):
    """dQ within SPLIT_TOL of max(1, max |dQ|) of jax.vjp through the JAX
    kernels (its `_flash_bwd_dq_kernel`); the empty row's dQ exactly 0."""
    dq, = case["emu"][("dq", tile, False)]
    assert dq.shape == case["jax"]["dq"][0].shape
    assert _error(case, "dq", tile, False, "jax") <= SPLIT_TOL
    assert not dq[0].any()


@pytest.mark.parametrize("tile", [64, 128])
def test_split_dq_matches_the_plain_version(case, tile):
    assert _error(case, "dq", tile, False, "plain") <= SPLIT_TOL


@pytest.mark.parametrize("part", ["fwd", "dkdv", "dq"])
def test_rounding_once_misses_the_tolerance(case, part):
    """P (and dS) rounded once to bf16, one product each, lands ten times
    SPLIT_TOL away from the JAX kernels at least, and ten times farther
    than the split: why the kernels multiply both halves."""
    for tile in ((64, 32) if part == "dkdv" else (64, 128)):
        once = _error(case, part, tile, True, "jax")
        split2 = _error(case, part, tile, False, "jax")
        assert once > 10 * SPLIT_TOL
        assert once > 10 * split2


def test_the_split_keeps_sixteen_bits():
    """hi + lo is within 2^-16 of x, relative, over values from 1e-30 to
    1e3 of either sign (lo stays a normal number); hi alone only within
    2^-9."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy((10.0 ** rng.uniform(-30, 3, 100000)
                          * np.sign(rng.randn(100000))).astype(np.float32))
    hi, lo = split(x)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -10


@pytest.mark.parametrize("name", ["flash_attention_fwd_bf16.cu",
                                  "flash_attention_bwd_dkdv_bf16.cu",
                                  "flash_attention_bwd_dq_bf16.cu"])
def test_the_kernel_sources_issue_bf16_wgmma(name):
    """What the CPU cannot run, read from the source: bf16 wgmma (register
    A fragments for the split products, the MN-major B operand), the
    fences around it, the split, TMA copies (tensor maps encoded through
    the driver entry point) completing on mbarriers, no TF32 mma.sync and
    no atomics, and the C entry point the wrapper binds."""
    with open(os.path.join(ck.CSRC_DIR, name)) as f:
        src = f.read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in code
    assert "wgmma.fence.sync.aligned" in code
    assert "wgmma.commit_group.sync.aligned" in code
    assert "wgmma.wait_group.sync.aligned" in code
    assert "mma.sync" not in code and "tf32" not in code
    assert "atomic" not in code and "atom." not in code
    assert "cp.async.bulk.tensor.4d.shared::cluster.global" in code
    assert "mbarrier.try_wait.parity.shared::cta.b64" in code
    assert '"cuTensorMapEncodeTiled"' in code and "__grid_constant__" in code
    assert "__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y)" in code
    assert 'extern "C" int ptt_%s(' % name[:-len(".cu")] in src


def test_the_old_sources_lost_only_their_bf16_entries():
    """The fp32 sources keep their entries; the bf16 K1, K2 and K3 entries
    live in the new sources alone, and the library builds all five."""
    with open(os.path.join(ck.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        fwd = f.read()
    with open(os.path.join(ck.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        bwd = f.read()
    assert 'extern "C" int ptt_flash_attention_fwd(' in fwd
    assert "ptt_flash_attention_fwd_bf16" not in fwd
    assert 'extern "C" int ptt_flash_attention_bwd_dkdv(' in bwd
    assert 'extern "C" int ptt_flash_attention_bwd_dq(' in bwd
    assert "ptt_flash_attention_bwd_dq_bf16" not in bwd
    assert "ptt_flash_attention_bwd_dkdv_bf16" not in bwd
    with open(os.path.join(ck.CSRC_DIR, "flash_attention_bwd_dq_bf16.cu")) \
            as f:
        assert 'extern "C" int ptt_flash_attention_bwd_dq_bf16(' in f.read()
    for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                 "flash_attention_fwd_bf16.cu",
                 "flash_attention_bwd_dkdv_bf16.cu",
                 "flash_attention_bwd_dq_bf16.cu"):
        assert name in ck.SOURCES


def test_the_variant_script_still_matches_the_sources():
    """flash_bf16_variants.py replaces text of the kernel sources
    literally (its variants, ablations and clock probes): each must be
    there, or the script times nothing."""
    sys.path.insert(0, ROOT)
    try:
        import flash_bf16_variants as fv
    finally:
        sys.path.remove(ROOT)
    for part, path in fv.SRCS.items():
        with open(os.path.join(ROOT, path)) as f:
            src = f.read()
        tables = (fv.VARIANTS[part], fv.ABLATIONS[part],
                  {"clock": fv.CLOCK[part]})
        for table in tables:
            for name, edits in table.items():
                for old, new in edits:
                    assert old in src, (part, name, old)
                    src_after = src.replace(old, new)
                    assert src_after != src, (part, name)
