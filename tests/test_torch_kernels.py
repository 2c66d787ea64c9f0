"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode), and the wrappers' dispatch
rule. The CUDA kernels themselves run only on the card (chip_smoke.py
holds them against these same plain versions there).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: rtol = atol = 1e-5 — both sides compute in fp32, in a different
summation order.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v, kv_len, causal):
    """(out [B,T,H,D], lse [B,H,T]) from the JAX package's flash kernel,
    run in interpret mode with the block sizes flash_attention picks."""
    b, t, h, d = q.shape
    blk = max(8, min(128, int(-(-t // 8) * 8)))
    out = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal,
                             kv_len=None if kv_len is None
                             else jnp.asarray(kv_len),
                             interpret=True)

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    lens = np.repeat(np.full(b, t) if kv_len is None
                     else np.asarray(kv_len).reshape(b), h).astype(np.int32)
    _, lse = pk._flash_fwd(to_bh(q), to_bh(k), to_bh(v), jnp.asarray(lens),
                           1.0 / np.sqrt(d), causal, blk, blk, True)
    return np.asarray(out), np.asarray(lse).reshape(b, h, t)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [8, 40, 64])
def test_flash_plain_matches_jax_kernel(t, causal):
    q, k, v = _qkv(2, t, 2, 16, seed=t)
    kv_len = np.array([0, t - 3], np.int32)   # an empty row, a ragged one
    out, lse = ck.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len), causal)
    jout, jlse = _jax_flash(q, k, v, kv_len, causal)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)
    # the empty row: zero output, the TPU kernel's l_safe lse
    assert np.all(out.numpy()[0] == 0.0)
    assert np.all(lse.numpy()[0] < -1e29)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel_full_length(causal):
    q, k, v = _qkv(2, 40, 2, 16, seed=7)
    out, lse = ck.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None, causal)
    jout, jlse = _jax_flash(q, k, v, None, causal)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_reference_and_flash_plain_differ_only_on_empty_rows(causal):
    """The port's two dense attentions over [B,T,H,D] agree wherever a row
    has a valid key; on a kv_len = 0 row the ring-attention reference
    softmaxes uniformly (the mean of v) while flash gives 0. Merging them
    must keep both behaviours."""
    from paddle_tpu_torch.ops.nn_ops import attention_reference
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 2, 16, seed=5))
    kv = torch.tensor([0, 17], dtype=torch.int32)
    dense = attention_reference(q, k, v, causal=causal, kv_len=kv)
    flash, _ = ck.flash_attention_fwd_plain(q, k, v, kv, causal)
    np.testing.assert_allclose(dense[1].numpy(), flash[1].numpy(), **TOL)
    assert torch.all(flash[0] == 0.0)
    # every logit of the row is the same -1e30, causal or not
    mean_v = v[0].mean(dim=0, keepdim=True).expand_as(v[0])
    np.testing.assert_allclose(dense[0].numpy(), mean_v.numpy(), **TOL)


def test_layer_norm_plain_matches_jax_kernel():
    rng = np.random.RandomState(3)
    x = rng.randn(37, 64).astype(np.float32) * 3 + 1
    scale = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    y, mean, var = ck.layer_norm_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        1e-5)
    jy, jmean, jvar = pk.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), eps=1e-5,
                                    interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ck.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 2, 32, seed=1))
    kv = torch.tensor([[5], [24]], dtype=torch.int32)   # [B, 1] accepted
    out, lse = ck.flash_attention_fwd(q, k, v, kv, causal=True)
    ref, ref_lse = ck.flash_attention_fwd_plain(q, k, v, kv.reshape(-1),
                                                causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    x = torch.randn(6, 10, generator=torch.Generator().manual_seed(0))
    s, b = torch.ones(10), torch.zeros(10)
    for got, want in zip(ck.layer_norm_fwd(x, s, b),
                         ck.layer_norm_fwd_plain(x, s, b)):
        assert torch.equal(got, want)
    assert ck.launch_counts() == {"flash_attention_fwd": 0,
                                  "layer_norm_fwd": 0}


def test_meta_tensors_give_shapes_and_compute_nothing():
    ck.reset_launch_counts()
    q = torch.empty((1021, 32, 4, 16), device="meta")
    kv = torch.empty((1021, 1), dtype=torch.int32, device="meta")
    out, lse = ck.flash_attention_fwd(q, q, q, kv)
    assert out.device.type == "meta" and out.shape == q.shape
    assert lse.shape == (1021, 4, 32) and lse.dtype == torch.float32
    x = torch.empty((1021 * 32, 64), device="meta")
    y, mean, var = ck.layer_norm_fwd(x, torch.empty(64, device="meta"),
                                     torch.empty(64, device="meta"))
    assert y.shape == x.shape and mean.shape == var.shape == (1021 * 32,)
    assert ck.launch_counts() == {"flash_attention_fwd": 0,
                                  "layer_norm_fwd": 0}


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, torch.zeros(2, 9, 2, 16), q)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, q, q,
                               kv_len=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.layer_norm_fwd(torch.zeros(4, 8), torch.ones(7), torch.zeros(8))


def test_kernel_sources_are_in_the_package():
    """The build compiles only sources shipped in the package, and keys
    the library on their content."""
    for name in ck.SOURCES:
        path = os.path.join(ck.CSRC_DIR, name)
        assert os.path.isfile(path)
        with open(path) as f:
            assert 'extern "C" int ptt_' in f.read()
    assert len(ck._source_digest(ck.NVCC_FLAGS)) == 16
    assert "arch=compute_90a,code=sm_90a" in ck.NVCC_FLAGS
