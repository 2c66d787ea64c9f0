"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode), and the wrappers' dispatch
rule. The CUDA kernels themselves run only on the card (chip_smoke.py
holds them against these same plain versions there).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: rtol = atol = 1e-5 — both sides compute in fp32, in a different
summation order. The backward passes (the flash backward's plain version
and the three autograd Functions against the JAX custom_vjps) need no
looser tolerance at these sizes: each gradient element is a sum of at
most T = 64 products, whose fp32 rounding stays near 1e-6 of the values.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=1e-5, atol=1e-5)
# every counted kernel (K1-K9, K1-K3's bf16 instantiations, the while
# node's set_while_condition)
_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq", "softmax_xent_fwd", "layer_norm_fwd",
            "fused_lstm", "fused_lstmp", "masked_softmax", "masked_pool",
            "flash_attention_fwd_bf16", "flash_attention_bwd_dkdv_bf16",
            "flash_attention_bwd_dq_bf16", "set_while_condition")


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
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)


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
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, torch.zeros(2, 9, 2, 16), q)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, q, q,
                               kv_len=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.layer_norm_fwd(torch.zeros(4, 8), torch.ones(7), torch.zeros(8))


def _jax_flash_grads(q, k, v, kv_len, causal, g):
    """(dq, dk, dv) of the JAX package's flash attention (its custom_vjp:
    the dK/dV and dQ Pallas kernels in interpret mode)."""
    def f(q, k, v):
        return pk.flash_attention(
            q, k, v, causal=causal,
            kv_len=None if kv_len is None else jnp.asarray(kv_len),
            interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [8, 40, 64])
def test_flash_bwd_plain_matches_jax_kernels(t, causal):
    """K2/K3's plain version (from the plain forward's out and lse) against
    jax.vjp of the JAX flash kernel, with an empty and a ragged row."""
    q, k, v = _qkv(2, t, 2, 16, seed=100 + t)
    g = np.random.RandomState(t).randn(*q.shape).astype(np.float32)
    kv_len = np.array([0, t - 3], np.int32)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tlen = torch.from_numpy(kv_len)
    out, lse = ck.flash_attention_fwd_plain(tq, tk, tv, tlen, causal)
    got = ck.flash_attention_bwd(tq, tk, tv, out, lse, tg, tlen, causal)
    want = _jax_flash_grads(q, k, v, kv_len, causal, g)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg="d" + name, **TOL)
        # the empty row: every gradient exactly 0, never inf * 0
        assert np.all(a.numpy()[0] == 0.0), "d" + name
    # the wrappers of the two kernels give the same slices on the CPU
    delta = ck.flash_delta(tg, out)
    args = (tq, tk, tv, lse, delta, tg, tlen, causal)
    dk, dv = ck.flash_attention_bwd_dkdv(*args)
    assert torch.equal(ck.flash_attention_bwd_dq(*args), got[0])
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_backward_matches_jax_custom_vjp(causal):
    """FlashAttention (forward K1, backward K2 + K3) through
    torch.autograd against the JAX _flash_core custom_vjp, full-length
    rows and a non-contiguous output gradient."""
    q, k, v = _qkv(2, 40, 2, 32, seed=9)
    g = np.random.RandomState(4).randn(2, 2, 40, 32).astype(np.float32)
    gt = torch.from_numpy(g).transpose(1, 2)          # strided [B, T, H, D]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ck.FlashAttention.apply(*leaves, None, causal, None)
    got = torch.autograd.grad(out, leaves, gt)
    want = _jax_flash_grads(q, k, v, None, causal, gt.numpy())
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg="d" + name, **TOL)


def _xent_inputs(n=37, v=50, seed=11):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int64)
    labels[:3] = [-1, v, v + 5]                  # outside [0, V): V - 1
    return logits, labels


def _jax_cpu_labels(labels, v):
    """The classes the JAX CPU path's gather picks (and the port's
    hard_label_index): -1 wraps to V - 1, V + k clamps to V - 1. The JAX
    Pallas kernel picks 0 for a label outside [0, V) instead, so it is
    handed these."""
    return np.clip(np.where(labels < 0, labels + v, labels), 0,
                   v - 1).astype(np.int32)


def test_xent_plain_matches_jax_kernel():
    logits, labels = _xent_inputs()
    loss, lse = ck.softmax_xent_fwd_plain(torch.from_numpy(logits),
                                          torch.from_numpy(labels))
    classes = _jax_cpu_labels(labels, logits.shape[1])
    jloss, jlse = pk._xent_fwd_call(jnp.asarray(logits),
                                    jnp.asarray(classes), 8, True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    np.testing.assert_allclose(
        loss.numpy(), np.asarray(pk.softmax_xent(
            jnp.asarray(logits), jnp.asarray(classes), interpret=True)),
        **TOL)
    # labels -1, V and V + 5 pick class V - 1
    np.testing.assert_allclose(
        loss.numpy()[:3, 0], lse.numpy()[:3, 0] - logits[:3, -1], **TOL)


def test_xent_function_backward_matches_jax_custom_vjp():
    """SoftmaxXent (forward K4, backward in torch) against the JAX
    _xent_core custom_vjp, out-of-range labels included (the one-hot at
    the class the forward picks, handed to the JAX kernel as that class);
    and the lse output's own gradient against autograd's."""
    logits, labels = _xent_inputs(seed=12)
    g = np.random.RandomState(5).randn(logits.shape[0], 1).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss, lse = ck.SoftmaxXent.apply(x, torch.from_numpy(labels))
    got, = torch.autograd.grad(loss, x, torch.from_numpy(g),
                               retain_graph=True)
    classes = _jax_cpu_labels(labels, logits.shape[1])
    _, vjp = jax.vjp(lambda a: pk.softmax_xent(
        a, jnp.asarray(classes), interpret=True), jnp.asarray(logits))
    want, = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_lse, = torch.autograd.grad(lse, x, torch.from_numpy(g))
    y = torch.from_numpy(logits).requires_grad_(True)
    want_lse, = torch.autograd.grad(torch.logsumexp(y, -1, keepdim=True), y,
                                    torch.from_numpy(g))
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), **TOL)


def test_layer_norm_function_backward_matches_jax_custom_vjp():
    """LayerNorm (forward K5, backward in torch from the saved mean and
    variance) against the JAX _ln_core custom_vjp (saved mean and rstd)."""
    rng = np.random.RandomState(6)
    x = (rng.randn(37, 64) * 3 + 1).astype(np.float32)
    scale, bias = (rng.randn(64).astype(np.float32) for _ in range(2))
    g = rng.randn(37, 64).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, bias)]
    y, _, _ = ck.LayerNorm.apply(*leaves, 1e-5)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, s, b: pk.layer_norm(a, s, b, eps=1e-5,
                                                   interpret=True)[0],
                     *(jnp.asarray(a) for a in (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_training_wrappers_dispatch_by_device():
    """The backward and cross-entropy wrappers: a CPU tensor takes the
    plain version and launches nothing, a meta tensor gives shapes, and a
    bad shape raises."""
    ck.reset_launch_counts()
    logits, labels = _xent_inputs(n=9, v=12)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    for got, want in zip(ck.softmax_xent_fwd(tl, tlab[:, None]),
                         ck.softmax_xent_fwd_plain(tl, tlab)):
        assert torch.equal(got, want)
    meta = torch.empty((1021, 30000), device="meta")
    loss, lse = ck.softmax_xent_fwd(
        meta, torch.empty(1021, dtype=torch.int64, device="meta"))
    assert loss.shape == lse.shape == (1021, 1) and lse.device.type == "meta"
    q = torch.empty((3, 32, 4, 16), device="meta")
    s = torch.empty((3, 4, 32), device="meta")
    dk, dv = ck.flash_attention_bwd_dkdv(q, q, q, s, s, q)
    assert dk.shape == dv.shape == q.shape and dk.device.type == "meta"
    assert ck.flash_attention_bwd_dq(q, q, q, s, s, q).shape == q.shape
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)
    with pytest.raises(ValueError):
        ck.softmax_xent_fwd(tl, tlab[:5])
    with pytest.raises(ValueError):
        ck.softmax_xent_fwd(tl[0], tlab[:1])


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


def test_every_source_is_built_and_every_wrapper_counted():
    """Every CUDA source in csrc/ (K7's fused_lstmp_fwd.cu among them) is
    compiled by build(), and every kernel wrapper has a launch counter."""
    on_disk = sorted(f for f in os.listdir(ck.CSRC_DIR) if f.endswith(".cu"))
    assert on_disk == sorted(ck.SOURCES)
    assert "fused_lstmp_fwd.cu" in ck.SOURCES
    assert tuple(ck.launch_counts()) == _KERNELS


# ---------------------------------------------------------------------------
# K6 fused LSTM and K9 masked pool (the sequence slice)
# ---------------------------------------------------------------------------

def _lstm_inputs(b=4, t=11, d=8, seed=21, h0c0=True):
    """x [B, T, 4D], w, bias, optional h0/c0 and ragged lengths with a
    length-1 row and a full one, at the scales the JAX package's tests
    use."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, 4 * d) * 0.4).astype(np.float32)
    w = (rng.randn(d, 4 * d) * 0.3).astype(np.float32)
    bias = (rng.randn(4 * d) * 0.1).astype(np.float32)
    h0 = (rng.randn(b, d) * 0.2).astype(np.float32) if h0c0 else None
    c0 = (rng.randn(b, d) * 0.2).astype(np.float32) if h0c0 else None
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 1
    return x, w, bias, h0, c0, lens


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("h0c0", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstm_plain_matches_jax_kernel(reverse, h0c0):
    """K6's plain version against the JAX fused_lstm (the Pallas kernel in
    interpret mode): hidden and cell, forward and reverse, ragged lengths
    with 1 and T, zero and given initial states."""
    x, w, bias, h0, c0, lens = _lstm_inputs(h0c0=h0c0)
    hidden, cell = ck.fused_lstm_plain(_t(x), _t(w), _t(bias), _t(h0),
                                       _t(c0), _t(lens), reverse)
    jh, jc = pk.fused_lstm(_j(x), _j(w), _j(bias), _j(h0), _j(c0),
                           jnp.asarray(lens), reverse=reverse,
                           interpret=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(cell.numpy(), np.asarray(jc), **TOL)
    # the length-1 row: every padding step carries the one valid step's
    # state (forward) or the initial state into the valid step (reverse)
    if not reverse:
        assert np.all(hidden.numpy()[-1, 1:] == hidden.numpy()[-1, :1])


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstm_function_backward_matches_jax_custom_vjp(reverse):
    """FusedLSTM (forward K6, backward the saved-state reverse scan in
    torch) against jax.vjp of the JAX fused_lstm (_lstm_seq_core_bwd):
    dx, dw, db, dh0, dc0 from random hidden and cell gradients."""
    x, w, bias, h0, c0, lens = _lstm_inputs(seed=22)
    rng = np.random.RandomState(3)
    gh = rng.randn(*x.shape[:2], w.shape[0]).astype(np.float32)
    gc = rng.randn(*gh.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, bias, h0, c0)]
    hidden, cell = ck.FusedLSTM.apply(*leaves, torch.from_numpy(lens),
                                      reverse)
    got = torch.autograd.grad((hidden, cell), leaves,
                              (torch.from_numpy(gh), torch.from_numpy(gc)))
    _, vjp = jax.vjp(lambda *a: pk.fused_lstm(
        *a, jnp.asarray(lens), reverse=reverse, interpret=True),
        *(jnp.asarray(a) for a in (x, w, bias, h0, c0)))
    want = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    for name, a, b in zip(("dx", "dw", "db", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    # padding steps of x get exactly zero gradient
    assert np.all(got[0].numpy()[-1, 1:] == 0.0)


def test_fused_lstm_backward_matches_autograd_of_the_plain_loop():
    """fused_lstm_bwd against torch.autograd through fused_lstm_plain's own
    loop, with only the hidden gradient given (the cell is unread)."""
    x, w, bias, h0, c0, lens = _lstm_inputs(seed=23)
    g = np.random.RandomState(8).randn(4, 11, 8).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, bias, h0, c0)]
    hidden, _ = ck.fused_lstm_plain(*leaves, torch.from_numpy(lens), True)
    want = torch.autograd.grad(hidden, leaves, torch.from_numpy(g))
    hidden, cell = ck.fused_lstm_plain(
        *(torch.from_numpy(a) for a in (x, w, bias, h0, c0)),
        torch.from_numpy(lens), True)
    got = ck.fused_lstm_bwd(*(torch.from_numpy(a)
                              for a in (x, w, bias, h0, c0)),
                            torch.from_numpy(lens), hidden, cell,
                            torch.from_numpy(g), None, True)
    for name, a, b in zip(("dx", "dw", "db", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


def _pool_inputs(seed=31, b=5, t=9, f=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, f).astype(np.float32)
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 1
    return x, lens


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT"])
def test_masked_pool_plain_matches_jax_kernel(ptype):
    x, lens = _pool_inputs()
    got = ck.masked_pool_plain(torch.from_numpy(x), torch.from_numpy(lens),
                               ptype)
    want = pk.masked_pool(jnp.asarray(x), jnp.asarray(lens), ptype=ptype,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT"])
def test_masked_pool_function_backward_matches_jax_custom_vjp(ptype):
    x, lens = _pool_inputs(seed=32)
    g = np.random.RandomState(9).randn(5, 6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ck.MaskedPool.apply(xt, torch.from_numpy(lens), ptype)
    got, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: pk.masked_pool(
        a, jnp.asarray(lens), ptype=ptype, interpret=True), jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[-1, 1:] == 0.0)   # padding: no gradient


def test_sequence_wrappers_dispatch_by_device():
    """K6 and K9: a CPU tensor takes the plain version and launches
    nothing, a meta tensor gives shapes, and a bad shape or pool type
    raises."""
    ck.reset_launch_counts()
    x, w, bias, h0, c0, lens = _lstm_inputs()
    args = [_t(a) for a in (x, w, bias, h0, c0, lens)]
    for got, want in zip(ck.fused_lstm(*args, reverse=True),
                         ck.fused_lstm_plain(*args, reverse=True)):
        assert torch.equal(got, want)
    px, plens = _pool_inputs()
    assert torch.equal(
        ck.masked_pool(torch.from_numpy(px), torch.from_numpy(plens), "SUM"),
        ck.masked_pool_plain(torch.from_numpy(px), torch.from_numpy(plens),
                             "SUM"))
    mx = torch.empty((1021, 1021, 512), device="meta")
    mw = torch.empty((128, 512), device="meta")
    mlen = torch.empty(1021, dtype=torch.int32, device="meta")
    hidden, cell = ck.fused_lstm(mx, mw, torch.empty(512, device="meta"),
                                 lens=mlen)
    assert hidden.shape == cell.shape == (1021, 1021, 128)
    assert hidden.device.type == "meta"
    assert ck.masked_pool(mx, mlen, "SQRT").shape == (1021, 512)
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)
    with pytest.raises(ValueError, match="4D"):
        ck.fused_lstm(torch.zeros(2, 3, 10), torch.zeros(2, 8),
                      torch.zeros(8))
    with pytest.raises(ValueError, match="w \\[D, 4D\\]"):
        ck.fused_lstm(torch.zeros(2, 3, 8), torch.zeros(3, 8),
                      torch.zeros(8))
    with pytest.raises(ValueError, match="MAX"):
        ck.masked_pool(torch.zeros(2, 3, 4), torch.ones(2), "MAX")
    with pytest.raises(ValueError, match="B lengths"):
        ck.masked_pool(torch.zeros(2, 3, 4), torch.ones(3), "SUM")


# ---------------------------------------------------------------------------
# K8 masked softmax (the attention translator's slice)
# ---------------------------------------------------------------------------

def _softmax_inputs(n, t, seed):
    """x [N, T] at the scale of attention scores, and lengths with 0, 1 and
    T among them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, t) * 3).astype(np.float32)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[:3] = (0, 1, t)
    return x, lens


def _jax_where_mask_softmax(x, lens):
    """The JAX package's sequence_softmax rule on its where-mask path
    (PADDLE_TPU_PALLAS=0)."""
    from paddle_tpu.core import registry as jreg
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "0")
        out = jreg.get("sequence_softmax").lower(
            None, {"X": [jnp.asarray(x)], "XLen": [jnp.asarray(lens)]}, {})
    return np.asarray(out["Out"][0])


@pytest.mark.parametrize("shape", [(5, 13), (16, 48)])
def test_masked_softmax_plain_matches_jax_kernel_and_where_mask_rule(shape):
    """K8's plain version against the JAX masked_softmax (the Pallas kernel
    in interpret mode) and the where-mask rule, with a length-0, a
    length-1 and a full row: exact zeros past each length, a length-0 row
    all 0, every other row summing to 1."""
    x, lens = _softmax_inputs(*shape, seed=41)
    got = ck.masked_softmax_plain(torch.from_numpy(x),
                                  torch.from_numpy(lens)).numpy()
    kernel = pk.masked_softmax(jnp.asarray(x), jnp.asarray(lens),
                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, _jax_where_mask_softmax(x, lens), **TOL)
    for row, n in zip(got, lens):
        assert np.all(row[n:] == 0.0)
        if n:
            np.testing.assert_allclose(row.sum(), 1.0, rtol=1e-6)
    assert got[1, 0] == 1.0


def test_masked_softmax_function_backward_matches_jax_custom_vjp():
    """MaskedSoftmax (forward K8, backward y * (g - sum(g * y)) in torch)
    against jax.vjp of the JAX masked_softmax (_masked_softmax_core_bwd);
    masked steps get exactly zero gradient."""
    x, lens = _softmax_inputs(16, 48, seed=42)
    g = np.random.RandomState(10).randn(16, 48).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ck.MaskedSoftmax.apply(xt, torch.from_numpy(lens))
    got, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: pk.masked_softmax(
        a, jnp.asarray(lens), interpret=True), jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for row, n in zip(got.numpy(), lens):
        assert np.all(row[n:] == 0.0)


def test_masked_softmax_wrapper_dispatches_by_device():
    """A CPU tensor takes the plain version and launches nothing, a meta
    tensor gives the [N, T] shape, a strided row is read as it lies, and
    a bad shape raises."""
    ck.reset_launch_counts()
    x, lens = _softmax_inputs(5, 13, seed=43)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lens)
    assert torch.equal(ck.masked_softmax(tx, tl),
                       ck.masked_softmax_plain(tx, tl))
    wide = torch.from_numpy(np.concatenate([x, x], axis=1))[:, :13]
    assert torch.equal(ck.masked_softmax(wide, tl),
                       ck.masked_softmax_plain(tx, tl))
    meta = torch.empty((1021, 1021), device="meta")
    y = ck.masked_softmax(meta, torch.empty(1021, dtype=torch.int32,
                                            device="meta"))
    assert y.shape == (1021, 1021) and y.device.type == "meta"
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)
    with pytest.raises(ValueError, match="N lengths"):
        ck.masked_softmax(tx, tl[:4])
    with pytest.raises(ValueError, match="x \\[N, T\\]"):
        ck.masked_softmax(tx[None], tl)
