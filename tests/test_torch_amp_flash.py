"""Fault C10: fused attention under mixed precision, on the CPU.

Under Program.enable_mixed_precision both packages cast fused_attention's
q, k and v to bf16. The JAX package's Pallas kernels take the bf16 tiles,
widen them to f32, multiply and sum in f32, and write out, dQ, dK and dV
in bf16 (lse and delta stay f32). The port's bf16 K1-K3 do the same on
the card; on the CPU their wrappers run the plain versions, which widen,
compute in f32 and narrow at the end. These tests hold:

- the algorithm in float32: the plain bf16 path is exactly the plain fp32
  path on the same (bf16-representable) values, rounded once to bf16 at
  the end; and a bf16 value is exact in TF32, so the kernels' dropped lo
  products are zero (every one of the 65536 bf16 bit patterns checked);
- the op against the JAX package's fused_attention (its Pallas kernels in
  interpret mode, FLAGS_flash_min_seq=0) in a mixed-precision program,
  forward and gradients: each within two bf16 ulps of its largest value
  (relative error 2^-7 of max(1, max |jax|)). Both compute in f32 from
  the same bf16 inputs in another order, and a value that lands near a
  rounding boundary takes the neighbouring bf16 value (measured: 8.2e-4
  on out, 8.1e-5 on the gradients);
- the wrappers: q, k, v (and g) all fp32 or all bf16, on every device;
  a mix or fp16 raises;
- the small AMP Transformer: the program serializes to the JAX package's
  bytes, and one training step's loss and gradients from the JAX
  package's startup state agree with the JAX package's bf16 step within
  3 x the JAX package's own bf16-vs-fp32 spread + 2e-2 of each norm (the
  bound chip_smoke.py holds the card's bf16 steps to; measured: the loss
  equal to 7 digits, the worst gradient at 0.16 of its bound, the median
  error 4.9e-3 against a median spread of 6.8e-3).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import cuda_kernels as ck

B, T, H, D = 3, 40, 2, 16
LENS = [40, 0, 17]
BF16_TOL = 2.0 ** -7
SPREAD_X, SPREAD_FLOOR, LOSS_RTOL = 3.0, 2e-2, 1e-2
# the small Transformer: 1+1 layers, widths 16, T 8
TV, TT, TB = 32, 8, 2
TCFG = dict(n_layer=1, n_head=2, d_key=8, d_value=8, d_model=16,
            d_inner_hid=32, label_smooth_eps=0.1, use_fused_attention=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX package's fused_attention through its Pallas kernels at any
    length (its default sends T below 1024 to the dense path)."""
    monkeypatch.setenv("FLAGS_flash_min_seq", "0")
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "1")


def _bf16_values(*shape, seed):
    """randn rounded to bf16, as float32 numpy (exact)."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                         .astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_is_the_fp32_algorithm_rounded_once(causal):
    q, k, v, g = (torch.from_numpy(_bf16_values(B, T, H, D, seed=i))
                  for i in range(4))
    kv = torch.tensor(LENS, dtype=torch.int32)
    out16, lse16 = ck.flash_attention_fwd(*(x.bfloat16() for x in (q, k, v)),
                                          kv, causal)
    out32, lse32 = ck.flash_attention_fwd(q, k, v, kv, causal)
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert torch.equal(out16, out32.bfloat16())
    assert torch.equal(lse16, lse32)
    grads16 = ck.flash_attention_bwd(*(x.bfloat16() for x in (q, k, v)),
                                     out16, lse16, g.bfloat16(), kv, causal)
    # the fp32 backward from the same out (bf16 out widened), as the
    # delta the bf16 path forms from it
    grads32 = ck.flash_attention_bwd(q, k, v, out16.float(), lse16, g, kv,
                                     causal)
    for a, b in zip(grads16, grads32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())


def test_every_bf16_value_is_exact_in_tf32():
    """The bf16 kernels drop the lo product of a bf16 operand: lo =
    tf32_rna(x - tf32_rna(x)) is 0 for every finite bf16 x."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    assert torch.equal(hi, x)


def _attention_grads(fluid, causal, feed):
    """A mixed-precision program of fused_attention over fed q, k, v with
    kv_len, its loss sum(out * w) and append_backward: (main, fetch)."""
    main, startup = fluid.Program(), fluid.Program()
    main.enable_mixed_precision()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xs = []
        for name in "qkv":
            x = fluid.layers.data(name, shape=[T, H, D], dtype="float32")
            x.stop_gradient = False
            xs.append(x)
        w = fluid.layers.data("w", shape=[T, H, D], dtype="float32")
        kv_len = fluid.layers.data("kv_len", shape=[1], dtype="int32")
        out = fluid.layers.fused_attention(*xs, causal=causal,
                                           kv_len=kv_len)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        fluid.append_backward(loss)
    return main, [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]


@pytest.mark.parametrize("causal", [False, True])
def test_amp_fused_attention_matches_the_jax_one(jax_flash, causal):
    feed = {n: _bf16_values(B, T, H, D, seed=10 + i)
            for i, n in enumerate("qkvw")}
    feed["kv_len"] = np.array(LENS, np.int32).reshape(B, 1)
    jmain, fetch = _attention_grads(jfluid, causal, feed)
    tmain, tfetch = _attention_grads(tfluid, causal, feed)
    assert tfetch == fetch
    with jfluid.scope_guard(jfluid.Scope()):
        want = jfluid.Executor(jfluid.CPUPlace()).run(jmain, feed=feed,
                                                      fetch_list=fetch)
    got = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=fetch,
                                     scope=tfluid.Scope())
    for name, a, b in zip(fetch, got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape == (B, T, H, D), name
        assert np.isfinite(a).all()
        assert _rel(a, b) <= BF16_TOL, (name, _rel(a, b))
    # the row with no key: out 0 and no gradient in both
    assert not np.abs(got[0][1]).any() and not np.abs(got[1][1]).any()


@pytest.mark.parametrize("case", ["mixed", "fp16"])
def test_wrappers_reject_mixed_dtypes_and_fp16(case):
    x = torch.randn(1, 8, 1, 16)
    if case == "mixed":
        q, k, v, g = x.bfloat16(), x, x.bfloat16(), x.bfloat16()
    else:
        q = k = v = g = x.half()
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        ck.flash_attention_fwd(q, k, v)
    for fn in (ck.flash_attention_bwd_dkdv, ck.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="all float32 or all bfloat16"):
            fn(q, k, v, lse, lse, g)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        ck.flash_attention_bwd(q, k, v, v, lse, g)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        ck.FlashAttention.apply(q, k, v, None, False, None)


def _same_bytes(jprog, tprog):
    """program_to_bytes equal but for the JAX package's int64 -> int32
    narrowing of inferred dtypes."""
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    return td == jd


def _transformer(fluid, tr, amp):
    main, startup = fluid.Program(), fluid.Program()
    if amp:
        main.enable_mixed_precision()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, avg, _ = tr.build_train(TV, TV, TT, **TCFG)
    return main, startup, avg


def test_amp_transformer_program_and_step_match_the_jax_one(jax_flash):
    jmain, jstartup, javg = _transformer(jfluid, jtr, True)
    tmain, _, tavg = _transformer(tfluid, ttr, True)
    assert _same_bytes(jmain, tmain)
    assert tmain._amp and jmain._amp
    jmain32 = _transformer(jfluid, jtr, False)[0]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    rng = np.random.RandomState(5)
    src = [rng.randint(3, TV, n).tolist() for n in (TT, 5)]
    trg = [rng.randint(3, TV, n).tolist() for n in (6, TT)]
    feed = jtr.prepare_batch(src, trg, TT, TCFG["n_head"], fused=True)
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [tavg.name] + grads

    def jax_step(main):
        scope = jfluid.Scope()
        for name, a in state.items():
            scope.set(name, a)
        with jfluid.scope_guard(scope):
            out = jfluid.Executor(jfluid.CPUPlace()).run(
                main, feed=feed, fetch_list=fetch)
        return [np.asarray(x, np.float32) for x in out]

    j16, j32 = jax_step(jmain), jax_step(jmain32)
    t16 = tfluid.Executor("cpu").run(
        tmain, feed=feed, fetch_list=fetch,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    loss_rel = abs(float(t16[0][0]) - float(j16[0][0])) / abs(
        float(j16[0][0]))
    assert np.isfinite(t16[0]).all() and loss_rel <= LOSS_RTOL, loss_rel
    for name, t, j, s in zip(grads, t16[1:], j16[1:], j32[1:]):
        err = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        spread = np.linalg.norm(j - s) / max(np.linalg.norm(j), 1e-30)
        assert err <= SPREAD_X * spread + SPREAD_FLOOR, (name, err, spread)
