"""The conv-net op rules of the port against the JAX package's, rule by
rule on the CPU: conv2d / depthwise_conv2d, pool2d, batch_norm, the sgd
and momentum updates, and the mixed-precision casts of
Program.enable_mixed_precision.

Inputs are made with numpy from a seed and handed to both packages.
Values and gradients (of sum(out * g) for a random g, through jax.vjp and
torch.autograd) are compared with:
- conv2d, pool2d, batch_norm: rtol = atol = 1e-5 (fp32 sums in another
  order);
- sgd, momentum: rtol = atol = 1e-6 (one fp32 multiply-add each);
- mixed precision, against the JAX package: each array within
  2e-2 * (|want| + max |want|), the tolerance led by the array's own
  magnitude (bf16 keeps 8 bits of mantissa, a relative step of
  2^-8 = 0.4%; a product summed in fp32 on both sides may round to
  neighbouring bf16 values, and the error grows through the layers
  after it). Measured on conv -> batch_norm(relu) -> pool -> fc: at most
  6.1e-3 of the array's largest value (fc's weight change). The step's
  parameter changes (lr * gradient, about 1e-4 of the parameters) are
  compared, not the parameters, which no bf16 error could move past the
  tolerance; batch_norm's moving statistics (f32, from the conv's bf16
  output, which both packages round alike) move within 2e-3 of their
  change's magnitude (measured 2.1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JaxCtx

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TorchCtx

TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_REL, STAT_REL = 2e-2, 2e-3
CPU = torch.device("cpu")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _vjp_both(op_type, ins, attrs, diff, outs):
    """Run `op_type` in both packages on numpy `ins`: returns ({slot:
    value} of the JAX rule, the same of the port's, [(JAX grad, port
    grad)] of sum over `outs` of out * g with respect to the `diff` input
    slots)."""
    cots = {s: None for s in outs}
    jctx = JaxCtx(None, base_key=jax.random.key(0))

    def jrun(*dvals):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for s, d in zip(diff, dvals):
            jins[s] = [d]
        return jreg.get(op_type).lower(jctx, jins, attrs)

    jres = jrun(*(jnp.asarray(ins[s][0]) for s in diff))
    for i, s in enumerate(outs):
        cots[s] = _rand(*jres[s][0].shape, seed=100 + i)
    _, vjp = jax.vjp(lambda *d: [jrun(*d)[s][0] for s in outs],
                     *(jnp.asarray(ins[s][0]) for s in diff))
    jgrads = vjp([jnp.asarray(cots[s]) for s in outs])

    tins = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in ins.items()}
    leaves = [tins[s][0].clone().requires_grad_(True) for s in diff]
    for s, leaf in zip(diff, leaves):
        tins[s] = [leaf]
    tres = treg.get(op_type).lower(TorchCtx(None, CPU), tins, attrs)
    loss = sum((tres[s][0] * torch.from_numpy(cots[s])).sum() for s in outs)
    tgrads = torch.autograd.grad(loss, leaves)
    jvals = {s: np.asarray(v[0]) for s, v in jres.items()}
    tvals = {s: v[0].detach().numpy() for s, v in tres.items()}
    return jvals, tvals, [(np.asarray(j), t.numpy())
                          for j, t in zip(jgrads, tgrads)]


# --------------------------------------------------------------- conv2d --

CONV_CASES = {
    # x shape, filter shape, attrs
    "groups2_stride2_pad1": ((2, 4, 9, 7), (6, 2, 3, 3),
                             dict(strides=[2, 2], paddings=[1, 1],
                                  dilations=[1, 1], groups=2)),
    "dilation2_uneven": ((2, 3, 11, 10), (5, 3, 3, 2),
                         dict(strides=[1, 2], paddings=[2, 0],
                              dilations=[2, 2], groups=1)),
    "1x1_stride2": ((3, 8, 7, 7), (4, 8, 1, 1),
                    dict(strides=[2, 2], paddings=[0, 0], dilations=[1, 1],
                         groups=1)),
    "7x7_stride2_pad3": ((2, 3, 13, 13), (8, 3, 7, 7),
                         dict(strides=[2, 2], paddings=[3, 3],
                              dilations=[1, 1], groups=1)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    xs, ws, attrs = CONV_CASES[case]
    ins = {"Input": [_rand(*xs, seed=1)], "Filter": [_rand(*ws, seed=2)]}
    jv, tv, grads = _vjp_both("conv2d", ins, attrs, ["Input", "Filter"],
                              ["Output"])
    assert tv["Output"].shape == jv["Output"].shape
    np.testing.assert_allclose(tv["Output"], jv["Output"], **TOL)
    for name, (j, t) in zip(["dInput", "dFilter"], grads):
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def test_depthwise_conv2d_matches_jax():
    """One filter per channel (groups = C), the MobileNet shape."""
    ins = {"Input": [_rand(2, 6, 9, 9, seed=3)],
           "Filter": [_rand(6, 1, 3, 3, seed=4)]}
    attrs = dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1],
                 groups=6)
    jv, tv, grads = _vjp_both("depthwise_conv2d", ins, attrs,
                              ["Input", "Filter"], ["Output"])
    np.testing.assert_allclose(tv["Output"], jv["Output"], **TOL)
    for j, t in grads:
        np.testing.assert_allclose(t, j, **TOL)


# --------------------------------------------------------------- pool2d --

POOL_CASES = {
    # x [2, 3, 7, 9] unless given; attrs
    "max_k3s2p1": dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
                       paddings=[1, 1]),
    "max_ceil": dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
                     paddings=[0, 0], ceil_mode=True),
    "max_global": dict(pooling_type="max", ksize=[1, 1], strides=[1, 1],
                       paddings=[0, 0], global_pooling=True),
    "avg_exclusive_pad": dict(pooling_type="avg", ksize=[3, 3],
                              strides=[2, 2], paddings=[1, 1]),
    "avg_inclusive_pad": dict(pooling_type="avg", ksize=[3, 3],
                              strides=[2, 2], paddings=[1, 1],
                              exclusive=False),
    "avg_ceil_exclusive": dict(pooling_type="avg", ksize=[2, 2],
                               strides=[2, 2], paddings=[0, 0],
                               ceil_mode=True),
    "avg_ceil_inclusive": dict(pooling_type="avg", ksize=[3, 2],
                               strides=[2, 2], paddings=[0, 1],
                               ceil_mode=True, exclusive=False),
    # the last window in each dim lies wholly in padding: 0
    "avg_ceil_window_in_padding": dict(pooling_type="avg", ksize=[2, 2],
                                       strides=[3, 3], paddings=[1, 1],
                                       ceil_mode=True),
    "avg_global": dict(pooling_type="avg", ksize=[1, 1], strides=[1, 1],
                       paddings=[0, 0], global_pooling=True),
    "avg_no_pad": dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2],
                       paddings=[0, 0]),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    """Odd sizes (7 x 9), where ceil_mode's end padding and the exclusive
    count decide the edges."""
    attrs = POOL_CASES[case]
    ins = {"X": [_rand(2, 3, 7, 9, seed=5)]}
    jv, tv, grads = _vjp_both("pool2d", ins, attrs, ["X"], ["Out"])
    assert tv["Out"].shape == jv["Out"].shape
    np.testing.assert_allclose(tv["Out"], jv["Out"], **TOL)
    np.testing.assert_allclose(grads[0][1], grads[0][0], **TOL)


def test_pool2d_max_window_in_padding_is_minus_inf():
    """A ceil_mode window wholly in padding: -inf for max on both sides
    (the JAX rule's reduce_window pads with its -inf init value)."""
    attrs = POOL_CASES["avg_ceil_window_in_padding"]
    attrs = dict(attrs, pooling_type="max")
    ins = {"X": [_rand(2, 3, 7, 9, seed=6)]}
    want = np.asarray(jreg.get("pool2d").lower(
        JaxCtx(None), {"X": [jnp.asarray(ins["X"][0])]}, attrs)["Out"][0])
    got = treg.get("pool2d").lower(
        TorchCtx(None, CPU), {"X": [torch.from_numpy(ins["X"][0])]},
        attrs)["Out"][0].numpy()
    assert np.isneginf(want[:, :, -1]).all()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- batch_norm --

def _bn_ins(xshape, c, seed):
    return {"X": [_rand(*xshape, seed=seed) * 2 + 0.5],
            "Scale": [_rand(c, seed=seed + 1)],
            "Bias": [_rand(c, seed=seed + 2)],
            "Mean": [_rand(c, seed=seed + 3)],
            "Variance": [np.abs(_rand(c, seed=seed + 4)) + 0.5]}


BN_CASES = {
    # x shape, channels, data_layout
    "nchw": ((4, 3, 5, 6), 3, "NCHW"),
    "nc": ((8, 6), 6, "NCHW"),
    "ntc_time_as_channel": ((2, 5, 4), 5, "NCHW"),
    "nhwc": ((3, 4, 5, 6), 6, "NHWC"),
    "one_value_per_channel": ((1, 4, 1, 1), 4, "NCHW"),
}


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case, is_test):
    """Y, the moving statistics (momentum * old + (1 - momentum) * batch
    with the biased batch variance, in training; passed through in test)
    and SavedMean / SavedVariance, then the gradients of x, scale and bias.
    A channel with one value per batch (the last stage of a ResNet at
    32 x 32 and batch 1) normalizes to its bias, as in the JAX rule."""
    xshape, c, layout = BN_CASES[case]
    ins = _bn_ins(xshape, c, seed=7)
    attrs = dict(epsilon=1e-5, momentum=0.9, is_test=is_test,
                 data_layout=layout)
    outs = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]
    jv, tv, grads = _vjp_both("batch_norm", ins, attrs,
                              ["X", "Scale", "Bias"], ["Y"])
    for slot in outs:
        assert tv[slot].shape == jv[slot].shape, slot
        np.testing.assert_allclose(tv[slot], jv[slot], err_msg=slot, **TOL)
    if not is_test:
        x = ins["X"][0]
        axes = tuple(i for i in range(x.ndim)
                     if i != (x.ndim - 1 if layout == "NHWC" or x.ndim == 2
                              else 1))
        np.testing.assert_allclose(tv["SavedVariance"], x.var(axis=axes),
                                   **TOL)
        np.testing.assert_allclose(
            tv["VarianceOut"],
            0.9 * ins["Variance"][0] + 0.1 * x.var(axis=axes), **TOL)
    for name, (j, t) in zip(["dX", "dScale", "dBias"], grads):
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def test_batch_norm_moving_stats_get_no_gradient():
    """Mean and Variance inputs differentiated as leaves: no gradient
    reaches them from Y, MeanOut or VarianceOut."""
    ins = _bn_ins((4, 3, 5, 6), 3, seed=8)
    tins = {s: [torch.from_numpy(v[0]).requires_grad_(s in ("Mean",
                                                            "Variance"))]
            for s, v in ins.items()}
    res = treg.get("batch_norm").lower(TorchCtx(None, CPU), tins,
                                       dict(is_test=False))
    loss = sum(res[s][0].sum() for s in ("Y", "MeanOut", "VarianceOut"))
    gm, gv = torch.autograd.grad(loss, [tins["Mean"][0],
                                        tins["Variance"][0]],
                                 allow_unused=True)
    # MeanOut = 0.9 * Mean + 0.1 * batch: only the momentum term, never
    # the batch statistics' path through Y
    np.testing.assert_allclose(gm.numpy(), np.full(3, 0.9), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.full(3, 0.9), **TOL)


# --------------------------------------------------------- sgd, momentum --

def _update_ins(with_velocity):
    ins = {"Param": [_rand(4, 5, seed=9)], "Grad": [_rand(4, 5, seed=10)],
           "LearningRate": [np.array([0.03], np.float32)]}
    if with_velocity:
        ins["Velocity"] = [_rand(4, 5, seed=11)]
    return ins


def _run_both(op_type, ins, attrs):
    jres = jreg.get(op_type).lower(
        JaxCtx(None), {s: [jnp.asarray(a) for a in v]
                       for s, v in ins.items()}, attrs)
    tres = treg.get(op_type).lower(
        TorchCtx(None, CPU), {s: [torch.from_numpy(a) for a in v]
                              for s, v in ins.items()}, attrs)
    return jres, tres


def test_sgd_matches_jax():
    ins = _update_ins(False)
    jres, tres = _run_both("sgd", ins, {})
    np.testing.assert_allclose(tres["ParamOut"][0].numpy(),
                               np.asarray(jres["ParamOut"][0]), **OPT_TOL)
    np.testing.assert_allclose(tres["ParamOut"][0].numpy(),
                               ins["Param"][0] - 0.03 * ins["Grad"][0],
                               **OPT_TOL)


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["momentum", "nesterov"])
def test_momentum_matches_jax(nesterov):
    ins = _update_ins(True)
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    jres, tres = _run_both("momentum", ins, attrs)
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_allclose(tres[slot][0].numpy(),
                                   np.asarray(jres[slot][0]), err_msg=slot,
                                   **OPT_TOL)
    v = 0.9 * ins["Velocity"][0] + ins["Grad"][0]
    step = ins["Grad"][0] + 0.9 * v if nesterov else v
    np.testing.assert_allclose(tres["ParamOut"][0].numpy(),
                               ins["Param"][0] - 0.03 * step, **OPT_TOL)


# ------------------------------------------------------ mixed precision --

@pytest.mark.parametrize("op_type", ["conv2d", "mul", "matmul",
                                     "fused_attention", "softmax",
                                     "cross_entropy", "mean", "relu",
                                     "batch_norm"])
def test_amp_casts_match_the_jax_tables(op_type):
    """_apply_amp casts an op's inputs as the JAX package's does: f32 ->
    bf16 for the contractions, bf16 -> f32 for the loss ops, nothing
    else; integer inputs are left alone."""
    ins = {"A": [np.ones(3, np.float32)],
           "B": [np.ones(3, jnp.bfloat16)],
           "C": [np.ones(3, np.int64)]}
    jout = jlow._apply_amp(op_type, {s: [jnp.asarray(a) for a in v]
                                     for s, v in ins.items()})
    tins = {"A": [torch.ones(3)], "B": [torch.ones(3, dtype=torch.bfloat16)],
            "C": [torch.ones(3, dtype=torch.int64)]}
    tout = tlow._apply_amp(op_type, tins)
    for slot in ins:
        assert str(tout[slot][0].dtype).replace("torch.", "") == \
            str(jout[slot][0].dtype).replace("int32", "int64"), slot


def _amp_build(fluid):
    """image [3, 8, 8] -> conv2d(4, 3x3, no bias, relu) -> fc(5, softmax) ->
    cross_entropy -> mean, Momentum(1e-4, 0.9), under
    enable_mixed_precision."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        main.enable_mixed_precision()
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   bias_attr=False, act="relu")
        pred = fluid.layers.fc(conv, size=5, act="softmax")
        avg = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Momentum(learning_rate=1e-4,
                                 momentum=0.9).minimize(avg)
    return main, startup, conv, pred, avg


def test_amp_conv_and_fc_match_jax():
    """A conv and an fc under mixed precision, both packages from the JAX
    startup state: the conv output (no bias, as in the ResNets) is bf16 on
    both sides, the prediction f32 (fc's bias add promotes it), the loss
    and the parameters' gradients f32 and within BF16_REL of the JAX
    package's by their magnitude; the parameters stay f32 masters, and
    the step changes them as _assert_steps_agree holds."""
    jmain, jstartup, jconv, jpred, javg = _amp_build(jfluid)
    tmain, _, tconv, tpred, tavg = _amp_build(tfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    rng = np.random.RandomState(12)
    feed = {"img": rng.rand(2, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 5, (2, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters())
    fetch = [jconv.name, jpred.name, javg.name] + grads
    with jfluid.scope_guard(jscope):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
    got = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=fetch,
                                     scope=tscope)
    assert np.asarray(want[0]).dtype == jnp.bfloat16
    # the port widens a bf16 fetch to f32 exactly: its values are bf16's
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(
        got[0], got[0].astype(jnp.bfloat16).astype(np.float32))
    for name, g, w in zip(["conv", "pred", "loss"] + grads, got, want):
        _assert_scaled_close(g, np.asarray(w).astype(np.float32), BF16_REL,
                             name)
    _assert_steps_agree(tmain, state, tscope, jscope)


def _assert_scaled_close(got, want, rel, name):
    """|got - want| <= rel * (|want| + max |want|) elementwise."""
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=name)


def _assert_steps_agree(tmain, state, tscope, jscope):
    """The step moved every persistable alike in both packages: the
    f32 master parameters and their velocities by BF16_REL of their
    change, batch_norm's moving statistics by STAT_REL of theirs."""
    moving = 0
    for v in tmain.list_vars():
        if not v.persistable or v.name in ("img", "label") \
                or v.name.startswith("learning_rate"):
            continue
        got = tscope.get(v.name)
        assert got.dtype == torch.float32, v.name
        init = state[v.name]
        want = np.asarray(jscope.get(v.name)) - init
        assert np.abs(want).max() > 0, v.name
        stat = isinstance(v, tfluid.Parameter) and not v.trainable
        moving += stat
        _assert_scaled_close(got.numpy() - init, want,
                             STAT_REL if stat else BF16_REL, v.name)
    return moving


def _amp_bn_build(fluid):
    """image [3, 8, 8] -> conv2d(8, 3x3, pad 1, no bias) ->
    batch_norm(relu) -> pool2d(max 2x2) -> fc(5, softmax) ->
    cross_entropy -> mean, Momentum(1e-4, 0.9), under
    enable_mixed_precision: a ResNet's stem in small."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        main.enable_mixed_precision()
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                   padding=1, bias_attr=False)
        bn = fluid.layers.batch_norm(conv, act="relu")
        pool = fluid.layers.pool2d(bn, pool_size=2, pool_stride=2,
                                   pool_type="max")
        pred = fluid.layers.fc(pool, size=5, act="softmax")
        avg = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Momentum(learning_rate=1e-4,
                                 momentum=0.9).minimize(avg)
    return main, startup, [conv, bn, pool, pred, avg]


def test_amp_conv_batch_norm_pool_fc_match_jax():
    """batch_norm under mixed precision (bf16 input, f32 scale, bias and
    statistics, bf16 output) between a conv and a pool, both packages from
    the JAX startup state at batch 4: the conv output bit-equal, every
    activation, the loss and the gradients within BF16_REL of the JAX
    package's by their magnitude, and one Momentum step's changes, the
    moving statistics' included, as _assert_steps_agree holds them."""
    jmain, jstartup, jvars = _amp_bn_build(jfluid)
    tmain, _, _ = _amp_bn_build(tfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    rng = np.random.RandomState(12)
    feed = {"img": rng.rand(4, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 5, (4, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [v.name for v in jvars] + grads
    with jfluid.scope_guard(jscope):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
    got = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=fetch,
                                     scope=tscope)
    assert [str(np.asarray(w).dtype) for w in want[:3]] == ["bfloat16"] * 3
    np.testing.assert_array_equal(got[0], np.asarray(want[0], np.float32))
    names = ["conv", "batch_norm", "pool", "pred", "loss"] + grads
    for name, g, w in zip(names, got, want):
        _assert_scaled_close(g, np.asarray(w).astype(np.float32), BF16_REL,
                             name)
    assert _assert_steps_agree(tmain, state, tscope, jscope) == 2


def _attention_program(amp):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        if amp:
            main.enable_mixed_precision()
        q = tfluid.layers.data("q", shape=[8, 2, 4], dtype="float32")
        out = tfluid.layers.fused_attention(q, q, q)
    return main, out


def test_amp_fused_attention_raises_and_plain_does_not():
    """The port's flash kernels take fp32 only: under mixed precision the
    JAX package runs fused_attention in bf16, the port raises rather
    than run it in fp32 unasked. The same program without mixed
    precision runs."""
    feed = {"q": _rand(2, 8, 2, 4, seed=13)}
    main, out = _attention_program(amp=False)
    got, = tfluid.Executor("cpu").run(main, feed=feed, fetch_list=[out],
                                      scope=tfluid.Scope())
    assert got.shape == (2, 8, 2, 4) and np.isfinite(got).all()
    main, out = _attention_program(amp=True)
    with pytest.raises(NotImplementedError, match="bf16 flash kernel"):
        tfluid.Executor("cpu").run(main, feed=feed, fetch_list=[out],
                                   scope=tfluid.Scope())
