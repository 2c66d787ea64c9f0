"""The dropout, label_smooth and split rules and layers of the port
against the JAX package's, on the CPU.

Dropout's random streams are not portable (torch.Generator against JAX's
threefry), so its training mask is held to what the rule promises, not
to the JAX package's bits:
- is_test (Out = X (1 - p), Mask ones) and p = 0 (Out = X, Mask ones)
  exactly as the JAX rule;
- Out == X * Mask and dX == dOut * Mask exactly (the grad_of of the kept
  graph: the backward reuses the forward's one draw), Mask in X's dtype
  (bf16 under mixed precision too);
- the keep rate within 5 standard errors of 1 - p over 2^16 values;
- a nonzero seed attr gives the same mask on every run, seed 0 a new one
  each run, and each step of a StaticRNN body its own;
- clone(for_test=True) and save_inference_model flip is_test, so the
  inference program scales by 1 - p, as the JAX package's does.
label_smooth (with and without PriorDist) and split (sections, num)
forward and gradient against the JAX rules at rtol = atol = 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx

from test_torch_ops import _assert_same, _grads_both, _rand

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("attrs", [
    {"dropout_prob": 0.3, "is_test": True},
    {"dropout_prob": 0.0, "is_test": False},
    {"dropout_prob": 0.0, "is_test": True, "seed": 5}])
def test_dropout_test_mode_and_p0_match_the_jax_rule(attrs):
    _assert_same("dropout", {"X": [_rand(4, 7, seed=2)]}, attrs, exact=True)


def _dropout_program(p, seed=None, shape=(64, 32)):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=list(shape[1:]),
                               dtype="float32")
        x.stop_gradient = False
        out = tfluid.layers.dropout(x, dropout_prob=p, seed=seed)
        w = tfluid.layers.data(name="w", shape=list(shape[1:]),
                               dtype="float32")
        loss = tfluid.layers.reduce_sum(
            tfluid.layers.elementwise_mul(out, w))
        tfluid.append_backward(loss)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].outputs["Mask"][0]
    return main, out, mask


def test_out_is_x_times_mask_and_the_gradient_reuses_it():
    main, out, mask = _dropout_program(0.4)
    x, w = _rand(64, 32, seed=1), _rand(64, 32, seed=2)
    calls = []
    rule = treg.get("dropout").lower

    def counted(ctx, ins, attrs):
        calls.append(1)
        return rule(ctx, ins, attrs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg.get("dropout"), "lower", counted)
        o, m, dx = tfluid.Executor("cpu").run(
            main, feed={"x": x, "w": w},
            fetch_list=[out, mask, "x@GRAD"], scope=tfluid.Scope())
    assert len(calls) == 1        # one draw: grad_of reuses its graph
    assert set(np.unique(m)) == {0.0, 1.0}
    np.testing.assert_array_equal(o, x * m)
    np.testing.assert_array_equal(dx, w * m)


def test_mask_follows_a_bf16_input():
    x = torch.randn(8, 16).bfloat16()
    outs = treg.get("dropout").lower(LowerCtx(None, CPU, run_seed=3),
                                     {"X": [x]}, {"dropout_prob": 0.5})
    assert outs["Out"][0].dtype == outs["Mask"][0].dtype == torch.bfloat16
    assert torch.equal(outs["Out"][0], x * outs["Mask"][0])


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate(p):
    main, out, mask = _dropout_program(p, shape=(256, 256))
    m, = tfluid.Executor("cpu").run(
        main, feed={"x": _rand(256, 256), "w": _rand(256, 256, seed=1)},
        fetch_list=[mask], scope=tfluid.Scope())
    keep = 1.0 - p
    se = np.sqrt(keep * p / m.size)
    assert abs(m.mean() - keep) < 5 * se, (m.mean(), keep, se)


@pytest.mark.parametrize("seed", [0, 17])
def test_a_fixed_seed_repeats_its_mask_and_seed_0_does_not(seed):
    main, out, mask = _dropout_program(0.5, seed=seed or None)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    feed = {"x": _rand(64, 32), "w": _rand(64, 32, seed=1)}
    masks = [exe.run(main, feed=feed, fetch_list=[mask], scope=scope)[0]
             for _ in range(3)]
    other = tfluid.Executor("cpu").run(main, feed=feed, fetch_list=[mask],
                                       scope=tfluid.Scope())[0]
    if seed:
        for m in masks[1:] + [other]:
            np.testing.assert_array_equal(m, masks[0])
    else:
        assert not np.array_equal(masks[0], masks[1])
        assert not np.array_equal(masks[1], masks[2])


@pytest.mark.parametrize("seed", [0, 23])
def test_each_step_of_a_static_rnn_draws_its_own_mask(seed):
    b, t, h = 8, 4, 64
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[t, h], dtype="float32")
        rnn = tfluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            rnn.output(tfluid.layers.dropout(xt, dropout_prob=0.5,
                                             seed=seed or None))
        out = rnn()
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((b, t, h), np.float32)}
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    again, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert got.shape == (b, t, h)
    for i in range(t):
        for j in range(i):
            assert not np.array_equal(got[:, i], got[:, j]), (i, j)
    assert np.array_equal(got, again) == bool(seed)


def _net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=5, act="relu")
        out = fluid.layers.dropout(h, dropout_prob=0.25)
        pred = fluid.layers.fc(input=out, size=2, act="softmax")
    return main, startup, pred


def test_the_inference_program_scales_by_one_minus_p(tmp_path):
    """clone(for_test=True) and save_inference_model flip dropout's
    is_test in both packages; the port's answers on the JAX package's
    weights equal the JAX package's (rtol = atol = 1e-6) and the hidden
    layer's X * 0.75 exactly."""
    jmain, jstartup, jpred = _net(jfluid)
    tmain, _, tpred = _net(tfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    x = _rand(4, 6, seed=9)
    jtest = jmain.clone(for_test=True)
    with jfluid.scope_guard(jscope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jtest, feed={"x": x}, fetch_list=[jpred])
    from paddle_tpu_torch import io as tio
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    ttest = tmain.clone(for_test=True)
    drop, = [op for op in ttest.global_block().ops if op.type == "dropout"]
    assert drop.attrs["is_test"] and not [
        op for op in tmain.global_block().ops
        if op.type == "dropout"][0].attrs["is_test"]
    exe = tfluid.Executor("cpu")
    hid, out = drop.inputs["X"][0], drop.outputs["Out"][0]
    got, h, o = exe.run(ttest, feed={"x": x},
                        fetch_list=[tpred.name, hid, out], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(o, h * np.float32(0.75))
    saved = tfluid.io.save_inference_model(str(tmp_path), ["x"], [tpred],
                                           exe, tmain, scope=tscope)
    assert all(op.attrs["is_test"] for op in saved.global_block().ops
               if op.type == "dropout")


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_matches_the_jax_rule(prior):
    onehot = np.eye(6, dtype=np.float32)[[0, 3, 5, 1]]
    ins = {"X": [onehot]}
    if prior:
        ins["PriorDist"] = [np.full((1, 6), 1 / 6.0, np.float32)
                            + _rand(1, 6, seed=4) * 0.01]
    attrs = {"epsilon": 0.1}
    _assert_same("label_smooth", ins, attrs)
    got, want = _grads_both("label_smooth", ins, attrs, ["Out"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("attrs", [
    {"sections": [2, 3, 7], "num": 0, "axis": 1},
    {"sections": [], "num": 4, "axis": 2},
    {"sections": [1, 2], "num": 0, "axis": 0}])
def test_split_matches_the_jax_rule(attrs):
    ins = {"X": [_rand(3, 12, 8, seed=6)]}
    _assert_same("split", ins, attrs, exact=True)
    got, want = _grads_both("split", ins, attrs, ["Out"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL)


def test_split_into_unequal_parts_raises():
    with pytest.raises(ValueError, match="does not divide"):
        treg.get("split").lower(LowerCtx(None, CPU),
                                {"X": [torch.zeros(2, 7)]},
                                {"num": 3, "axis": 1})
