"""Gradient and error clipping in the port against the JAX package, on
the CPU.

- The clip rules (clip, clip_by_norm, reduce_sum_square,
  global_norm_scale): forward and gradient (the port's grad_of against
  jax.vjp of the JAX rule) at rtol = atol = 1e-5: fp32 sums of a few dozen
  terms in another order.
- The clip classes: a small regression model (fc 13 -> 8 relu -> fc 1,
  square_error_cost, mean, SGD 0.05) built in both packages under each
  of GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm
  (one group over every parameter) and ErrorClipByValue (on the hidden
  layer's output): the same program bytes (but for the JAX package's
  int64 -> int32 narrowing), then 5 steps from the JAX package's startup
  state on the same feeds. Each loss within rtol 1e-5 and every
  parameter after the steps within atol 1e-5, and each clip moves the
  JAX package's losses away from the unclipped run's (it bites).
- The clip rules read nothing back to the host: their source holds no
  .item(), .tolist(), float(), int() or bool() of a tensor.
- error_clip_callback (the hook for custom backward builders) appends to
  a block the same clip op as the JAX package's, which clips a gradient
  of 3.0 to the error clip's max exactly; a var whose error_clip is not
  an ErrorClip raises TypeError in both.
"""
import inspect
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.ops import basic as tbasic

from test_torch_ops import _assert_same, _grads_both, _rand

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS, BATCH = 5, 16
CLIPS = [("GradientClipByValue", dict(max=0.3)),
         ("GradientClipByNorm", dict(clip_norm=0.5)),
         ("GradientClipByGlobalNorm", dict(clip_norm=0.5)),
         ("ErrorClipByValue", dict(max=0.02, min=-0.01))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("op_type,attrs", [
    ("clip", {"min": -0.4, "max": 0.7}),
    ("clip_by_norm", {"max_norm": 1.5}),
    ("clip_by_norm", {"max_norm": 100.0}),
    ("reduce_sum_square", {}),
])
def test_clip_rule_and_gradient_match_the_jax_rule(op_type, attrs):
    ins = {"X": [_rand(4, 6, seed=3)]}
    _assert_same(op_type, ins, attrs)
    got, want = _grads_both(op_type, ins, attrs, ["Out"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("total", [0.04, 9.0, 0.0])
def test_global_norm_scale_matches_the_jax_rule(total):
    """min(1, clip / max(sqrt(X), 1e-12)): below, above and at a zero
    norm."""
    _assert_same("global_norm_scale",
                 {"X": [np.array([total], np.float32)]}, {"clip_norm": 1.0})


def test_clip_rules_read_nothing_on_the_host():
    for fn in (tbasic._clip_op, tbasic._clip_by_norm,
               tbasic._reduce_sum_square, tbasic._global_norm_scale):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", "float(", "int(", "bool(",
                     ".cpu(", ".numpy("):
            assert call not in src, (fn.__name__, call)


def _build(fluid, clip):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        hidden = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=hidden, size=1)
        avg = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if clip is not None:
            attr = getattr(fluid.clip, clip[0])(**clip[1])
            if clip[0] == "ErrorClipByValue":
                hidden.error_clip = attr
            else:
                fluid.clip.set_gradient_clip(attr)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(avg)
    return main, startup, avg


def _feeds():
    rng = np.random.RandomState(41)
    w = rng.randn(13, 1).astype(np.float32) * 2
    out = []
    for _ in range(STEPS):
        x = rng.rand(BATCH, 13).astype(np.float32)
        out.append({"x": x, "y": x @ w})
    return out


def _same_bytes(jprog, tprog):
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    return td == jd


def _jax_run(main, startup, avg, feeds):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state = {v.name: np.array(scope.get(v.name))
                 for v in main.list_vars() if v.persistable}
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[avg])[0])
                        .reshape(-1)[0]) for f in feeds]
    return state, scope, losses


@pytest.mark.parametrize("clip", CLIPS, ids=[c[0] for c in CLIPS])
def test_clip_classes_train_as_the_jax_ones(clip):
    jmain, jstartup, javg = _build(jfluid, clip)
    tmain, _, tavg = _build(tfluid, clip)
    assert _same_bytes(jmain, tmain)
    kinds = {op.type for op in tmain.global_block().ops}
    assert {"clip", "clip_by_norm", "global_norm_scale"} & kinds
    feeds = _feeds()
    state, jscope, want = _jax_run(jmain, jstartup, javg, feeds)
    plain = _jax_run(*_build(jfluid, None), feeds)[2]
    assert max(abs(a - b) for a, b in zip(want, plain)) > 1e-3
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    exe = tfluid.Executor("cpu")
    got = [float(exe.run(tmain, feed=f, fetch_list=[tavg],
                         scope=tscope)[0].reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for p in tmain.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(),
                                   np.asarray(jscope.get(p.name)), atol=1e-5,
                                   err_msg=p.name)


def _callback_program(fluid, error_clip):
    """fc 4 -> 2 whose output carries `error_clip`, then a fill_constant
    of 3.0 into its @GRAD and error_clip_callback on that grad (as
    tests/unittests/test_api_parity_shims.py drives the JAX package's)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=2)
        h.error_clip = error_clip
        block = main.global_block()
        g = block.create_var(name=h.name + "@GRAD", shape=h.shape,
                             dtype="float32")
        block.append_op(
            type="fill_constant", outputs={"Out": [g.name]},
            attrs={"shape": [1, 2], "value": 3.0, "dtype": "float32"},
            infer_shape=False)
        n_before = len(block.ops)
        fluid.clip.error_clip_callback(block, {g.name: h.name})
    return main, startup, g, n_before


def test_error_clip_callback_appends_the_jax_clip():
    jmain, jstartup, jg, jn = _callback_program(
        jfluid, jfluid.clip.ErrorClipByValue(max=0.5))
    tmain, tstartup, tg, tn = _callback_program(
        tfluid, tfluid.clip.ErrorClipByValue(max=0.5))
    ops = tmain.global_block().ops
    assert len(ops) == tn + 1 and len(jmain.global_block().ops) == jn + 1
    assert (ops[-1].type, ops[-1].attrs["min"], ops[-1].attrs["max"]) == \
        ("clip", -0.5, 0.5)
    assert _same_bytes(jmain, tmain)
    feed = {"x": np.ones((1, 4), np.float32)}
    scope = tfluid.Scope()
    exe = tfluid.Executor("cpu")
    exe.run(tstartup, scope=scope)
    got = exe.run(tmain, feed=feed, fetch_list=[tg], scope=scope)[0]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        want = np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jg])[0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.full((1, 2), 0.5, np.float32))
    for fluid in (jfluid, tfluid):
        with pytest.raises(TypeError, match="BaseErrorClipAttr"):
            _callback_program(fluid, object())
