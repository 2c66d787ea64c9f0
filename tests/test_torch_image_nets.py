"""The JAX zoo's other image nets in the port against the JAX package, on
the CPU: vgg16, alexnet, googlenet and se_resnext (50 / 101 / 152), which
A3's dropout completes (their lrn, concat and grouped conv2d came
earlier).

- Program bytes: image_classification.build_train(model) at the JAX
  defaults (3 x 224 x 224, 1000 classes, Momentum 0.01 / 0.9) for each of
  the six, its startup program, and the inference program of the net
  (the net alone, clone(for_test=True): every dropout and batch_norm in
  test mode; se_resnext50's standing for 101 and 152, the same code at
  more depth) serialize to the JAX package's bytes, but for its int64 ->
  int32 narrowing of inferred dtypes.
- Numbers (this file: alexnet; their own files: googlenet, vgg16,
  se_resnext50): one fp32 training step from one state (the port's
  startup run on the CPU, carried into both packages by name) with every
  dropout op's dropout_prob set to 0 in both built Programs, the JAX
  grad_of's copy of the forward attrs too (the random streams differ by
  design): the loss within rtol 1e-5 and each gradient's ||port - jax|| /
  ||jax|| within the bound its file states (`check_step`); and the net's
  inference program on the same state and batch, where each dropout
  scales by 1 - p: the class probabilities within atol 1e-5 (test-mode
  batch_norm and dropout: a well-conditioned forward;
  `check_inference`). Images of at most 64 x 64 and batch 8, but
  alexnet's 67 x 67: its stride-4 conv and three 3 x 3 / 2 pools leave
  nothing below a side of 67 (at 64 its last pool has no output in
  either package). Each step and each inference program is one JAX
  compile, freed before the next.
- Alexnet has no batch_norm: its gradients agree to 1e-5 (fp32 sums in
  another order; measured 8.9e-7).
"""
import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import image_classification as jic

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.models import image_classification as tic

MODELS = ["vgg16", "alexnet", "googlenet", "se_resnext50", "se_resnext101",
          "se_resnext152"]
# dropout ops per net: vgg16's fc, alexnet's two fc, googlenet's and
# se_resnext's pool
DROPOUTS = {"vgg16": 1, "alexnet": 2, "googlenet": 1}
CLASSES, LR = 10, 1e-4
INFER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrowed(jprog, tprog):
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    return jd, td


def _train(fluid, ic, model, side, classes=1000, lr=0.01):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, avg, _ = ic.build_train(model, class_dim=classes,
                                      image_shape=(3, side, side),
                                      learning_rate=lr)
    return main, startup, avg


def _net(ic, model):
    if model.startswith("se_resnext"):
        depth = int(model[len("se_resnext"):])
        return lambda image, classes: ic.se_resnext(image, classes, depth)
    return getattr(ic, model)


def _inference(fluid, ic, model, side, classes=1000):
    """The net alone on a float32 image feed, clone(for_test=True)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.layers.data("image", shape=[3, side, side],
                                  dtype="float32")
        predict = _net(ic, model)(image, classes)
    return main.clone(for_test=True), predict


@pytest.mark.parametrize("model", MODELS)
def test_build_train_matches_the_jax_bytes(model):
    jmain, jstartup, _ = _train(jfluid, jic, model, 224)
    tmain, tstartup, _ = _train(tfluid, tic, model, 224)
    jd, td = _narrowed(jmain, tmain)
    assert td == jd
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    ops = tmain.global_block().ops
    drops = [op for op in ops if op.type == "dropout"]
    assert len(drops) == DROPOUTS.get(model, 1)
    assert not any(op.attrs["is_test"] for op in drops)
    assert sum(op.type == "momentum" for op in ops) == \
        len([p for p in tmain.all_parameters() if p.trainable])
    if model in ("se_resnext101", "se_resnext152"):
        return   # the inference net is se_resnext50's code at more depth
    jtest, _ = _inference(jfluid, jic, model, 224)
    ttest, _ = _inference(tfluid, tic, model, 224)
    jd, td = _narrowed(jtest, ttest)
    assert td == jd
    assert all(op.attrs["is_test"] for op in ttest.global_block().ops
               if op.type in ("dropout", "batch_norm"))


def _rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _dropout_off(prog):
    """Every dropout op's dropout_prob, and the JAX grad_of's copy of it
    (that package replays the forward rule from it), set to 0."""
    n = 0
    for op in prog.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
            n += 1
        elif op.type == "grad_of" and op.attrs["fwd_type"] == "dropout":
            op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
    return n


def _jax_run(main, state, feed, fetch):
    scope = jfluid.Scope()
    for name, arr in state.items():
        scope.set(name, arr)
    with jfluid.scope_guard(scope):
        out = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                     fetch_list=fetch)
    return [np.asarray(a) for a in out]


def _state_and_feed(model, side, batch):
    """The port's startup state of the small training program (by name,
    as numpy) and a batch of images in [0, 1) with labels."""
    tmain, tstartup, tavg = _train(tfluid, tic, model, side, CLASSES,
                                   lr=LR)
    scope0 = tfluid.Scope()
    tfluid.Executor("cpu").run(tstartup, scope=scope0)
    state = {v.name: scope0.get(v.name).numpy().copy()
             for v in tmain.list_vars() if v.persistable}
    rng = np.random.RandomState(7)
    feed = {"image": rng.rand(batch, 3, side, side).astype(np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}
    return tmain, tavg, state, feed


def step_errors(model, side, batch):
    """One fp32 training step in both packages from the port's startup
    state, dropout at p = 0 in both built programs: (port loss, JAX loss,
    [(gradient name, ||port - jax|| / ||jax||, ||jax|| over the largest
    gradient's norm)])."""
    tmain, tavg, state, feed = _state_and_feed(model, side, batch)
    assert _dropout_off(tmain) == DROPOUTS.get(model, 1)
    jmain = _train(jfluid, jic, model, side, CLASSES, lr=LR)[0]
    _dropout_off(jmain)
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [tavg.name] + grads
    want = _jax_run(jmain, state, feed, fetch)
    jax.clear_caches()
    got = tfluid.Executor("cpu").run(
        tmain, feed=feed, fetch_list=fetch,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    top = max(float(np.linalg.norm(w)) for w in want[1:])
    return float(got[0][0]), float(want[0][0]), [
        (name, _rel(g, w), float(np.linalg.norm(w)) / top)
        for name, g, w in zip(grads, got[1:], want[1:])]


def inference_error(model, side, batch):
    """The net's inference program (clone(for_test=True)) in both
    packages on the port's startup state: (max |port - jax| of the class
    probabilities, their shape, whether a second port run repeats the
    first)."""
    _, _, state, feed = _state_and_feed(model, side, batch)
    jtest, jpred = _inference(jfluid, jic, model, side, CLASSES)
    ttest, tpred = _inference(tfluid, tic, model, side, CLASSES)
    image = {"image": feed["image"]}
    jp, = _jax_run(jtest, state, image, [jpred.name])
    jax.clear_caches()
    scope = tio.scope_from_numpy(state, "cpu", program=ttest)
    exe = tfluid.Executor("cpu")
    tp, = exe.run(ttest, feed=image, fetch_list=[tpred.name], scope=scope)
    again, = exe.run(ttest, feed=image, fetch_list=[tpred.name],
                     scope=scope)
    return float(np.abs(tp - jp).max()), tp.shape, \
        bool(np.array_equal(tp, again))


def check_inference(model, side, batch):
    err, shape, repeats = inference_error(model, side, batch)
    assert shape == (batch, CLASSES) and repeats
    assert err <= INFER_TOL["atol"], err


def check_step(model, side, batch, n_grads, grad_max, grad_median,
               floor=0.0):
    """The step's loss within rtol 1e-5; each gradient's error within
    grad_max, or its absolute error within `floor` of the largest
    gradient's norm (a gradient that is 0 in exact arithmetic, such as a
    bias before batch_norm, is rounding noise in both); the median error
    within grad_median."""
    loss, want, errs = step_errors(model, side, batch)
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    assert len(errs) == n_grads
    for name, err, size in errs:
        assert err <= grad_max or err * size <= floor, (name, err, size)
    assert float(np.median([e[1] for e in errs])) <= grad_median


def test_alexnet_step_and_inference_match_the_jax_ones():
    check_step("alexnet", 67, 8, 16, 1e-5, 1e-5)
    check_inference("alexnet", 67, 8)
