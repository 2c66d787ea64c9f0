"""ResNet-50 (image_classification.resnet_imagenet, depth 50) in the port
against the JAX package on the CPU, at 3 x 32 x 32 and batch 4.

- Program bytes: the training program (resnet_imagenet, cross_entropy,
  mean, Momentum) built directly at 3 x 32 x 32 serializes to the JAX
  package's bytes.
- One training step from the same state (the port's startup run on the
  CPU, carried into both packages by name): the loss, every parameter's
  gradient, and the parameters, velocities and batch_norm moving
  statistics after Momentum(1e-4, 0.9)'s update.

The step runs three times: the port in fp32 (as users run it), and both
packages in float64 (their float32 declarations and explicit float32
casts widened for the run: `_float64`; one JAX compile, this one). The
float64 runs hold the port's semantics to the JAX package's tightly; the
fp32 run is held to that float64 result by the fp32 error of the
computation itself.

That error is large here. At 32 x 32 the last stage's maps are 1 x 1, so
its batch_norms normalize 4 values per channel, and their backward is
steep where those nearly agree; ReLUs whose inputs lie within rounding of
0 branch by rounding. Measured on this batch and state (the relative
error of a gradient is ||a - b|| / ||b||):
- the port in float64 against the JAX package in float64: largest
  3.1e-11, median 2.4e-11; losses 5.144335844578 and 5.144335844578;
- the port in fp32 against float64: largest 1.9e-2, median 1.1e-2; the
  loss 5.141912 (relative 4.7e-4);
- the JAX package's own fp32 against float64, for scale: largest 0.141,
  median 0.099, ten times the port's; the loss 5.142616.
Tolerances:
- float64, port against JAX: relative 1e-8 for the loss, every gradient
  and every change the step makes;
- fp32 against float64: loss rtol 1e-3; gradients at most 4e-2 for every
  parameter and 2.5e-2 for the median one; each parameter's change and
  each velocity (lr * the gradient, and the gradient, from zero velocity)
  at most 6e-2 (measured 2.8e-2: an fp32 parameter rounds its change
  of about 1e-4 of itself); the moving statistics (0.9 * init + 0.1 *
  the batch's) rtol = atol = 1e-3 (measured 2.1e-4).
"""
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import image_classification as jic
from paddle_tpu.ops import basic as jbasic
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import optimizer_ops as jopt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import image_classification as tic
from paddle_tpu_torch.ops import basic as tbasic
from paddle_tpu_torch.ops import sequence_ops as tseq

BATCH, SIZE, LR = 4, 32, 1e-4
F64_REL = 1e-8
LOSS_RTOL, GRAD_MAX, GRAD_MEDIAN, CHANGE_MAX = 1e-3, 4e-2, 2.5e-2, 6e-2
STAT_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, ic, dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("image", shape=[3, SIZE, SIZE], dtype=dtype)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = ic.resnet_imagenet(img, class_dim=10, depth=50)
        avg = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Momentum(learning_rate=LR,
                                 momentum=0.9).minimize(avg)
    return main, startup, avg


def test_resnet50_training_program_matches_the_jax_one():
    jmain, jstartup, _ = _build(jfluid, jic)
    tmain, tstartup, _ = _build(tfluid, tic)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        jd = json.loads(jdesc.program_to_bytes(j))
        td = json.loads(tdesc.program_to_bytes(t))
        assert td == jd
    ops = tmain.global_block().ops
    assert sum(op.type == "conv2d" for op in ops) == 53
    assert sum(op.type == "batch_norm" for op in ops) == 53
    assert sum(op.type == "momentum" for op in ops) == 53 + 2 * 53 + 2


def _rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


class _Jnp64(types.ModuleType):
    """jax.numpy with float32 read as float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _float64(mp):
    """Within the MonkeyPatch `mp`: the port makes a declared float32 var
    float64 and keeps a float64 tensor's .float() float64; the JAX
    package's conv-net rules read jnp.float32 as float64 (jax_enable_x64
    is the caller's to set and restore)."""
    def wide(name, narrow=treg.torch_dtype):
        dtype = narrow(name)
        return torch.float64 if dtype == torch.float32 else dtype

    for mod in (treg, texecutor, tbasic, tseq):
        mp.setattr(mod, "torch_dtype", wide)
    to_float = torch.Tensor.float
    mp.setattr(torch.Tensor, "float",
               lambda self, *a, **k: self if self.dtype == torch.float64
               else to_float(self, *a, **k))
    for mod in (jnn, jbasic, jopt):
        mp.setattr(mod, "jnp", _Jnp64("jnp"))


def _port_step(tmain, state, feed, fetch):
    scope = tio.scope_from_numpy(state, "cpu", program=tmain)
    res = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=fetch,
                                     scope=scope)
    return res, {n: scope.get(n).numpy() for n in state}


def _stat_excess(got, want):
    """How far `got` lies outside STAT_TOL of `want` (<= 0: inside)."""
    return float((np.abs(got - want) - STAT_TOL["atol"]
                  - STAT_TOL["rtol"] * np.abs(want)).max())


def _jax_step64(state, feed, fetch):
    """The JAX package's step in float64 (jax_enable_x64 on, its float32
    casts widened): (fetches, {persistable: value after the step}), as
    numpy; nothing of the run is kept."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            _float64(mp)
            jmain, _, _ = _build(jfluid, jic, dtype="float64")
            jscope = jfluid.Scope()
            for name, arr in state.items():
                jscope.set(name, arr.astype(np.float64)
                           if arr.dtype == np.float32 else arr)
            with jfluid.scope_guard(jscope):
                res = jfluid.Executor(jfluid.CPUPlace()).run(
                    jmain, feed=feed, fetch_list=fetch)
            out = ([np.asarray(a) for a in res],
                   {n: np.asarray(jscope.get(n)) for n in state})
    finally:
        jax.config.update("jax_enable_x64", x64)
    jax.clear_caches()
    return out


def _errors(tmain, state, got, got_state, want, want_state, fp32):
    """Per gradient, ||got - want|| / ||want||; per persistable but the
    feeds and the learning rate, (name, is a moving statistic, the error
    of its change, or with fp32 a moving statistic's excess over
    STAT_TOL)."""
    grad_errs = [_rel(a, b) for a, b in zip(got[1:], want[1:])]
    changes = []
    for v in tmain.list_vars():
        name = v.name
        if not v.persistable or name in ("image", "label") \
                or name.startswith("learning_rate"):
            continue
        init = state[name].astype(np.float64)
        moving = isinstance(v, tfluid.Parameter) and not v.trainable
        changes.append((name, moving, _stat_excess(
            got_state[name], want_state[name]) if fp32 and moving
            else _rel(got_state[name] - init, want_state[name] - init)))
    return grad_errs, changes


@pytest.fixture(scope="module")
def steps():
    """The three runs of the step, reduced to what the tests compare (the
    arrays of three ResNet-50 states are not kept): the losses, and per
    gradient and per persistable the port's float64 and fp32 errors
    against the JAX package's float64."""
    tmain, tstartup, tavg = _build(tfluid, tic)
    tscope0 = tfluid.Scope()
    tfluid.Executor("cpu").run(tstartup, scope=tscope0)
    state = {v.name: tscope0.get(v.name).numpy().copy()
             for v in tmain.list_vars() if v.persistable}
    del tscope0
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [tavg.name] + grads
    j64, j64_state = _jax_step64(state, feed, fetch)

    with pytest.MonkeyPatch.context() as mp:
        _float64(mp)
        t64, t64_state = _port_step(tmain, state, feed, fetch)
    out = dict(grads=grads, dtypes={str(a.dtype) for a in t64 + j64})
    g64, c64 = _errors(tmain, state, t64, t64_state, j64, j64_state, False)
    l64 = float(t64[0][0])
    del t64, t64_state

    t32, t32_state = _port_step(tmain, state, feed, fetch)
    g32, c32 = _errors(tmain, state, t32, t32_state, j64, j64_state, True)
    out["losses"] = (float(t32[0][0]), l64, float(j64[0][0]))
    out["grad_errs"] = [
        (name, e64, e32, a.dtype == np.float32 and a.shape == b.shape
         and bool(np.isfinite(a).all()))
        for name, e64, e32, a, b in zip(grads, g64, g32, t32[1:], j64[1:])]
    out["changes"] = [(name, moving, e64, e32) for (name, moving, e64),
                      (_, _, e32) in zip(c64, c32)]
    return out


def test_resnet50_step_loss_and_gradients_agree(steps):
    r = steps
    l32, l64, j64 = r["losses"]
    assert len(r["grads"]) == 53 + 2 * 53 + 2
    assert r["dtypes"] == {"float64"}
    np.testing.assert_allclose(l64, j64, rtol=F64_REL)
    assert np.isfinite(l32) and l32 < 10
    np.testing.assert_allclose(l32, j64, rtol=LOSS_RTOL)
    for name, e64, e32, ok32 in r["grad_errs"]:
        assert e64 <= F64_REL, (name, e64)
        assert ok32, name
        assert e32 <= GRAD_MAX, (name, e32)
    assert float(np.median([e[2] for e in r["grad_errs"]])) <= GRAD_MEDIAN


def test_resnet50_step_updates_agree(steps):
    """Momentum's first step from zero velocity: velocity = grad and
    param -= lr * grad; the moving statistics move by the batch
    statistics and no update op touches them. float64: the port's every
    change within F64_REL of the JAX package's; fp32: within CHANGE_MAX
    of it, the moving statistics at STAT_TOL."""
    moving, changed = 0, 0
    for name, is_moving, e64, e32 in steps["changes"]:
        assert e64 <= F64_REL, (name, e64)
        if is_moving:
            assert e32 <= 0, (name, "outside STAT_TOL by", e32)
            moving += 1
        else:
            assert e32 <= CHANGE_MAX, (name, e32)
            changed += 1
    assert moving == 2 * 53 and changed == 2 * (53 + 2 * 53 + 2)
