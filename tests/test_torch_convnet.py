"""The port's conv-net path against the JAX package, end to end on the CPU:
zoo `mnist` (recognize_digits' LeNet) and the book's resnet_cifar10.

- Program bytes: zoo `mnist` (recognize_digits.build, Adam) and
  image_classification.build_train("resnet50") at 3 x 32 x 32 (which the
  JAX package's own rule, image_shape[-1] <= 64, makes resnet_cifar10 of
  depth 32) serialize to the JAX package's bytes, but for its int64 ->
  int32 narrowing of inferred dtypes (x64 is off there).
- Training: LeNet and resnet_cifar10 depth 20 built with Momentum(1e-4,
  0.9) (lr 1e-4 keeps the loss clear of cross_entropy's 46.0517 clamp) at
  batch 4, the JAX package's startup state carried into the port by
  io.scope_from_numpy, then 20 steps in both on the same numpy feeds.
- Mixed precision: LeNet under enable_mixed_precision, 5 steps.
- Serving: ResNet-50 (resnet_imagenet, depth 50) on a uint8 image feed
  (cast, scaled by 1/255) at 3 x 32 x 32, saved by the port's
  io.save_inference_model (batch_norm flipped to is_test) and answered by
  its InferenceEngine on the CPU, against the JAX package loading the
  same directory: rtol = atol = 1e-5 on the class probabilities
  (inference normalizes by the moving statistics, so the forward is
  well-conditioned: fp32 sums in another order through 50 layers).

Tolerances (a ReLU whose input lies within fp32 rounding of 0 takes
another branch in each package, and the batch_norm backward after it
spreads that element's gradient over its channel: on resnet_cifar10 such
a flip happens on about half the steps; LeNet has no batch_norm):
- losses: rtol 1e-5 for LeNet (measured 2.5e-7), 1e-4 for resnet_cifar10
  (measured 1.0e-5); 2e-2 in bf16 (8 bits of mantissa);
- step 1's gradients, per parameter, as ||port - jax|| / ||jax||: 1e-5
  for LeNet (measured 3.6e-7), 5e-2 for resnet_cifar10. From the same
  state, a step's gradients agree to 1e-5 without a flip and to 5e-4 -
  2.3e-2 with one (measured over 20 steps);
- parameters after 20 steps: their change over the steps, ||port change
  - jax change|| / ||jax change||, within 1e-4 for LeNet (measured
  2.0e-6) and 0.15 for resnet_cifar10 (measured: median 1.3%, worst
  4.9%: Momentum sums the steps' gradients above); batch_norm's moving
  statistics, a function of the forward only, rtol = atol = 1e-4
  (measured 1.5e-5 relative to their largest value).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import image_classification as jic
from paddle_tpu.models import recognize_digits as jrd
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.models import image_classification as tic
from paddle_tpu_torch.models import recognize_digits as trd
from paddle_tpu_torch.serving import InferenceEngine

BATCH, STEPS, LR = 4, 20, 1e-4
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_RTOL = {"lenet": 1e-5, "resnet20": 1e-4}
GRAD_TOL = {"lenet": 1e-5, "resnet20": 5e-2}
CHANGE_TOL = {"lenet": 1e-4, "resnet20": 0.15}
STAT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are small: one intra-op thread does, and leaves the
    other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bytes(jprog, tprog):
    """program_to_bytes equal but for the JAX package's int64 -> int32
    narrowing; returns the number of narrowed vars."""
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    narrowed = 0
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
                narrowed += 1
    assert td == jd
    return narrowed


def _built(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn()
    return main, startup, out


def test_zoo_mnist_program_matches_the_jax_one():
    """zoo `mnist` is recognize_digits.build(nn_type="conv"): the LeNet,
    cross_entropy, mean, accuracy and Adam."""
    jmain, jstartup = jzoo.build("mnist")
    tmain, tstartup, _ = _built(tfluid, lambda: trd.build(nn_type="conv"))
    assert _same_bytes(jmain, tmain) <= 2
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    types = {op.type for op in tmain.global_block().ops}
    assert {"conv2d", "pool2d", "mul", "softmax", "cross_entropy",
            "grad_of", "adam"} <= types


@pytest.mark.parametrize("kwargs", [{}, {"uint8_input": True},
                                    {"use_bf16": True}],
                         ids=["fp32", "uint8", "bf16"])
def test_build_train_resnet50_small_image_matches_the_jax_one(kwargs):
    """build_train("resnet50", image_shape=(3, 32, 32)) is resnet_cifar10
    of depth 32 by the JAX package's rule, with Momentum: the same bytes,
    the uint8 feed's cast and 1/255 scale and the mixed-precision flag
    included."""
    args = dict(model="resnet50", class_dim=10, image_shape=(3, 32, 32),
                **kwargs)
    jmain, jstartup, _ = _built(jfluid, lambda: jic.build_train(**args))
    tmain, tstartup, _ = _built(tfluid, lambda: tic.build_train(**args))
    assert _same_bytes(jmain, tmain) <= 2
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    ops = tmain.global_block().ops
    assert sum(op.type == "conv2d" for op in ops) == 1 + 3 * 5 * 2 + 2
    assert sum(op.type == "momentum" for op in ops) == \
        len([p for p in tmain.all_parameters() if p.trainable])
    assert tmain._amp == bool(kwargs.get("use_bf16"))


@pytest.mark.parametrize("model", ["vgg16", "alexnet", "googlenet",
                                   "se_resnext50"])
def test_unported_models_raise_naming_the_roadmap(model):
    """The four waited only for dropout (ROADMAP A3, now ported; they
    raised before): build_train builds each at the JAX defaults to the
    JAX package's bytes, with its dropout layers in training mode
    (tests/test_torch_image_nets.py holds their numbers)."""
    jmain, _, _ = _built(jfluid, lambda: jic.build_train(model, class_dim=10))
    tmain, _, out = _built(tfluid, lambda: tic.build_train(model,
                                                           class_dim=10))
    assert len(out) == 4
    assert _same_bytes(jmain, tmain) <= 2
    drops = [op for op in tmain.global_block().ops if op.type == "dropout"]
    assert drops and not any(op.attrs["is_test"] for op in drops)


def test_img_conv_group_dropout_raises_naming_the_roadmap():
    """A nonzero conv_batchnorm_drop_rate puts a dropout after each
    batch_norm (it raised before dropout was ported, ROADMAP A3): the JAX
    package's program bytes."""
    def build(fluid):
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        return fluid.nets.img_conv_group(
            img, conv_num_filter=[4, 4], pool_size=2,
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=0.5)
    jmain, jstartup, _ = _built(jfluid, lambda: build(jfluid))
    tmain, tstartup, _ = _built(tfluid, lambda: build(tfluid))
    _same_bytes(jmain, tmain)
    _same_bytes(jstartup, tstartup)
    assert [op.type for op in tmain.global_block().ops].count("dropout") == 2


def test_img_conv_group_matches_the_jax_one():
    """The VGG block without dropout: two conv + batch_norm + relu, then a
    max pool: the same program bytes."""
    def build(fluid):
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        return fluid.nets.img_conv_group(
            img, conv_num_filter=[4, 4], pool_size=2, pool_stride=2,
            conv_act="relu", conv_with_batchnorm=True)
    jmain, jstartup, _ = _built(jfluid, lambda: build(jfluid))
    tmain, tstartup, _ = _built(tfluid, lambda: build(tfluid))
    _same_bytes(jmain, tmain)
    _same_bytes(jstartup, tstartup)


# ------------------------------------------------------------ training --

def _lenet(fluid, rd, use_bf16=False):
    def build():
        if use_bf16:
            fluid.default_main_program().enable_mixed_precision()
        img, label, avg, _ = rd.build(nn_type="conv", with_optimizer=False)
        fluid.optimizer.Momentum(learning_rate=LR,
                                 momentum=0.9).minimize(avg)
        return avg
    return build


def _resnet20(fluid, ic):
    def build():
        img = fluid.layers.data("img", shape=[3, 32, 32], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = ic.resnet_cifar10(img, class_dim=10, depth=20)
        avg = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Momentum(learning_rate=LR,
                                 momentum=0.9).minimize(avg)
        return avg
    return build


def _feed(model, step):
    rng = np.random.RandomState(200 + step)
    if model == "resnet20":
        return {"img": rng.rand(BATCH, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
    return {"img": rng.rand(BATCH, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}


def _train_both(model, steps, use_bf16=False):
    """Both packages' `steps` steps from the JAX startup state, fetching
    the loss and every gradient each step (one fetch list: one JAX
    compile). Returns (port main, initial state, JAX losses, port
    losses, JAX step-1 grads, port step-1 grads, JAX scope, port
    scope)."""
    if model == "resnet20":
        jb, tb = _resnet20(jfluid, jic), _resnet20(tfluid, tic)
    else:
        jb = _lenet(jfluid, jrd, use_bf16)
        tb = _lenet(tfluid, trd, use_bf16)
    jmain, jstartup, javg = _built(jfluid, jb)
    tmain, _, tavg = _built(tfluid, tb)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    fetch = [tavg.name] + grads
    jl, tl, jg, tg = [], [], None, None
    for step in range(steps):
        feed = _feed(model, step)
        with jfluid.scope_guard(jscope):
            jres = jexe.run(jmain, feed=feed, fetch_list=fetch)
        tres = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
        tl.append(float(tres[0].reshape(-1)[0]))
        if step == 0:
            jg = dict(zip(grads, (np.asarray(a, np.float32)
                                  for a in jres[1:])))
            tg = dict(zip(grads, tres[1:]))
    return dict(tmain=tmain, state=state, jl=jl, tl=tl, jg=jg, tg=tg,
                jscope=jscope, tscope=tscope)


@pytest.fixture(scope="module", params=["lenet", "resnet20"])
def trained(request):
    return request.param, _train_both(request.param, STEPS)


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_losses_agree_over_twenty_steps(trained):
    """Step 1's loss is the forward pass from the same state; every later
    one follows 1-19 Momentum updates, each on its own batch. The loss
    stays clear of cross_entropy's 46.0517 clamp."""
    model, r = trained
    assert len(r["tl"]) == STEPS
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=LOSS_RTOL[model])
    assert max(r["tl"]) < 10


def test_step_one_gradients_agree(trained):
    model, r = trained
    assert len(r["tg"]) >= 6
    for name, got in r["tg"].items():
        want = r["jg"][name]
        assert got.shape == want.shape, name
        assert _norm_rel(got, want) <= GRAD_TOL[model], name
        assert np.abs(want).max() > 0, name


def test_parameters_and_moving_stats_agree_after_twenty_steps(trained):
    """Every trainable parameter's change and every velocity within
    CHANGE_TOL of the JAX package's (the velocities start at 0); batch_norm's moving mean and
    variance (which no update op touches: they move by the batch
    statistics alone) within STAT_TOL; the learning rate unchanged."""
    model, r = trained
    tmain, state = r["tmain"], r["state"]
    kinds = {"param": 0, "velocity": 0, "moving": 0}
    for v in tmain.list_vars():
        if not v.persistable or v.name in ("img", "label"):
            continue
        got = r["tscope"].get(v.name).numpy()
        want = np.asarray(r["jscope"].get(v.name))
        if isinstance(v, tfluid.Parameter) and not v.trainable:
            np.testing.assert_allclose(got, want, err_msg=v.name,
                                       **STAT_TOL)
            assert not np.array_equal(got, state[v.name]), v.name
            kinds["moving"] += 1
        elif v.name.startswith("learning_rate"):
            np.testing.assert_array_equal(got, want)
        else:
            change = _norm_rel(got - state[v.name], want - state[v.name])
            assert change <= CHANGE_TOL[model], (v.name, change)
            kinds["velocity" if "velocity" in v.name else "param"] += 1
    assert kinds["param"] == kinds["velocity"] > 0
    n_bn = sum(op.type == "batch_norm" for op in tmain.global_block().ops)
    assert kinds["moving"] == 2 * n_bn == (0 if model == "lenet" else 42)


def test_lenet_mixed_precision_matches_jax():
    """LeNet with enable_mixed_precision: 5 steps, the losses and step 1's
    gradients (f32 for the f32 master parameters) within BF16_TOL."""
    r = _train_both("lenet", 5, use_bf16=True)
    np.testing.assert_allclose(r["tl"], r["jl"], **BF16_TOL)
    for name, got in r["tg"].items():
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, r["jg"][name], err_msg=name,
                                   **BF16_TOL)
    for p in r["tmain"].all_parameters():
        assert r["tscope"].get(p.name).dtype == torch.float32


# -------------------------------------------------------------- serving --

def test_resnet50_served_from_uint8_feeds_matches_jax(tmp_path):
    """The port builds ResNet-50 on a uint8 feed, runs its startup program
    and saves the inference program: every batch_norm is_test, the uint8
    image feed kept. Its InferenceEngine answers two requests (1 and 3
    images); the JAX package loads the same directory and answers the
    batch of 4: probabilities within 1e-5, rows summing to 1."""
    def build():
        raw = tfluid.layers.data("image", shape=[3, 32, 32], dtype="uint8")
        img = tfluid.layers.scale(tfluid.layers.cast(raw, "float32"),
                                  scale=1.0 / 255.0)
        return tic.resnet_imagenet(img, class_dim=10, depth=50)
    main, startup, pred = _built(tfluid, build)
    startup.random_seed = 7
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    program = tio.save_inference_model(str(tmp_path), ["image"], [pred],
                                       exe, main, scope=scope)
    bns = [op for op in program.global_block().ops
           if op.type == "batch_norm"]
    assert len(bns) == 53 and all(op.attrs["is_test"] for op in bns)
    images = np.random.RandomState(8).randint(
        0, 256, (4, 3, 32, 32)).astype(np.uint8)
    engine = InferenceEngine(str(tmp_path), device="cpu",
                             batch_buckets=[1, 4], warmup=False)
    try:
        futs = [engine.submit({"image": images[:1]}),
                engine.submit({"image": images[1:]})]
        got = np.concatenate([f.result(120).numpy()[pred.name]
                              for f in futs])
    finally:
        engine.close()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, feeds, fetch = jfluid.io.load_inference_model(str(tmp_path),
                                                             jexe)
        assert feeds == ["image"]
        want, = jexe.run(jprog, feed={"image": images}, fetch_list=fetch)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got.std(axis=1).min() > 1e-4      # not a uniform answer
