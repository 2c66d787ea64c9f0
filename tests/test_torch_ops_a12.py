"""The op rules, layers and initializers of ROADMAP A12 (the rest of the
JAX package's ops/basic.py and ops/nn_ops.py) against the JAX package's.

Each rule runs through both registries on the same inputs, made with
numpy from a seed (`_run_both`), and each differentiable one through the
port's `grad_of` against jax.vjp of the JAX rule (`_grads_both`), both
from tests/test_torch_ops.py. Tolerance: that file's rtol = atol = 1e-5
where the two sides do fp32 arithmetic in a different order, exact where
they only move or select values. The random rules are held on shape and
the mean and standard deviation of a large draw (the two packages' random
streams differ by design); nce, whose cost depends on its draw, is held
to the JAX rule's formula on the port's own SampleLabels. Each layer
builds the JAX package's program bytes, up to the JAX package's int64 ->
int32 narrowing of inferred dtypes.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TorchCtx

from test_torch_ops import TOL, _grads_both, _run_both

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _uniform(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ids(n, hi, seed=0, shape=None):
    return np.random.RandomState(seed).randint(0, hi, shape or (n, 1)) \
        .astype(np.int64)


def _same(op_type, ins, attrs, exact=False):
    jout, tout = _run_both(op_type, ins, attrs)
    assert set(jout) >= set(tout), (op_type, sorted(jout), sorted(tout))
    for slot in tout:
        for j, t in zip(jout[slot], tout[slot]):
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            if exact:
                np.testing.assert_array_equal(t, j.astype(t.dtype),
                                              err_msg=slot)
            else:
                np.testing.assert_allclose(t, j, err_msg=slot, **TOL)


def _perm(n, seed):
    return np.random.RandomState(seed).permutation(n)[:, None].astype(
        np.int64)


# (op type, inputs, attrs, exact, output slots differentiated)
CASES = [
    ("minus", {"X": [_rand(3, 4)], "Y": [_rand(3, 4, seed=1)]}, {}, True,
     ["Out"]),
    ("expand", {"X": [_rand(2, 3)]}, {"expand_times": [2, 3]}, True,
     ["Out"]),
    ("reduce_mean", {"X": [_rand(2, 3, 4)]}, {"dim": 1}, False, ["Out"]),
    ("reduce_mean", {"X": [_rand(2, 3, 4)]},
     {"dim": [0, 2], "keep_dim": True}, False, ["Out"]),
    ("reduce_max", {"X": [_rand(2, 3, 4)]}, {"dim": -1}, True, ["Out"]),
    ("reduce_max", {"X": [_rand(2, 3, 4)]}, {"reduce_all": True}, True,
     ["Out"]),
    ("reduce_min", {"X": [_rand(2, 3, 4)]}, {"dim": [1, 2]}, True, ["Out"]),
    ("reduce_prod", {"X": [_uniform(2, 3, 4, lo=0.5, hi=1.5)]},
     {"dim": [0, 2]}, False, ["Out"]),
    ("reduce_prod", {"X": [_uniform(2, 3, 4, lo=0.5, hi=1.5)]},
     {"reduce_all": True, "keep_dim": True}, False, ["Out"]),
    ("shape", {"Input": [_rand(2, 5, 3)]}, {}, True, []),
    ("arg_max", {"X": [_rand(4, 7)]}, {"axis": -1}, True, []),
    ("arg_max", {"X": [_rand(4, 7, 3)]}, {"axis": 1}, True, []),
    ("fill_zeros_like", {"X": [_rand(3, 2)]}, {}, True, []),
    ("fill", {}, {"value": [1.5, -2.0, 3.0, 0.25, 7.0, 8.0],
                  "shape": [2, 3], "dtype": "float32"}, True, []),
    ("fill", {}, {"value": [1.0, 2.0, 3.0], "shape": [3],
                  "dtype": "int32"}, True, []),
    ("is_empty", {"X": [_rand(2, 3)]}, {}, True, []),
    ("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {}, True, []),
    ("multiplex", {"X": [_rand(4, 3, seed=s) for s in range(3)],
                   "Ids": [np.array([[2], [0], [1], [2]], np.int32)]}, {},
     True, ["Out"]),
    ("cumsum", {"X": [_rand(3, 5)]}, {"axis": 1}, False, ["Out"]),
    ("cumsum", {"X": [_rand(3, 5)]}, {"axis": 0, "exclusive": True}, False,
     ["Out"]),
    ("cumsum", {"X": [_rand(3, 5)]}, {"axis": -1, "reverse": True}, False,
     ["Out"]),
    ("cumsum", {"X": [_rand(3, 5)]},
     {"axis": 1, "reverse": True, "exclusive": True}, False, ["Out"]),
    ("gather", {"X": [_rand(6, 4)], "Index": [_ids(5, 6)]}, {}, True,
     ["Out"]),
    ("scatter", {"X": [_rand(6, 4)], "Ids": [_perm(6, 1)[:3]],
                 "Updates": [_rand(3, 4, seed=2)]}, {}, True, ["Out"]),
    ("wn_norm", {"X": [_rand(4, 3, 2, 2)]}, {"dim": 1}, False, ["Out"]),
    ("wn_norm", {"X": [_rand(5, 3)]}, {"dim": None}, False, ["Out"]),
    ("weight_norm", {"G": [_uniform(3, lo=0.5, hi=2.0)],
                     "V": [_rand(4, 3)]}, {"dim": 1}, False, ["Out"]),
    ("weight_norm", {"G": [_uniform(1, lo=0.5, hi=2.0)],
                     "V": [_rand(4, 3, 2)]}, {"dim": None}, False, ["Out"]),
    ("conv2d_transpose", {"Input": [_rand(2, 3, 5, 5)],
                          "Filter": [_rand(3, 4, 3, 3, seed=1)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}, False,
     ["Output"]),
    ("conv2d_transpose", {"Input": [_rand(1, 2, 4, 6)],
                          "Filter": [_rand(2, 3, 2, 3, seed=1)]},
     {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]}, False,
     ["Output"]),
    ("maxout", {"X": [_rand(2, 6, 3, 3)]}, {"groups": 3}, True, ["Out"]),
    ("l2_normalize", {"X": [_rand(3, 5)]}, {"axis": 1, "epsilon": 1e-10},
     False, ["Out"]),
    ("l2_normalize", {"X": [_rand(3, 4, 2)]}, {"axis": 0}, False, ["Out"]),
    ("log_softmax", {"X": [_rand(4, 9) * 3]}, {}, False, ["Out"]),
    ("smooth_l1_loss", {"X": [_rand(4, 3)], "Y": [_rand(4, 3, seed=1)]},
     {"sigma": 2.0}, False, ["Out"]),
    ("smooth_l1_loss", {"X": [_rand(4, 3)], "Y": [_rand(4, 3, seed=1)],
                        "InsideWeight": [_uniform(4, 3, seed=2)],
                        "OutsideWeight": [_uniform(4, 3, seed=3)]},
     {}, False, ["Out"]),
    ("log_loss", {"Predicted": [_uniform(5, 1, lo=0.05, hi=0.95)],
                  "Labels": [_uniform(5, 1, seed=1).round()]},
     {"epsilon": 1e-4}, False, ["Loss"]),
    ("huber_loss", {"X": [_rand(6, 1) * 2], "Y": [_rand(6, 1, seed=1)]},
     {"delta": 0.7}, False, ["Out"]),
    ("hinge_loss", {"Logits": [_rand(6, 1)],
                    "Labels": [_uniform(6, 1, seed=1).round()]}, {}, False,
     ["Loss"]),
    ("rank_loss", {"Label": [_uniform(5, 1).round()],
                   "Left": [_rand(5, 1, seed=1)],
                   "Right": [_rand(5, 1, seed=2)]}, {}, False, ["Out"]),
    ("margin_rank_loss", {"Label": [np.sign(_rand(5, 1))],
                          "X1": [_rand(5, 1, seed=1)],
                          "X2": [_rand(5, 1, seed=2)]}, {"margin": 0.1},
     False, ["Out"]),
]


def _case_id(case):
    return "%s-%s" % (case[0], "-".join(sorted(case[2])) or "default")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_rule_matches_the_jax_rule(case):
    op_type, ins, attrs, exact, _ = case
    _same(op_type, ins, attrs, exact)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_case_id(c) for c in GRAD_CASES])
def test_rule_gradient_matches_jax_vjp(case):
    op_type, ins, attrs, _, slots = case
    got, want = _grads_both(op_type, ins, attrs, slots)
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)


def test_print_is_an_identity_that_prints(capsys):
    """print returns its input unchanged and prints the message, name,
    dtype and shape with the first `summarize` values, first_n times."""
    x = _rand(2, 3)
    attrs = {"message": "step", "var_name": "h", "summarize": 4,
             "first_n": 2, "print_tensor_name": True,
             "print_tensor_type": True, "print_tensor_shape": True}
    rule = treg.get("print").lower
    for _ in range(3):
        out = rule(TorchCtx(None, CPU, run_seed=1),
                   {"In": [torch.from_numpy(x)]}, attrs)["Out"][0]
        np.testing.assert_array_equal(out.numpy(), x)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("step h float32 (2, 3) [")
    np.testing.assert_allclose(
        np.array(lines[0].split("[", 1)[1].rstrip("]").split(), np.float32),
        x.reshape(-1)[:4], rtol=1e-6)


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("uniform_random_batch_size_like", {"min": -0.5, "max": 1.5},
     0.5, 2 / np.sqrt(12)),
    ("gaussian_random_batch_size_like", {"mean": 0.25, "std": 0.02},
     0.25, 0.02),
    ("truncated_gaussian_random", {"mean": 0.1, "std": 0.5},
     0.1, 0.5 * 0.8796256610342398),
])
def test_random_rules_draw_the_jax_distribution(op_type, attrs, mean, std):
    """Shape (the batch dim copied from Input for *_batch_size_like),
    dtype, mean and standard deviation of a 200000-value draw on both
    sides; the truncated normal stays within two standard deviations (its
    std is 0.8796 of the untruncated one)."""
    attrs = dict(attrs, shape=[-1, 500] if "like" in op_type
                 else [400, 500], dtype="float32", seed=0,
                 input_dim_idx=0, output_dim_idx=0)
    ins = {"Input": [np.zeros((400, 3), np.float32)]} \
        if "like" in op_type else {}
    jout, tout = _run_both(op_type, ins, attrs)
    j, t = jout["Out"][0], tout["Out"][0]
    assert t.shape == j.shape == (400, 500) and t.dtype == j.dtype
    for a in (j, t):
        assert abs(a.mean() - mean) < 0.02 * std
        assert abs(a.std() - std) < 0.02 * std
    if op_type.startswith("truncated"):
        sd = attrs["std"]
        assert t.min() >= mean - 2 * sd - 1e-6
        assert t.max() <= mean + 2 * sd + 1e-6


def test_auc_accumulates_as_the_jax_rule():
    """Two batches through the streaming AUC: the bucket counts exactly,
    the area within 1e-6 (the JAX package sums in float32, the port in
    float64)."""
    num_t = 50
    tp = np.zeros(num_t, np.int64)
    fp = np.zeros(num_t, np.int64)
    for seed in (0, 1):
        pred = _uniform(64, 2, seed=seed)
        pred /= pred.sum(1, keepdims=True)
        label = _ids(64, 2, seed=seed + 10)
        jout, tout = _run_both("auc", {"Predict": [pred], "Label": [label],
                                       "TP": [tp], "FP": [fp]},
                               {"num_thresholds": num_t})
        for slot in ("TPOut", "FPOut"):
            np.testing.assert_array_equal(tout[slot][0], jout[slot][0])
        np.testing.assert_allclose(tout["AUC"][0], jout["AUC"][0],
                                   atol=1e-6)
        tp, fp = tout["TPOut"][0], tout["FPOut"][0]
    assert tp.sum() + fp.sum() == 128


def test_nce_cost_is_the_jax_formula_on_its_own_samples():
    """The port draws its negative classes from its own generator (RNG
    streams are not portable); on those SampleLabels, SampleLogits and
    Cost are the JAX rule's formula, the true labels lead each row, and
    every draw lies in [0, num_total_classes)."""
    n, d, v, num_neg = 6, 5, 30, 4
    x, w, b = _rand(n, d), _rand(v, d, seed=1), _rand(v, 1, seed=2)
    label = _ids(n, v, seed=3, shape=(n, 2))
    attrs = {"num_total_classes": v, "num_neg_samples": num_neg, "seed": 0}
    out = treg.get("nce").lower(
        TorchCtx(None, CPU, run_seed=1),
        {k: [torch.from_numpy(a)] for k, a in
         (("Input", x), ("Label", label), ("Weight", w), ("Bias", b))},
        attrs)
    samples = out["SampleLabels"][0].numpy()
    assert samples.shape == (n, 2 + num_neg)
    np.testing.assert_array_equal(samples[:, :2], label)
    assert samples.min() >= 0 and samples.max() < v
    sw = jnp.take(jnp.asarray(w), jnp.asarray(samples.reshape(-1)), axis=0) \
        .reshape(n, -1, d)
    logits = jnp.einsum("nd,nsd->ns", jnp.asarray(x), sw) + jnp.take(
        jnp.asarray(b).reshape(-1), jnp.asarray(samples.reshape(-1))) \
        .reshape(n, -1)
    ones = jnp.concatenate([jnp.ones((n, 2)), jnp.zeros((n, num_neg))], 1)
    ce = jnp.maximum(logits, 0) - logits * ones + \
        jnp.log1p(jnp.exp(-jnp.abs(logits)))
    np.testing.assert_allclose(out["SampleLogits"][0].numpy(),
                               np.asarray(logits), **TOL)
    np.testing.assert_allclose(out["Cost"][0].numpy(),
                               np.asarray(ce.sum(1, keepdims=True)), **TOL)


# ------------------------------------------------------------ layers --

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


def _img(fluid):
    return fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")


def _vec(fluid, name="x", width=6):
    return fluid.layers.data(name=name, shape=[width], dtype="float32")


LAYERS = {
    "reductions": lambda f: [getattr(f.layers, r)(_vec(f), dim=d)
                             for r, d in (("reduce_mean", 1),
                                          ("reduce_max", None),
                                          ("reduce_min", [0, 1]),
                                          ("reduce_prod", 1))],
    "expand": lambda f: f.layers.expand(_vec(f), expand_times=[1, 3]),
    "topk_argmax": lambda f: (f.layers.topk(_vec(f), k=2),
                              f.layers.argmax(_vec(f, "y"), axis=1)),
    "create_tensor": lambda f: f.layers.create_tensor(dtype="int64"),
    "fill_constant_batch_size_like": lambda f:
        f.layers.fill_constant_batch_size_like(
            _vec(f), shape=[-1, 4], dtype="float32", value=0.5),
    "random": lambda f: (
        f.layers.uniform_random(shape=[3, 4], dtype="float32", min=-1.0,
                                max=2.0, seed=3),
        f.layers.gaussian_random(shape=[2, 5], mean=0.5, std=2.0),
        f.layers.uniform_random_batch_size_like(
            input=_vec(f), shape=[-1, 7], min=0.0, max=1.0),
        f.layers.gaussian_random_batch_size_like(
            input=_vec(f, "y"), shape=[-1, 3], std=0.1)),
    "index": lambda f: (
        f.layers.cumsum(_vec(f), axis=1, exclusive=True),
        f.layers.gather(_vec(f, "y"), index=f.layers.data(
            name="ids", shape=[1], dtype="int64")),
        f.layers.scatter(_vec(f, "z"), ids=f.layers.data(
            name="sids", shape=[1], dtype="int64"), updates=_vec(f, "u"))),
    "increment_is_empty": lambda f: (
        f.layers.increment(f.layers.fill_constant(
            shape=[1], dtype="float32", value=0.0), value=2.0),
        f.layers.is_empty(_vec(f))),
    "print": lambda f: f.layers.Print(_vec(f), message="x is",
                                      summarize=3),
    "conv2d_transpose": lambda f: f.layers.conv2d_transpose(
        _img(f), num_filters=4, filter_size=3, stride=2, padding=1,
        act="relu"),
    "conv2d_transpose_output_size": lambda f: f.layers.conv2d_transpose(
        _img(f), num_filters=2, output_size=[16, 16], stride=2, padding=1,
        param_attr=f.ParamAttr(initializer=f.initializer.Bilinear())),
    "maxout_l2_normalize": lambda f: (
        f.layers.maxout(_img(f), groups=3),
        f.layers.l2_normalize(_vec(f), axis=1)),
    "smooth_l1_multiplex": lambda f: (
        f.layers.smooth_l1(_vec(f), _vec(f, "y"), sigma=3.0),
        f.layers.multiplex([_vec(f, "a"), _vec(f, "b")], f.layers.data(
            name="pick", shape=[1], dtype="int32"))),
    "nce": lambda f: f.layers.nce(
        _vec(f), f.layers.data(name="lab", shape=[1], dtype="int64"),
        num_total_classes=20, num_neg_samples=5),
    "glu": lambda f: f.nets.glu(_vec(f), dim=1),
    "scaled_dot_product_attention": lambda f:
        f.nets.scaled_dot_product_attention(
            *[f.layers.data(name=n, shape=[5, 8], dtype="float32")
              for n in "qkv"], num_heads=2),
    "weight_norm": lambda f: f.layers.fc(
        _vec(f), size=4, param_attr=f.WeightNormParamAttr(dim=1)),
    "weight_norm_scalar_g": lambda f: f.layers.fc(
        _vec(f), size=3, param_attr=f.WeightNormParamAttr(dim=None)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program(name):
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            LAYERS[name](fluid)
        progs.append((main, startup))
    (jmain, jstartup), (tmain, tstartup) = progs
    assert _same_bytes(jmain, tmain)
    assert _same_bytes(jstartup, tstartup)


def test_weight_norm_fc_trains_as_the_jax_one():
    """fc with WeightNormParamAttr: startup sets g = ||v|| (so w = v),
    then three SGD steps from the JAX package's state give its losses
    and its g and v."""
    from paddle_tpu_torch import io as tio

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = _vec(fluid)
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            pred = fluid.layers.fc(
                x, size=1, param_attr=fluid.WeightNormParamAttr(dim=1))
            avg = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg)
        return main, startup, avg

    jmain, jstartup, javg = build(jfluid)
    tmain, tstartup, tavg = build(tfluid)
    assert _same_bytes(jmain, tmain) and _same_bytes(jstartup, tstartup)
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(8, 6).astype(np.float32),
              "y": rng.randn(8, 1).astype(np.float32)} for _ in range(3)]
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        want = [float(np.ravel(jexe.run(jmain, feed=f,
                                        fetch_list=[javg])[0])[0])
                for f in feeds]
    v = state["fc_0.w_0.wn_v"]
    np.testing.assert_allclose(state["fc_0.w_0.wn_g"],
                               np.sqrt((v ** 2).sum(0)), rtol=1e-6)
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tmain, feed=f, fetch_list=[tavg],
                          scope=tscope)[0].reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("fc_0.w_0.wn_g", "fc_0.w_0.wn_v"):
        np.testing.assert_allclose(tscope.get(name).numpy(),
                                   np.asarray(jscope.get(name)), atol=1e-5)
    # the port's own startup gives g = ||v|| too
    scope = tfluid.Scope()
    texe.run(tstartup, scope=scope)
    v = scope.get("fc_0.w_0.wn_v").numpy()
    np.testing.assert_allclose(scope.get("fc_0.w_0.wn_g").numpy(),
                               np.sqrt((v ** 2).sum(0)), rtol=1e-6)


def test_bilinear_initializer_values():
    """The Bilinear kernel's values on both sides (assign_value attrs of
    the startup program) and after the port's startup run."""
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fluid.layers.create_parameter(
                shape=[2, 2, 4, 4], dtype="float32", name="up",
                default_initializer=fluid.initializer.Bilinear())
        progs.append(startup)
    assert _same_bytes(*progs)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(progs[1], scope=scope)
    w = scope.get("up").numpy()
    # f = 2, c = 0.75: the 1-D profile [0.25, 0.75, 0.75, 0.25]
    prof = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
    np.testing.assert_allclose(w[1, 0], np.outer(prof, prof))


def test_scale_learning_rate_and_lr_names():
    """persistable_lr_names finds the SGD rate as the JAX package's does;
    scale_learning_rate multiplies it in the scope, in its dtype; a
    scheduler-derived rate raises."""
    names = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = _vec(fluid)
            avg = fluid.layers.mean(fluid.layers.fc(x, size=1))
            fluid.optimizer.SGD(learning_rate=0.2).minimize(avg)
        names.append(fluid.optimizer.persistable_lr_names(main))
    assert names[0] == names[1] and len(names[1]) == 1
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    assert tfluid.optimizer.scale_learning_rate(main, scope, 0.5) == names[1]
    lr = scope.get(names[1][0])
    assert lr.dtype == torch.float32
    np.testing.assert_allclose(lr.numpy(), [0.1], rtol=1e-6)
    with pytest.raises(ValueError, match="no persistable learning-rate"):
        tfluid.optimizer.scale_learning_rate(main, tfluid.Scope(), 0.5)
