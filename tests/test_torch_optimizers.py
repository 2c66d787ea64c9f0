"""The port's remaining optimizers and this slice's elementwise rules
against the JAX package, on the CPU.

- Optimizers: Adamax, DecayedAdagrad, Adadelta, RMSProp (with and without
  momentum), Ftrl (lr_power -0.5 and -0.3, with l1 and l2), ProximalGD and
  ProximalAdagrad, each minimizing a two-layer regression (fc 13 -> 8 tanh,
  fc 8 -> 1, square_error_cost, mean): the program bytes equal the JAX
  package's, then 5 steps from the JAX startup state (io.scope_from_numpy)
  on the same feeds: each step's loss within rtol 1e-5 (measured: at most
  4.9e-7) and every persistable after the 5 steps (parameters,
  accumulators, beta power) within rtol = atol = 1e-5 (measured: at most
  1.9e-6 absolute, Ftrl's linear accumulator).
- ModelAverage after SGD on fit_a_line: the same bytes; after 5 steps its
  apply() puts sum / count into the parameters as the JAX package's does
  (rtol = atol = 1e-6, measured 4.5e-8: the sums of 5 steps' parameters,
  which differ by their rounding),
  and its exit, or restore() after apply(need_restore=False), puts the
  trained parameters back exactly.
- Rules: the 30 activations, elementwise_max, concat, cos_sim, lrn,
  sigmoid_cross_entropy_with_logits, square_error_cost and transpose (the
  transformer's dense attention), forward and
  gradient (through the port's grad_of against jax.vjp of the JAX rule,
  test_torch_ops' helpers) at rtol = atol = 1e-5 (fp32 in another order;
  measured: at most 5.2e-7 of max(1, the largest value), tanh's
  gradient).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.ops.basic import ACTIVATIONS

from test_torch_ops import _grads_both, _run_both

STEPS, BATCH = 5, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _built(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn(fluid)
    return main, startup, out


def _regression(fluid, hidden=8):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=hidden, act="tanh") if hidden else x
    pred = fluid.layers.fc(input=h, size=1)
    return fluid.layers.mean(fluid.layers.square_error_cost(input=pred,
                                                            label=y))


def _feed(step):
    rng = np.random.RandomState(500 + step)
    x = rng.rand(BATCH, 13).astype(np.float32)
    return {"x": x, "y": (x.sum(1, keepdims=True) / 4.0 - 1.0)
            .astype(np.float32)}


_OPTIMIZERS = {
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.01)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop_momentum": ("RMSProp", dict(learning_rate=0.01,
                                         momentum=0.9)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    "ftrl_power_0.3": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01,
                                    lr_power=-0.3)),
    "proximal_gd": ("ProximalGD", dict(learning_rate=0.05, l1=0.01,
                                       l2=0.01)),
    "proximal_adagrad": ("ProximalAdagrad", dict(learning_rate=0.05,
                                                 l1=0.01, l2=0.01)),
}


def _with(kind):
    cls, kwargs = _OPTIMIZERS[kind]

    def build(fluid):
        avg = _regression(fluid)
        getattr(fluid.optimizer, cls)(**kwargs).minimize(avg)
        return avg
    return build


def _start(jmain, jstartup, tmain):
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    return jexe, jscope, tio.scope_from_numpy(state, "cpu", program=tmain)


@pytest.mark.parametrize("kind", sorted(_OPTIMIZERS))
def test_optimizer_matches_jax_over_five_steps(kind):
    jmain, jstartup, javg = _built(jfluid, _with(kind))
    tmain, tstartup, tavg = _built(tfluid, _with(kind))
    assert tdesc.program_to_bytes(tmain) == jdesc.program_to_bytes(jmain)
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    op = kind.split("_power")[0].replace("_momentum", "")
    assert sum(o.type == op for o in tmain.global_block().ops) == 4
    jexe, jscope, tscope = _start(jmain, jstartup, tmain)
    texe = tfluid.Executor("cpu")
    for step in range(STEPS):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=_feed(step), fetch_list=[javg])
        tl, = texe.run(tmain, feed=_feed(step), fetch_list=[tavg],
                       scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
    n = 0
    for v in tmain.list_vars():
        if v.persistable:
            np.testing.assert_allclose(
                tscope.get(v.name).numpy(), np.asarray(jscope.get(v.name)),
                err_msg=v.name, **TOL)
            n += 1
    assert n >= 5   # 4 parameters and the learning rate, at the least


def _averaged(fluid):
    avg = _regression(fluid, hidden=0)
    fluid.optimizer.SGD(learning_rate=0.05).minimize(avg)
    return avg, fluid.optimizer.ModelAverage(0.15)


def test_model_average_apply_and_restore_match_jax():
    jmain, jstartup, (javg, jma) = _built(jfluid, _averaged)
    tmain, tstartup, (tavg, tma) = _built(tfluid, _averaged)
    assert tdesc.program_to_bytes(tmain) == jdesc.program_to_bytes(jmain)
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    jexe, jscope, tscope = _start(jmain, jstartup, tmain)
    texe = tfluid.Executor("cpu")
    for step in range(STEPS):
        with jfluid.scope_guard(jscope):
            jexe.run(jmain, feed=_feed(step), fetch_list=[javg])
        texe.run(tmain, feed=_feed(step), fetch_list=[tavg], scope=tscope)
    params = [p.name for p in tmain.all_parameters()]
    assert len(params) == 2
    trained = {n: tscope.get(n).clone() for n in params}
    with jfluid.scope_guard(jscope), jma.apply(jexe):
        want = {n: np.array(jscope.get(n)) for n in params}
    with tma.apply(texe, scope=tscope):
        for n in params:
            got = tscope.get(n).numpy()
            np.testing.assert_allclose(got, want[n], rtol=1e-6, atol=1e-6)
            assert not np.array_equal(got, trained[n].numpy())
    for n in params:
        assert torch.equal(tscope.get(n), trained[n])
    with tma.apply(texe, need_restore=False, scope=tscope):
        pass
    assert not torch.equal(tscope.get(params[0]), trained[params[0]])
    tma.restore(texe)
    for n in params:
        assert torch.equal(tscope.get(n), trained[n])


# ------------------------------------------------------------------ rules --

def _x(*shape, seed=0, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(*shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) + 0.2).astype(
        np.float32)


_ACT_ATTRS = {"brelu": {"t_min": -0.5, "t_max": 1.0},
              "relu6": {"threshold": 1.5}, "soft_relu": {"threshold": 1.0},
              "pow": {"factor": 2.5}, "leaky_relu": {"alpha": 0.1},
              "elu": {"alpha": 0.7}, "swish": {"beta": 1.5},
              "softshrink": {"lambda": 0.7}, "hard_shrink": {"threshold": 0.9},
              "thresholded_relu": {"threshold": 0.4},
              "stanh": {"scale_a": 0.5, "scale_b": 1.2},
              "hard_sigmoid": {"slope": 0.3, "offset": 0.4}}
_POSITIVE = {"sqrt", "log", "reciprocal", "pow"}


def _rule_cases():
    cases = [(a, {"X": [_pos(3, 7) if a in _POSITIVE else _x(3, 7)]},
              _ACT_ATTRS.get(a, {}), ["Out"]) for a in ACTIVATIONS]
    cases += [
        ("elementwise_max", {"X": [_x(2, 3, 4)], "Y": [_x(3, seed=1)]},
         {"axis": 1}, ["Out"]),
        ("elementwise_max", {"X": [_x(2, 3, 4)], "Y": [_x(2, 3, 4, seed=1)]},
         {"axis": -1}, ["Out"]),
        ("concat", {"X": [_x(2, 3), _x(2, 5, seed=1), _x(2, 1, seed=2)]},
         {"axis": 1}, ["Out"]),
        ("cos_sim", {"X": [_x(4, 6)], "Y": [_x(4, 6, seed=1)]}, {},
         ["Out", "XNorm", "YNorm"]),
        ("cos_sim", {"X": [_x(4, 6)], "Y": [_x(1, 6, seed=1)]}, {},
         ["Out"]),
        ("lrn", {"X": [_x(2, 6, 3, 3)]},
         {"n": 5, "k": 1.0, "alpha": 1e-2, "beta": 0.75}, ["Out", "MidOut"]),
        ("lrn", {"X": [_x(1, 3, 2, 2)]}, {}, ["Out"]),
        ("sigmoid_cross_entropy_with_logits",
         {"X": [_x(5, 4, scale=4.0)], "Label": [_pos(5, 4, seed=1) - 0.2]},
         {}, ["Out"]),
        ("square_error_cost", {"X": [_x(6, 1)], "Y": [_x(6, 1, seed=1)]},
         {}, ["Out"]),
        ("transpose", {"X": [_x(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]},
         ["Out"]),
    ]
    return cases


_RULE_CASES = _rule_cases()


@pytest.mark.parametrize(
    "case", range(len(_RULE_CASES)),
    ids=["%s-%d" % (c[0], i) for i, c in enumerate(_RULE_CASES)])
def test_rule_and_gradient_match_jax(case):
    op_type, ins, attrs, out_slots = _RULE_CASES[case]
    jout, tout = _run_both(op_type, ins, attrs)
    assert set(tout) == {s for s in jout if s in tout}
    for slot in tout:
        for j, t in zip(jout[slot], tout[slot]):
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            np.testing.assert_allclose(t, j, err_msg=slot, **TOL)
    got, want = _grads_both(op_type, ins, attrs, out_slots)
    assert set(got) == set(want) and got
    for key in got:
        np.testing.assert_allclose(got[key], want[key], err_msg=str(key),
                                   **TOL)


def test_every_activation_has_a_layer():
    """fluid.layers generates one layer per activation, and `act=` on fc
    appends the same op."""
    assert len(ACTIVATIONS) == 30
    for a in ACTIVATIONS:
        assert callable(getattr(tfluid.layers, a))
