"""The port's LR schedules, Switch and compare / logical ops against the JAX
package, on the CPU.

- Schedules: exponential, natural_exp and inverse_time decay (with and
  without staircase), polynomial decay (with and without cycle) and
  piecewise decay, each driving SGD on fit_a_line: the program bytes equal
  the JAX package's, and the learning rate of each of 12 runs (step 0 on,
  so cycle's step 0 and piecewise's boundaries are crossed) equals the JAX
  package's and the schedule's formula in numpy, rtol 1e-6 (fp32 pow, exp
  and division in another order; measured: at most 2.0e-7 against the JAX
  package, 1.3e-7 against the float64 formula).
- Switch: first-match-wins over overlapping cases, and the default,
  against the JAX package (exact: a selected constant).
- conditional_block: its IfElse form (is_scalar_condition=False) runs
  as the JAX package's does; its rule, and each rule of this slice, holds
  no host sync (.item(), .cpu(), .tolist(), .numpy(), nonzero or bool of
  a tensor) in its source.
- The compare and logical ops, and the comparison operators on Variable,
  against the JAX package (exact: booleans).
"""
import inspect
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core import registry as treg

from test_torch_ops import _run_both

STEPS = 12
LR_RTOL = 1e-6


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


def _exp(s, staircase):
    return 0.1 * 0.5 ** (np.floor(s / 3) if staircase else s / 3)


def _natural(s, staircase):
    return 0.1 * np.exp(-0.5 * (np.floor(s / 3) if staircase else s / 3))


def _inverse(s, staircase):
    return 0.1 / (1 + 0.5 * (np.floor(s / 3) if staircase else s / 3))


def _poly(s, cycle):
    if cycle:
        steps = 5 * max(np.ceil(s / 5), 1)
    else:
        steps, s = 5, min(s, 5)
    return (0.1 - 0.01) * (1 - s / steps) ** 2 + 0.01


def _piecewise(s):
    return 0.1 if s < 3 else 0.05 if s < 7 else 0.01


_SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda s: _exp(s, False)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda s: _exp(s, True)),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 3, 0.5),
                    lambda s: _natural(s, False)),
    "natural_exp_staircase": (
        lambda L: L.natural_exp_decay(0.1, 3, 0.5, staircase=True),
        lambda s: _natural(s, True)),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 3, 0.5),
                     lambda s: _inverse(s, False)),
    "inverse_time_staircase": (
        lambda L: L.inverse_time_decay(0.1, 3, 0.5, staircase=True),
        lambda s: _inverse(s, True)),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0),
                   lambda s: _poly(s, False)),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0, cycle=True),
        lambda s: _poly(s, True)),
    "piecewise": (lambda L: L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
                  _piecewise),
}


def _scheduled(kind):
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        avg = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        lr = _SCHEDULES[kind][0](fluid.layers)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg)
        return avg, lr
    return build


@pytest.mark.parametrize("kind", sorted(_SCHEDULES))
def test_schedule_matches_jax_and_its_formula(kind):
    jmain, jstartup, (javg, jlr) = _built(jfluid, _scheduled(kind))
    tmain, tstartup, (tavg, tlr) = _built(tfluid, _scheduled(kind))
    assert tdesc.program_to_bytes(tmain) == jdesc.program_to_bytes(jmain)
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    rng = np.random.RandomState(7)
    got, want = [], []
    for step in range(STEPS):
        x = rng.rand(4, 13).astype(np.float32)
        feed = {"x": x, "y": x[:, :1]}
        with jfluid.scope_guard(jscope):
            want.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jlr])[0]).reshape(-1)[0]))
        got.append(float(texe.run(tmain, feed=feed, fetch_list=[tlr],
                                  scope=tscope)[0].reshape(-1)[0]))
    formula = [_SCHEDULES[kind][1](s) for s in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    np.testing.assert_allclose(got, formula, rtol=LR_RTOL)
    assert len(set(np.round(got, 7))) > 1
    counter = tscope.get("@LR_DECAY_COUNTER@")
    assert counter.dtype == torch.int64 and int(counter[0]) == STEPS - 1


def _switch(fluid):
    """out = 1 if v < 5, else 2 if v < 10 (overlapping the first case),
    else 3."""
    L = fluid.layers
    v = L.data(name="v", shape=[1], dtype="float32",
               append_batch_size=False)
    out = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(v, L.fill_constant([1], "float32",
                                                        5.0))):
            L.assign(L.fill_constant([1], "float32", 1.0), out)
        with switch.case(L.less_than(v, L.fill_constant([1], "float32",
                                                        10.0))):
            L.assign(L.fill_constant([1], "float32", 2.0), out)
        with switch.default():
            L.assign(L.fill_constant([1], "float32", 3.0), out)
    return out


@pytest.mark.parametrize("v,want", [(2.0, 1.0), (5.0, 2.0), (7.0, 2.0),
                                    (10.0, 3.0), (12.0, 3.0)])
def test_switch_first_match_wins(v, want):
    jmain, _, jout = _built(jfluid, _switch)
    tmain, _, tout = _built(tfluid, _switch)
    assert tdesc.program_to_bytes(tmain) == jdesc.program_to_bytes(jmain)
    assert sum(op.type == "conditional_block"
               for op in tmain.global_block().ops) == 3
    feed = {"v": np.array([v], np.float32)}
    with jfluid.scope_guard(jfluid.Scope()):
        j, = jfluid.Executor(jfluid.CPUPlace()).run(jmain, feed=feed,
                                                    fetch_list=[jout])
    t, = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=[tout],
                                    scope=tfluid.Scope())
    assert float(t[0]) == float(np.asarray(j)[0]) == want


def test_ifelse_form_of_conditional_block_raises_naming_the_roadmap():
    """The IfElse form (is_scalar_condition=False) raised naming ROADMAP
    A6 until A6 was ported; it now runs its block and writes its outputs
    unselected (merge_lod_tensor's row mask selects), as the JAX package
    does: the same value in both packages, whichever the condition."""
    def build(fluid):
        L = fluid.layers
        v = L.data(name="v", shape=[1], dtype="float32",
                   append_batch_size=False)
        out = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(v, L.fill_constant([1], "float32", 1.0))
        with L.ConditionalBlock([cond], is_scalar_condition=False).block():
            L.assign(v, out)
        return out
    jmain, _, jout = _built(jfluid, build)
    main, _, out = _built(tfluid, build)
    assert tdesc.program_to_bytes(main) == jdesc.program_to_bytes(jmain)
    for v in (0.0, 2.0):
        feed = {"v": np.array([v], "f")}
        with jfluid.scope_guard(jfluid.Scope()):
            j, = jfluid.Executor(jfluid.CPUPlace()).run(
                jmain, feed=feed, fetch_list=[jout])
        t, = tfluid.Executor("cpu").run(main, feed=feed, fetch_list=[out],
                                        scope=tfluid.Scope())
        assert float(t[0]) == float(np.asarray(j)[0]) == v


_SLICE_RULES = (
    ["conditional_block", "less_than", "logical_and", "logical_not",
     "concat", "cos_sim", "elementwise_max", "sigmoid_cross_entropy_with_"
     "logits", "square_error_cost", "lrn", "adamax", "decayed_adagrad",
     "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad"])


@pytest.mark.parametrize("op_type", _SLICE_RULES)
def test_rule_holds_no_host_sync(op_type):
    """A rule that reads a tensor's value on the host stalls the step (and
    breaks CUDA graph capture): none of this slice's rules does."""
    src = inspect.getsource(treg.get(op_type).lower)
    for token in (".item(", ".cpu(", ".tolist(", ".numpy(", "nonzero"):
        assert token not in src, (op_type, token)
    # the builtins bool / float / int on a tensor (not the .float() cast)
    assert not re.search(r"(?<![\w.])(bool|float|int)\(", src), op_type


# ------------------------------------------------------ compare / logical --

def _b(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape) > 0.5


_CMP_CASES = [(op, {"X": [np.array([1, 2, 3, 4], np.float32)],
                    "Y": [np.array([2, 2, 2, 2], np.float32)]})
              for op in ("less_than", "less_equal", "greater_than",
                         "greater_equal", "equal", "not_equal")]
_CMP_CASES += [(op, {"X": [_b(3, 4)], "Y": [_b(3, 4, seed=1)]})
               for op in ("logical_and", "logical_or", "logical_xor")]
_CMP_CASES += [("logical_not", {"X": [_b(3, 4)]}),
               ("less_than", {"X": [np.arange(6, dtype=np.int64)
                                    .reshape(2, 3)],
                              "Y": [np.array([2], np.int64)]})]


@pytest.mark.parametrize("case", range(len(_CMP_CASES)),
                         ids=[c[0] for c in _CMP_CASES])
def test_compare_and_logical_ops_match_jax(case):
    op_type, ins = _CMP_CASES[case]
    jout, tout = _run_both(op_type, ins, {})
    assert tout["Out"][0].dtype == np.bool_
    np.testing.assert_array_equal(tout["Out"][0], jout["Out"][0])


def test_comparison_operators_build_the_jax_program():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.data(name="y", shape=[3], dtype="float32")
        return [x < y, x <= 2.0, x > y, x >= 0.5]
    jmain, _, _ = _built(jfluid, build)
    tmain, _, outs = _built(tfluid, build)
    assert tdesc.program_to_bytes(tmain) == jdesc.program_to_bytes(jmain)
    assert [op.type for op in tmain.global_block().ops if op.type !=
            "fill_constant"] == ["less_than", "less_equal", "greater_than",
                                 "greater_equal"]
    feed = {"x": np.array([[0.0, 1.0, 3.0]], np.float32),
            "y": np.array([[1.0, 1.0, 1.0]], np.float32)}
    got = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=outs,
                                     scope=tfluid.Scope())
    assert [g.tolist() for g in got] == [
        [[True, False, False]], [[True, True, False]],
        [[False, False, True]], [[False, True, True]]]
