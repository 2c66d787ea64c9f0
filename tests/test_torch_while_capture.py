"""A While inside Executor.run(steps=K) in the port against the JAX
package, on the CPU.

The JAX package runs a While inside steps=K as one lax.while_loop with a
device counter; the port captures it on a card as a conditional while
node (ops/control_ops._while_captured, csrc/graph_while.cu, held on the
card by chip_smoke.py phase 30) and runs the same step's host loop on the
CPU, which these tests hold:

- loop_program (tests/test_torch_while.py's counter loop over a tensor
  array), a loop summing a tensor array's entries, and a loop whose
  result updates a persistable every step: the stacked steps=4 fetches
  and the final state equal the JAX package's steps=4;
- the Transformer's cached beam decode at 2 layers, d_model 64, from the
  JAX package's startup state: ids and scores at steps=2 equal the JAX
  package's steps=2 (and each step equals one eager run of the port);
- a While writing past its array's capacity raises the JAX package's
  message under steps=3 too;
- a random op in a While body: steps=1 draws anew at every iteration,
  and steps=K raises GraphCaptureError naming the op (a captured body
  would draw the same numbers at every iteration). The JAX package draws
  per iteration under steps=K; the port refuses (ROADMAP A6, open);
- the launch count of a while body, counted by a device iteration
  counter read only when the counts are read.

Tolerances: rtol = atol = 1e-6 for sums of a few fp32 values; beam scores
rtol = atol = 1e-5 (sums of up to 8 fp32 log-probs through 2 layers in
another order); ids, lengths and error texts exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core.lowering import GraphCaptureError
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=1e-6, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, MAX_LEN, N_HEAD, BEAM = 24, 8, 2, 2
TR = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
          n_layer=2, n_head=N_HEAD, d_key=32, d_value=32, d_model=64,
          d_inner_hid=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, fn, **kwargs):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = fn(fluid, **kwargs)
    return main, startup, fetch


def loop_program(fluid, capacity=16, iters=3):
    """A While writing a new value at index i + 1 for i in [0, iters)."""
    layers = fluid.layers
    counter = layers.zeros(shape=[1], dtype="int32")
    counter.stop_gradient = True
    limit = layers.fill_constant(shape=[1], dtype="int32", value=iters)
    arr = layers.create_array("float32", capacity=capacity)
    x = layers.fill_constant(shape=[4], dtype="float32", value=1.0)
    layers.array_write(x, counter, arr)
    cond = layers.less_than(x=counter, y=limit)
    while_op = layers.While(cond=cond)
    with while_op.block():
        v = layers.array_read(arr, counter)
        layers.increment(counter, 1, in_place=True)
        layers.array_write(layers.elementwise_add(x=v, y=x), counter, arr)
        layers.less_than(x=counter, y=limit, cond=cond)
    return [layers.array_read(arr, counter), layers.array_length(arr)]


def array_sum_program(fluid):
    """The fed rows written into an array, then a While summing them."""
    layers = fluid.layers
    xs = layers.data("xs", shape=[5, 3], append_batch_size=False)
    arr = layers.create_array("float32", capacity=8)
    i = layers.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    for k, row in enumerate(layers.split(xs, num_or_sections=5, dim=0)):
        layers.array_write(layers.reshape(row, shape=[3]),
                           layers.fill_constant([1], "int64", k), arr)
    n = layers.array_length(arr)
    acc = layers.fill_constant(shape=[3], dtype="float32", value=0.0)
    cond = layers.less_than(x=i, y=n)
    w = layers.While(cond=cond)
    with w.block():
        layers.assign(layers.elementwise_add(x=acc, y=layers.array_read(
            arr, i)), acc)
        layers.increment(i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    return [acc, i]


def state_program(fluid):
    """A loop's result added to a persistable every step: step k sees the
    state step k - 1 left."""
    layers = fluid.layers
    total = layers.create_global_var(shape=[2], value=1.0, dtype="float32",
                                     persistable=True, name="total")
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    limit = layers.fill_constant(shape=[1], dtype="int32", value=4)
    acc = layers.fill_constant(shape=[2], dtype="float32", value=0.0)
    cond = layers.less_than(x=i, y=limit)
    w = layers.While(cond=cond)
    with w.block():
        layers.assign(layers.elementwise_add(
            x=acc, y=layers.scale(total, scale=0.5)), acc)
        layers.increment(i, in_place=True)
        layers.less_than(x=i, y=limit, cond=cond)
    layers.assign(layers.elementwise_add(x=total, y=acc), total)
    return [acc, total]


PROGRAMS = {"loop_program": (loop_program, None),
            "array_sum": (array_sum_program, {"xs": np.random.RandomState(
                3).randn(5, 3).astype("float32")}),
            "state": (state_program, None)}


def _run(fluid, name, steps):
    """(fetches, final persistables) of program `name` run once at
    `steps` in a fresh scope."""
    fn, feed = PROGRAMS[name]
    main, startup, fetch = _build(fluid, fn)
    if fluid is jfluid:
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            out = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, steps=steps)]
            state = {v.name: np.asarray(scope.get(v.name))
                     for v in main.list_vars() if v.persistable}
        return out, state
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  steps=steps)
    state = {v.name: scope.get(v.name).numpy()
             for v in main.list_vars() if v.persistable}
    return out, state


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_steps_with_a_while_match_the_jax_package(name):
    jout, jstate = _run(jfluid, name, 4)
    tout, tstate = _run(tfluid, name, 4)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert t.shape[0] == 4
        np.testing.assert_allclose(t, j.reshape(t.shape), **TOL)
    assert sorted(jstate) == sorted(tstate)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], **TOL)


def test_state_program_threads_the_state_through_the_steps():
    """Four steps equal four eager runs, and the steps differ: each loop
    reads the state the step before left."""
    tout, _ = _run(tfluid, "state", 4)
    main, startup, fetch = _build(tfluid, state_program)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    eager = [exe.run(main, fetch_list=fetch, scope=scope)
             for _ in range(4)]
    for k in range(4):
        for got, want in zip(tout, eager[k]):
            np.testing.assert_array_equal(got[k], want)
    assert not np.array_equal(tout[0][0], tout[0][1])


# ------------------------------------------------- the cached decode --

@pytest.fixture(scope="module")
def decode_case():
    """The cached decode program in both packages, the JAX package's
    startup state and the feed."""
    jmain, jstartup, jfetch = _build(
        jfluid, lambda fluid: list(jtr.build_cached_decode(
            beam_size=BEAM, **TR)))
    tmain, _, tfetch = _build(
        tfluid, lambda fluid: list(ttr.build_cached_decode(
            beam_size=BEAM, **TR)))
    train_main, train_startup, _ = _build(
        jfluid, lambda fluid: jtr.build_train(**TR))
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(train_startup)
    state = {v.name: np.array(scope.get(v.name))
             for v in train_main.list_vars()
             if v.persistable and scope.get(v.name) is not None}
    rng = np.random.RandomState(5)
    srcs = [rng.randint(3, VOCAB, 5).tolist(),
            rng.randint(3, VOCAB, 7).tolist()]
    return (jmain, jfetch, tmain, tfetch, state,
            jtr.prepare_cached_decode_batch(srcs, MAX_LEN, N_HEAD, BEAM),
            ttr.prepare_cached_decode_batch(srcs, MAX_LEN, N_HEAD, BEAM))


def test_cached_decode_steps_match_the_jax_package(decode_case):
    jmain, jfetch, tmain, tfetch, state, jfeed, tfeed = decode_case
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope.set(n, v)
    with jfluid.scope_guard(jscope):
        jids, jscores = [np.asarray(v) for v in jfluid.Executor(
            jfluid.CPUPlace()).run(jmain, feed=jfeed, fetch_list=jfetch,
                                   steps=2)]
    exe = tfluid.Executor("cpu")
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    tids, tscores = exe.run(tmain, feed=tfeed, fetch_list=tfetch,
                            scope=tscope, steps=2)
    assert tids.shape == (2, 2, BEAM, MAX_LEN)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tscores, jscores, **SCORE_TOL)
    eids, escores = exe.run(tmain, feed=tfeed, fetch_list=tfetch,
                            scope=tscope)
    for k in range(2):
        np.testing.assert_array_equal(tids[k], eids)
        np.testing.assert_array_equal(tscores[k], escores)


# ------------------------------------------------------ overflow, rng --

def _error(fluid, steps):
    main, startup, fetch = _build(fluid, loop_program, capacity=4, iters=10)
    try:
        if fluid is jfluid:
            exe = jfluid.Executor(jfluid.CPUPlace())
            with jfluid.scope_guard(jfluid.Scope()):
                exe.run(startup)
                exe.run(main, fetch_list=fetch, steps=steps)
        else:
            tfluid.Executor("cpu").run(main, fetch_list=fetch,
                                       scope=tfluid.Scope(), steps=steps)
    except RuntimeError as e:
        return str(e)
    return None


def test_overflow_under_steps_raises_the_jax_message():
    jerr, terr = _error(jfluid, 3), _error(tfluid, 3)
    assert jerr is not None and "overflowed its capacity 4" in jerr
    assert terr == jerr


def dropout_loop(fluid):
    layers = fluid.layers
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    limit = layers.fill_constant(shape=[1], dtype="int32", value=2)
    ones = layers.fill_constant(shape=[64], dtype="float32", value=1.0)
    arr = layers.create_array("float32", capacity=4)
    layers.array_write(ones, i, arr)
    cond = layers.less_than(x=i, y=limit)
    w = layers.While(cond=cond)
    with w.block():
        drop = layers.dropout(ones, dropout_prob=0.5)
        layers.increment(i, in_place=True)
        layers.array_write(drop, i, arr)
        layers.less_than(x=i, y=limit, cond=cond)
    one = layers.fill_constant([1], "int32", 1)
    two = layers.fill_constant([1], "int32", 2)
    return [layers.array_read(arr, one), layers.array_read(arr, two)]


def test_random_op_in_a_while_body_under_steps_raises():
    main, startup, fetch = _build(tfluid, dropout_loop)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    first, second = exe.run(main, fetch_list=fetch, scope=scope)
    assert (first == 0).any() and (first != 0).any()
    assert not np.array_equal(first, second)   # a mask an iteration
    with pytest.raises(GraphCaptureError, match="op 'dropout'"):
        exe.run(main, fetch_list=fetch, scope=scope, steps=2)


def test_while_body_launches_count_by_the_device_iterations():
    """A body's launches are added per iteration from a device counter
    the counts read only when they are read; a reset drops them."""
    before = ck.launch_counts()
    try:
        ck.reset_launch_counts()
        ck.add_launches({"set_while_condition": 1}, 2)
        ck.add_device_launches({"layer_norm_fwd": 19,
                                "set_while_condition": 1},
                               torch.tensor(130))
        assert ck.launch_snapshot()["layer_norm_fwd"] == 0
        counts = ck.launch_counts()
        assert counts["layer_norm_fwd"] == 19 * 130
        assert counts["set_while_condition"] == 132
        ck.add_device_launches({"layer_norm_fwd": 1}, torch.tensor(5))
        ck.reset_launch_counts()
        assert ck.launch_counts()["layer_norm_fwd"] == 0
    finally:
        ck.reset_launch_counts()
        ck.add_launches(before)


def test_while_body_launches_keep_one_total_a_kernel():
    """Many calls' body launches fold into one device total a kernel, so
    nothing grows with the number of calls, and a counter zeroed for the
    next call after being added leaves the total as it was."""
    before = ck.launch_counts()
    try:
        ck.reset_launch_counts()
        iters = torch.zeros((), dtype=torch.int64)
        for _ in range(500):
            iters.fill_(64)
            ck.add_device_launches({"layer_norm_fwd": 19,
                                    "set_while_condition": 1}, iters)
            iters.zero_()
        assert len(ck._device_launches) == 2
        counts = ck.launch_counts()
        assert counts["layer_norm_fwd"] == 500 * 64 * 19
        assert counts["set_while_condition"] == 500 * 64
        assert ck.launch_counts() == counts   # reading settles nothing
    finally:
        ck.reset_launch_counts()
        ck.add_launches(before)
