"""While, the tensor arrays, IfElse and the rank tables (ROADMAP A6) in the
port against the JAX package, on the CPU.

- Control flow (tests/unittests/test_control_flow.py): a While summing an
  array's entries, an array written and read back with its length, an
  IfElse that negates some rows and doubles the others; the same program
  bytes and the same fetches in both packages.
- Capacity (tests/unittests/test_tensor_array_capacity.py): a While
  writing past its array's capacity, an array confined to the loop's
  block written past its capacity, and straight-line writes past it each
  raise the JAX package's RuntimeError, word for word; a run within
  capacity is clean and equal; with FLAGS_tensor_array_safety=0 neither
  package raises and the clamped values agree (XLA's index clamp, which
  the port copies on the device). A While carry with no value before the
  loop raises the JAX package's ValueError; a Python int index past the
  capacity raises IndexError; Executor.run(steps=4) on a program with a
  While raises GraphCaptureError naming the op.
- Rank tables (tests/unittests/test_rank_table_ops.py): max_sequence_len,
  reorder_lod_tensor_by_rank (the permuted lengths reach sequence_pool),
  lod_tensor_to_array and back, array_read of rank-ordered steps,
  shrink_memory, and the reorder's gradient (the inverse permutation)
  against the JAX package.

Tolerances: rtol = atol = 1e-6 for sums and products of a few fp32
values; lengths, orders, indices and error texts exact.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.core.lowering import GraphCaptureError
from paddle_tpu_torch.ops.control_ops import TensorArray

TOL = dict(rtol=1e-6, atol=1e-6)
_LOD = {jfluid: JLoDTensor, tfluid: TLoDTensor}


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _run(fluid, build, feed=None, steps=1):
    """Build and run `build(fluid)` once in a fresh scope; feed values
    that are lists of sequences become the package's LoDTensor."""
    main, startup, fetch = _build(fluid, build)
    feed = {k: _LOD[fluid].from_sequences(v) if isinstance(v, list) else v
            for k, v in (feed or {}).items()}
    if fluid is jfluid:
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            return [np.asarray(v) for v in
                    exe.run(main, feed=feed, fetch_list=list(fetch))]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=list(fetch), scope=scope,
                   steps=steps)


def _both(build, feed=None):
    jout = _run(jfluid, build, feed)
    tout = _run(tfluid, build, feed)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, **TOL)
    return tout


def _error(fluid, build, feed=None):
    with pytest.raises(Exception) as info:
        _run(fluid, build, feed)
    return info.value


def _same_bytes(build):
    jmain = _build(jfluid, build)[0]
    tmain = _build(tfluid, build)[0]
    jd = json.loads(jdesc.program_to_bytes(jmain))
    td = json.loads(tdesc.program_to_bytes(tmain))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd


# ------------------------------------------------------- control flow --

def while_sum_of_array(fluid):
    layers = fluid.layers
    d = [layers.data("d%d" % k, shape=[10], append_batch_size=False)
         for k in range(3)]
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    arr = layers.array_write(d[0], i)
    i = layers.increment(i, in_place=False)
    arr = layers.array_write(d[1], i, array=arr)
    i = layers.increment(i, in_place=False)
    layers.array_write(d[2], i, array=arr)
    j = layers.zeros(shape=[1], dtype="int32")
    j.stop_gradient = True
    acc = layers.zeros(shape=[10], dtype="float32")
    n = layers.fill_constant(shape=[1], dtype="int32", value=3)
    cond = layers.less_than(x=j, y=n)
    w = layers.While(cond=cond)
    with w.block():
        x = layers.array_read(arr, j)
        layers.sums(input=[acc, x], out=acc)
        j = layers.increment(j)
        layers.less_than(x=j, y=n, cond=cond)
    return (acc, layers.array_length(arr))


def test_while_sums_an_array():
    xs = {"d%d" % s: np.random.RandomState(s).rand(10).astype("float32")
          for s in range(3)}
    _same_bytes(while_sum_of_array)
    acc, n = _both(while_sum_of_array, xs)
    np.testing.assert_allclose(acc, xs["d0"] + xs["d1"] + xs["d2"],
                               rtol=1e-6)
    assert n.tolist() == [3]


def array_round_trip(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[4], append_batch_size=False)
    i0 = layers.fill_constant(shape=[1], dtype="int32", value=0)
    i1 = layers.fill_constant(shape=[1], dtype="int32", value=1)
    arr = layers.array_write(x, i0)
    layers.array_write(layers.scale(x=x, scale=2.0), i1, array=arr)
    return (layers.array_read(arr, i0), layers.array_read(arr, i1),
            layers.array_length(arr))


def test_array_write_read_round_trip():
    xv = np.arange(4).astype("float32")
    r0, r1, n = _both(array_round_trip, {"x": xv})
    np.testing.assert_allclose(r0, xv)
    np.testing.assert_allclose(r1, 2 * xv)
    assert n.tolist() == [2]


def ifelse_rowwise(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[1])
    zero = layers.fill_constant_batch_size_like(
        input=x, shape=[-1, 1], dtype="float32", value=0.0)
    ie = layers.IfElse(layers.less_than(x=x, y=zero))
    with ie.true_block():
        ie.output(layers.scale(x=ie.input(x), scale=-1.0))
    with ie.false_block():
        ie.output(layers.scale(x=ie.input(x), scale=2.0))
    return (ie()[0],)


def test_ifelse_negates_and_doubles_by_row():
    xv = np.array([[-1.0], [2.0], [-3.0], [4.0]], dtype="float32")
    _same_bytes(ifelse_rowwise)
    out, = _both(ifelse_rowwise, {"x": xv})
    np.testing.assert_allclose(out, np.where(xv < 0, -xv, 2 * xv))


# ----------------------------------------------------------- capacity --

def loop_program(capacity, iters):
    """A While writing a new value at index i + 1 for i in [0, iters)."""
    def build(fluid):
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
            layers.array_write(layers.elementwise_add(x=v, y=x), counter,
                               arr)
            layers.less_than(x=counter, y=limit, cond=cond)
        return (layers.array_read(arr, counter), layers.array_length(arr))
    return build


def confined_overflow(fluid):
    layers = fluid.layers
    counter = layers.zeros(shape=[1], dtype="int32")
    counter.stop_gradient = True
    limit = layers.fill_constant(shape=[1], dtype="int32", value=3)
    acc = layers.fill_constant(shape=[2], dtype="float32", value=0.0)
    cond = layers.less_than(x=counter, y=limit)
    while_op = layers.While(cond=cond)
    with while_op.block():
        # an array of the block alone; index 5 is past its capacity 2
        scratch = layers.create_array("float32", capacity=2)
        bad = layers.fill_constant(shape=[1], dtype="int32", value=5)
        x = layers.fill_constant(shape=[2], dtype="float32", value=1.0)
        layers.array_write(x, bad, scratch)
        v = layers.array_read(scratch, bad)
        layers.assign(layers.elementwise_add(x=acc, y=v), acc)
        layers.increment(counter, 1, in_place=True)
        layers.less_than(x=counter, y=limit, cond=cond)
    return (acc,)


def straight_line_overflow(fluid):
    layers = fluid.layers
    arr = layers.create_array("float32", capacity=2)
    x = layers.fill_constant(shape=[3], dtype="float32", value=0.5)
    for i in range(3):  # indices 0, 1, 2: 2 is past the capacity
        idx = layers.fill_constant(shape=[1], dtype="int32", value=i)
        layers.array_write(layers.scale(x=x, scale=float(i + 1)), idx, arr)
    return (layers.array_read(arr, idx), layers.array_length(arr))


@pytest.mark.parametrize("build, match", [
    (loop_program(4, 10), "overflowed its capacity 4"),
    (confined_overflow, "sub-block overflowed"),
    (straight_line_overflow, "capacity")],
    ids=["traced", "sub_block_confined", "straight_line"])
def test_overflow_raises_the_jax_message(build, match):
    jerr = _error(jfluid, build)
    terr = _error(tfluid, build)
    assert type(terr) is type(jerr) is RuntimeError
    assert str(terr) == str(jerr)
    assert match in str(terr)


def test_within_capacity_is_clean():
    out, n = _both(loop_program(16, 10))
    np.testing.assert_allclose(out, np.full(4, 11.0))
    assert n.tolist() == [11]


@pytest.fixture
def array_safety_off():
    old = os.environ.get("FLAGS_tensor_array_safety")
    os.environ["FLAGS_tensor_array_safety"] = "0"
    yield
    if old is None:
        del os.environ["FLAGS_tensor_array_safety"]
    else:
        os.environ["FLAGS_tensor_array_safety"] = old


@pytest.mark.parametrize("build", [
    loop_program(4, 10), confined_overflow, straight_line_overflow],
    ids=["traced", "sub_block_confined", "straight_line"])
def test_array_safety_off_raises_nothing(array_safety_off, build):
    """FLAGS_tensor_array_safety=0: no raise in either package, and the
    overflowing writes clamp alike."""
    _both(build)


def test_carry_without_a_value_raises_the_jax_message():
    def build(fluid):
        layers = fluid.layers
        i = layers.zeros(shape=[1], dtype="int32")
        n = layers.fill_constant(shape=[1], dtype="int32", value=2)
        cond = layers.less_than(x=i, y=n)
        block = fluid.default_main_program().current_block()
        acc = block.create_var(name="acc_no_value", shape=[1],
                               dtype="float32")
        w = layers.While(cond=cond)
        with w.block():
            layers.assign(layers.fill_constant([1], "float32", 1.0), acc)
            layers.increment(i, in_place=True)
            layers.less_than(x=i, y=n, cond=cond)
        return (i,)
    jerr = _error(jfluid, build)
    terr = _error(tfluid, build)
    assert isinstance(terr, ValueError) and isinstance(jerr, ValueError)
    assert str(terr).split("\n")[0] == str(jerr).split("\n")[0]
    assert "no value before the loop" in str(terr)


def test_python_int_index_past_capacity_raises_index_error():
    import torch
    arr = TensorArray.empty((3,), torch.float32, 2, torch.device("cpu"))
    arr = arr.write(1, torch.ones(3))
    with pytest.raises(IndexError, match="exceeds capacity 2"):
        arr.write(2, torch.ones(3))


def test_multi_step_while_raises_graph_capture_error():
    with pytest.raises(GraphCaptureError, match="op 'while'"):
        _run(tfluid, loop_program(16, 3), steps=4)


# --------------------------------------------------------- rank tables --

_R = np.random.RandomState(77)
SEQS = [_R.randn(n, 3).astype("float32") for n in (2, 5, 1, 4)]
DESC = np.argsort([-len(s) for s in SEQS], kind="stable")   # 1, 3, 0, 2


def _seq_data(fluid):
    return fluid.layers.data(name="x", shape=[3], dtype="float32",
                             lod_level=1)


def rank_max_len(fluid):
    table = fluid.layers.lod_rank_table(_seq_data(fluid))
    return (fluid.layers.max_sequence_len(table),)


def rank_reorder(fluid):
    x = _seq_data(fluid)
    y = fluid.layers.reorder_lod_tensor_by_rank(
        x, fluid.layers.lod_rank_table(x))
    return (y, fluid.layers.sequence_pool(input=y, pool_type="first"),
            fluid.layers.sequence_pool(input=y, pool_type="last"))


def rank_round_trip(fluid):
    x = _seq_data(fluid)
    table = fluid.layers.lod_rank_table(x)
    back = fluid.layers.array_to_lod_tensor(
        fluid.layers.lod_tensor_to_array(x, table), table)
    return (back, fluid.layers.sequence_pool(input=back, pool_type="sum"))


def rank_steps(fluid):
    x = _seq_data(fluid)
    arr = fluid.layers.lod_tensor_to_array(x, fluid.layers.lod_rank_table(x))
    return tuple(fluid.layers.array_read(
        array=arr, i=fluid.layers.fill_constant(shape=[1], dtype="int64",
                                                value=k)) for k in (0, 1))


def rank_shrink(fluid):
    x = _seq_data(fluid)
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=1)
    mem = fluid.layers.fc(input=x, size=4, num_flatten_dims=2,
                          bias_attr=False,
                          param_attr=fluid.ParamAttr(
                              name="shrink_w",
                              initializer=fluid.initializer.Constant(0.5)))
    return (mem, fluid.layers.shrink_memory(
        mem, i, fluid.layers.lod_rank_table(x)))


def rank_reorder_grad(fluid):
    x = _seq_data(fluid)
    x.stop_gradient = False
    y = fluid.layers.reorder_lod_tensor_by_rank(
        x, fluid.layers.lod_rank_table(x))
    w = fluid.layers.assign(
        np.arange(1, 5, dtype="float32").reshape(4, 1, 1))
    loss = fluid.layers.reduce_sum(y * w)
    fluid.append_backward(loss)
    return (loss, "x@GRAD")


@pytest.mark.parametrize("build", [rank_max_len, rank_reorder,
                                   rank_round_trip, rank_steps, rank_shrink,
                                   rank_reorder_grad],
                         ids=["max_sequence_len", "reorder", "round_trip",
                              "array_steps", "shrink_memory",
                              "reorder_gradient"])
def test_rank_table_ops_match_the_jax_package(build):
    _same_bytes(build)
    outs = _both(build, {"x": SEQS})
    if build is rank_max_len:
        assert outs[0].ravel().tolist() == [5]
    elif build is rank_reorder:
        for row, src in enumerate(DESC):
            s = SEQS[src]
            np.testing.assert_allclose(outs[0][row, :len(s)], s)
            np.testing.assert_allclose(outs[2][row], s[-1])
    elif build is rank_round_trip:
        for i, s in enumerate(SEQS):
            np.testing.assert_allclose(outs[0][i, :len(s)], s)
    elif build is rank_steps:
        np.testing.assert_allclose(
            outs[0], np.stack([SEQS[src][0] for src in DESC]))
    elif build is rank_shrink:
        np.testing.assert_array_equal(outs[1], outs[0])
    else:
        for row, src in enumerate(DESC):
            np.testing.assert_allclose(outs[1][src, :len(SEQS[src])],
                                       float(row + 1))
