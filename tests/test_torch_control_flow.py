"""The port's StaticRNN / DynamicRNN (one rnn_scan op over a step block)
against the JAX package and numpy on the CPU.

Mirrors tests/unittests/test_control_flow.py's recurrence tests: a numpy
recurrence, masking past each row's length, a static input with an
explicit memory init, and gradients. Both packages build the same program
from the same layer calls; the JAX package runs its startup program and
every persistable it holds is carried into the port with
io.scope_from_numpy. The same feeds, made with numpy from a seed, go
through both.

Tolerances: rtol = atol = 1e-5 on forward values and step-1 gradients
(fp32 on both sides, summed in another order, over at most 11 steps);
2e-5 against the numpy recurrence, as the JAX tests hold it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor

TOL = dict(rtol=1e-5, atol=1e-5)
NUMPY_TOL = dict(rtol=2e-5, atol=2e-5)
_LOD = {"jax": JLoDTensor, "port": TLoDTensor}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _feed(pkg, seqs, dense):
    feed = {n: _LOD[pkg].from_sequences(s) for n, s in seqs.items()}
    feed.update(dense)
    return feed


def _run_both(build, seqs=None, dense=None, extra_fetch=()):
    """One run of each package's build from the JAX startup state, their
    fetches held together; returns (port fetches, the startup state, the
    port's main program). `extra_fetch` names vars (gradients) fetched
    after the build's own fetch list."""
    seqs, dense = seqs or {}, dense or {}
    jmain, jstartup, jfetch = _build(jfluid, build)
    tmain, _, tfetch = _build(tfluid, build)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        want = jexe.run(jmain, feed=_feed("jax", seqs, dense),
                        fetch_list=[v.name for v in jfetch]
                        + list(extra_fetch))
    scope = tio.scope_from_numpy(state, "cpu", program=tmain)
    got = tfluid.Executor("cpu").run(
        tmain, feed=_feed("port", seqs, dense),
        fetch_list=[v.name for v in tfetch] + list(extra_fetch), scope=scope)
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg="fetch %d" % i, **TOL)
    return got, state, tmain


def _ragged(seed, lengths, width):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, width) * 0.5).astype("float32") for n in lengths]


def test_program_blocks_and_rollback():
    """create_block makes a child of the current block current; rollback
    returns to its parent; a sub-block finds its parent's vars."""
    p = tfluid.Program()
    g = p.global_block()
    g.create_var(name="outer", shape=[2], dtype="float32")
    sub = p.create_block()
    assert (sub.idx, sub.parent_idx) == (1, 0) and p.current_block() is sub
    inner = p.create_block()
    assert inner.parent_idx == 1
    assert inner.has_var_recursive("outer") and not g.has_var_recursive("x")
    p.rollback()
    assert p.current_block() is sub
    p.rollback()
    assert p.current_block() is g
    other = p.create_block(parent_idx=1)
    assert (other.idx, other.parent_idx) == (3, 1)


def test_static_rnn_matches_numpy_and_the_jax_package():
    """h_t = tanh(x_t W_x + h_{t-1} W_h), memory booted from zeros by
    fill_constant_batch_size_like; output and step-1 weight gradients."""
    b, t, d, h = 3, 5, 4, 6

    def build(fluid):
        layers = fluid.layers
        x = layers.data("x", shape=[t, d])
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hm = rnn.memory(shape=[h], batch_ref=x, init_value=0.0)
            nh = layers.fc(input=[xt, hm], size=h, act="tanh",
                           bias_attr=False)
            rnn.update_memory(hm, nh)
            rnn.output(nh)
        out = rnn()
        loss = layers.mean(layers.reduce_sum(out, dim=[1, 2]))
        fluid.append_backward(loss)
        return [out]

    xv = np.random.RandomState(0).randn(b, t, d).astype("float32")
    got, state, tmain = _run_both(build, dense={"x": xv},
                                  extra_fetch=["fc_0.w_0@GRAD",
                                               "fc_0.w_1@GRAD"])
    w_x, w_h = state["fc_0.w_0"], state["fc_0.w_1"]
    hs = np.zeros((b, h), np.float32)
    ref = []
    for s in range(t):
        hs = np.tanh(xv[:, s] @ w_x + hs @ w_h)
        ref.append(hs)
    np.testing.assert_allclose(got[0], np.stack(ref, axis=1), **NUMPY_TOL)
    assert np.abs(got[1]).sum() > 0 and np.abs(got[2]).sum() > 0
    scan, = [op for op in tmain.global_block().ops if op.type == "rnn_scan"]
    assert "SeqLen" not in scan.inputs           # StaticRNN masks nothing


def test_dynamic_rnn_masks_past_length():
    """Outputs past each row's length are exactly 0; the memory freezes, so
    the last step of each row is the state at its true length."""
    d, h = 4, 5
    lengths = [2, 4, 1]

    def build(fluid):
        layers = fluid.layers
        x = layers.data("x", shape=[d], lod_level=1)
        rnn = layers.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            hm = rnn.memory(shape=[h], value=0.0)
            nh = layers.fc(input=[xt, hm], size=h, act="tanh",
                           bias_attr=False)
            rnn.update_memory(hm, nh)
            rnn.output(nh)
        out = rnn()
        final = layers.sequence_last_step(out)
        return [out, final]

    seqs = _ragged(0, lengths, d)
    (outv, finv), state, _ = _run_both(build, seqs={"x": seqs})
    w_x, w_h = state["fc_0.w_0"], state["fc_0.w_1"]
    assert outv.shape[1] == 8          # the executor pads T to a multiple
    for i, n in enumerate(lengths):
        hs = np.zeros((h,), np.float32)
        for s in range(n):
            hs = np.tanh(seqs[i][s] @ w_x + hs @ w_h)
            np.testing.assert_allclose(outv[i, s], hs, **NUMPY_TOL)
        assert np.all(outv[i, n:] == 0)
        np.testing.assert_allclose(finv[i], hs, **NUMPY_TOL)


def test_dynamic_rnn_static_input_and_memory_init():
    """A per-sequence static input, visible unchanged at every step, and
    an explicit memory init: h_t = tanh(x_t W + s U + h_{t-1} V)."""
    d, s_dim, h = 3, 2, 4
    lengths = [4, 2]
    rng = np.random.RandomState(21)
    static = rng.randn(2, s_dim).astype("float32")
    h0 = (rng.randn(2, h) * 0.3).astype("float32")

    def build(fluid):
        layers = fluid.layers
        x = layers.data("x", shape=[d], dtype="float32", lod_level=1)
        sv = layers.data("s", shape=[s_dim], dtype="float32")
        h0v = layers.data("h0", shape=[h], dtype="float32")
        rnn = layers.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            st = rnn.static_input(sv)
            hm = rnn.memory(init=h0v)
            nh = layers.fc(input=[xt, st, hm], size=h, act="tanh",
                           bias_attr=False)
            rnn.update_memory(hm, nh)
            rnn.output(nh)
        out = rnn()
        return [layers.sequence_pool(input=out, pool_type="last")]

    seqs = _ragged(22, lengths, d)
    (last,), state, tmain = _run_both(build, seqs={"x": seqs},
                                      dense={"s": static, "h0": h0})
    w_x, u_s, v_h = (state["fc_0.w_%d" % i] for i in range(3))
    for i, seq in enumerate(seqs):
        hs = h0[i].astype(np.float64)
        for step in seq:
            hs = np.tanh(step @ w_x + static[i] @ u_s + hs @ v_h)
        np.testing.assert_allclose(last[i], hs, rtol=1e-4, atol=1e-5)
    scan, = [op for op in tmain.global_block().ops if op.type == "rnn_scan"]
    assert "s" in scan.inputs["Static"] and scan.inputs["Boot"] == ["h0"]


def _rnn_then_fc(fluid):
    """A DynamicRNN whose output feeds a differentiated fc: the ops after
    the rnn_scan keep their graphs only if the step block leaves the
    run's grad_of table alone."""
    layers = fluid.layers
    x = layers.data("x", shape=[3], lod_level=1)
    x.stop_gradient = False             # data vars default to no-grad
    rnn = layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        hm = rnn.memory(shape=[4], value=0.0)
        nh = layers.fc(input=[xt, hm], size=4, act="tanh")
        rnn.update_memory(hm, nh)
        rnn.output(nh)
    out = rnn()
    proj = layers.fc(input=out, size=2, act="tanh")
    loss = layers.mean(layers.sequence_pool(proj, "sum"))
    fluid.append_backward(loss)
    return [loss]


def test_ops_after_the_rnn_keep_their_graphs():
    """Every gradient, of the step block's parameters, of the fc after the
    RNN and of the input sequence, matches the JAX package's; padding
    steps of x get exactly 0."""
    grads = ["fc_0.w_0@GRAD", "fc_0.w_1@GRAD", "fc_0.w_2@GRAD",
             "fc_1.w_0@GRAD", "fc_1.w_1@GRAD", "x@GRAD"]
    lengths = [3, 1, 2]
    got, _, tmain = _run_both(_rnn_then_fc,
                              seqs={"x": _ragged(9, lengths, 3)},
                              extra_fetch=grads)
    for g in got[1:]:
        assert np.abs(g).sum() > 0
    for i, n in enumerate(lengths):
        assert np.all(got[-1][i, n:] == 0)
    types = [op.type for op in tmain.global_block().ops]
    assert types.index("rnn_scan") < types.index("mul")  # the later fc


def test_a_sub_block_run_through_lower_block_breaks_the_later_grads(
        monkeypatch):
    """The repair the test above guards: were rnn_scan to run its step
    block through lower_block, which sets the run's grad_of table from the
    block it runs, the fc after it would keep no graph."""
    from paddle_tpu_torch.ops import control_ops
    main, startup, (loss,) = _build(tfluid, _rnn_then_fc)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = _feed("port", {"x": _ragged(9, [3, 1, 2], 3)}, {})
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    monkeypatch.setattr(control_ops, "lower_sub_block", lowering.lower_block)
    with pytest.raises(RuntimeError, match="kept no graph"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def test_rnn_programs_serialize_like_the_jax_ones():
    """Block 1 (the step block), its parent link and the rnn_scan op's
    inputs and attrs: the same bytes as the JAX package's program."""
    jmain, jstartup, _ = _build(jfluid, _rnn_then_fc)
    tmain, tstartup, _ = _build(tfluid, _rnn_then_fc)
    assert len(tmain.blocks) == 2 and tmain.blocks[1].parent_idx == 0
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        assert tdesc.program_to_bytes(t) == jdesc.program_to_bytes(j)
    scan, = [op for op in tmain.global_block().ops if op.type == "rnn_scan"]
    assert scan.inputs["SeqLen"] == ["x@SEQLEN"]
    assert tmain.global_block().var(scan.outputs["Out"][0]).shape == \
        (-1, -1, 4)
