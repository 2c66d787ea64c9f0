"""memory_optimization_transpiler in the port: the liveness report against
the JAX package's, and rematerialization (enable_rematerialization) in
the port's interpreter (tests/unittests/test_remat_segments.py).

Rematerialization must not change a value: a segment runs again from its
boundary values with the same ops, the same inputs and the same random
streams (a random op seeds from its uid), so the losses and the state
with it on equal those with it off bit for bit on the CPU, dropout,
bf16 AMP, steps=K and a While included. REMAT_COUNTS shows the recompute
ran.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import make_mesh


@pytest.fixture(autouse=True)
def _counts():
    for k in lowering.REMAT_COUNTS:
        lowering.REMAT_COUNTS[k] = 0
    yield lowering.REMAT_COUNTS


def _conv_net(fluid, dropout=0.3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 12, 12],
                                dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64")
        h = img
        for _ in range(3):  # enough forward ops to cross the remat gate
            h = fluid.layers.conv2d(input=h, num_filters=6, filter_size=3,
                                    padding=1, act="relu")
            h = fluid.layers.batch_norm(input=h)
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout, seed=11)
        pred = fluid.layers.fc(input=h, size=5, act="softmax")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=pred, label=lab))
        fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def _feeds(n, seed=2):
    r = np.random.RandomState(seed)
    return [{"img": r.rand(8, 1, 12, 12).astype("f"),
             "lab": r.randint(0, 5, (8, 1)).astype("int64")}
            for _ in range(n)]


def _train(build, remat, feeds, k=1, amp=False):
    """(losses, state) of len(feeds) steps=k calls from one startup."""
    main, startup, loss = build(tfluid)
    if amp:
        main.enable_mixed_precision()
    if remat:
        tfluid.memory_optimization_transpiler.enable_rematerialization(main)
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for f in feeds:
        out, = exe.run(main, feed=f, fetch_list=[loss], scope=scope, steps=k)
        losses += np.ravel(out).tolist()
    return losses, {n: to_numpy(scope.get(n)) for n in scope.names()}


def _assert_same(a, b):
    assert a[0] == b[0]
    assert sorted(a[1]) == sorted(b[1])
    for n in a[1]:
        np.testing.assert_array_equal(a[1][n], b[1][n], err_msg=n)


def test_remat_is_bit_equal_through_dropout(_counts):
    base = _train(_conv_net, False, _feeds(4))
    assert _counts["deferred_segments"] == 0
    remat = _train(_conv_net, True, _feeds(4))
    _assert_same(base, remat)
    # every deferred segment ran again, once a step
    assert _counts["deferred_segments"] > 0
    assert _counts["recomputed_segments"] == _counts["deferred_segments"]
    assert _counts["deferred_segments"] % 4 == 0
    assert _counts["replayed_ops"] == 0
    assert np.isfinite(base[0]).all()


def test_remat_is_bit_equal_under_steps_k(_counts):
    base = _train(_conv_net, False, _feeds(2), k=3)
    remat = _train(_conv_net, True, _feeds(2), k=3)
    _assert_same(base, remat)
    assert _counts["recomputed_segments"] > 0


def test_remat_is_bit_equal_under_bf16_amp(_counts):
    base = _train(_conv_net, False, _feeds(3), amp=True)
    remat = _train(_conv_net, True, _feeds(3), amp=True)
    _assert_same(base, remat)
    assert _counts["recomputed_segments"] > 0


def test_remat_segment_len_flag(monkeypatch, _counts):
    """FLAGS_remat_segment_len sets the ops a segment: longer segments,
    fewer of them; the values stay the same."""
    monkeypatch.setenv("FLAGS_remat_segment_len", "64")
    few = _train(_conv_net, True, _feeds(1))
    n_few = _counts["deferred_segments"]
    monkeypatch.setenv("FLAGS_remat_segment_len", "4")
    many = _train(_conv_net, True, _feeds(1))
    n_many = _counts["deferred_segments"] - n_few
    assert n_many > n_few >= 1
    _assert_same(few, many)
    monkeypatch.setenv("FLAGS_remat_segment_len", "x")
    with pytest.raises(ValueError, match="FLAGS_remat_segment_len"):
        lowering.remat_segment_len_flag()


def _while_net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=6, act="relu")
        h = fluid.layers.fc(input=h, size=6, act="relu")
        h = fluid.layers.fc(input=h, size=6, act="relu")
        i = fluid.layers.zeros(shape=[1], dtype="int64")
        i.stop_gradient = True
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
        s0 = fluid.layers.zeros(shape=[1], dtype="float32")
        s0.stop_gradient = True
        cond = fluid.layers.less_than(x=i, y=n)
        w = fluid.layers.While(cond=cond)
        with w.block():
            fluid.layers.sums(input=[s0, fluid.layers.reduce_sum(h)],
                              out=s0)
            i2 = fluid.layers.increment(i)
            fluid.layers.less_than(x=i2, y=n, cond=cond)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def test_remat_with_a_top_level_while_is_bit_equal(_counts):
    """A While reads enclosing values its op inputs do not list: its
    segment stays a checkpoint, and nothing it reads is deferred."""
    r = np.random.RandomState(7)
    feeds = [{"x": r.rand(8, 6).astype("f"), "y": r.rand(8, 1).astype("f")}
             for _ in range(3)]
    _assert_same(_train(_while_net, False, feeds),
                 _train(_while_net, True, feeds))


def _small_net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.dropout(fluid.layers.fc(input=x, size=1,
                                                 act="tanh"),
                                 dropout_prob=0.5)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            input=h, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_remat_below_the_gate_replays_each_op(_counts):
    """Fewer than 8 forward ops: no segment pass; each differentiated op
    keeps only its inputs and runs again at its grad_of (the JAX
    package's per-op checkpoint), dropout's mask included."""
    r = np.random.RandomState(1)
    feeds = [{"x": r.rand(8, 6).astype("f"), "y": r.rand(8, 1).astype("f")}
             for _ in range(3)]
    base = _train(_small_net, False, feeds)
    remat = _train(_small_net, True, feeds)
    _assert_same(base, remat)
    assert _counts["deferred_segments"] == 0
    assert _counts["replayed_ops"] > 0


def test_remat_under_parallel_executor_matches_single(_counts):
    """ParallelExecutor runs no segment pass: each lane replays its ops
    at their grad_ofs, and the 2-replica run matches the 1-replica one
    as without remat."""
    feeds = _feeds(3, seed=8)

    def run(remat, n):
        main, startup, loss = _conv_net(tfluid, dropout=0)
        if remat:
            tfluid.memory_optimization_transpiler \
                .enable_rematerialization(main)
        scope = tfluid.Scope()
        tfluid.Executor("cpu").run(startup, scope=scope)
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(
                main_program=main, loss_name=loss.name,
                mesh=make_mesh({"dp": n}, ["cpu"] * n))
            return [float(np.ravel(pexe.run(fetch_list=[loss],
                                            feed=f)[0])[0])
                    for f in feeds]

    one = run(True, 1)
    assert _counts["replayed_ops"] > 0
    assert one == run(False, 1)
    np.testing.assert_allclose(run(True, 2), one, rtol=1e-5, atol=1e-6)


def test_remat_transformer_with_fused_attention_is_bit_equal(_counts):
    """The Transformer training step (fused attention, label smoothing)
    with remat on and off, 3 steps."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, avg, _ = ttransformer.build_train(
                40, 40, 8, d_model=16, n_layer=2, n_head=2, d_key=8,
                d_value=8, d_inner_hid=32, use_fused_attention=True,
                label_smooth_eps=0.1)
        return main, startup, avg

    rng = np.random.RandomState(4)
    feeds = []
    for _ in range(3):
        src = [rng.randint(1, 40, rng.randint(3, 9)) for _ in range(4)]
        trg = [rng.randint(1, 40, rng.randint(3, 9)) for _ in range(4)]
        feeds.append(ttransformer.prepare_batch(src, trg, 8, labels=True))
    _assert_same(_train(build, False, feeds), _train(build, True, feeds))
    assert _counts["recomputed_segments"] > 0


def _pipelined(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.pipelined_stack(
            x, 3, lambda xin: fluid.layers.fc(input=xin, size=16,
                                              act="relu"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            input=fluid.layers.fc(input=h, size=1), label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("which", ["conv", "pipelined"])
def test_memory_optimize_report_matches_jax(which):
    build = _conv_net if which == "conv" else _pipelined

    jmain = build(jfluid)[0]
    tmain = build(tfluid)[0]
    want = jfluid.memory_optimize(jmain)
    got = tfluid.memory_optimize(tmain, print_log=True)
    assert got == want and len(got) > 0
    assert tmain.__dict__["__memopt_analyzed__"] is True
    assert tfluid.release_memory(tmain) is tmain


def test_enable_rematerialization_marks_the_program():
    main = _conv_net(tfluid)[0]
    v = main._version
    out = tfluid.memory_optimization_transpiler.enable_rematerialization(
        main)
    assert out is main and main._rematerialize is True
    assert main._version != v
    # it rides the program's clone, not its bytes
    assert main.clone()._rematerialize is True
