"""Executor.run(steps=K) in the port, on the CPU, against K sequential
runs and against the JAX package's steps=K.

The contract: a K-step call replays the per-step seeds Scope.next_seed
would have issued, so fetches, parameters, optimizer accumulators,
batch-norm statistics, @LR_DECAY_COUNTER@ and dropout masks match K
sequential run() calls bit for bit. On the CPU the K steps run the plain
version of the CUDA graph runner (lowering.MultiStepRunner): the same
static buffers, copy-back, reseeded generators and cache, each step run
eagerly. Ported from tests/unittests/test_multi_step_executor.py's cases
that need no reader, no While and no in-graph assertion.

Parity with the JAX package: with dropout off, both packages start from
the JAX package's startup state (carried over with io.scope_from_numpy)
and run steps=4; stacked losses and final state agree within rtol 1e-5,
atol 1e-6 (fp32 on both sides, sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import lowering

PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_mlp(fluid, seed=13, dropout_prob=0.3):
    """fc + dropout + Momentum under exponential LR decay: params,
    velocity accumulators, @LR_DECAY_COUNTER@ and a dropout stream."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=dropout_prob)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        lr = fluid.layers.exponential_decay(
            learning_rate=0.05, decay_steps=2, decay_rate=0.8)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def _mlp_feed():
    rng = np.random.RandomState(3)
    xs = rng.rand(8, 16).astype("float32")
    return {"x": xs, "y": (xs.sum(1, keepdims=True) * 0.1).astype("float32")}


def _build_conv_bn(fluid, seed=11):
    """conv + batch_norm (running statistics) + dropout + fc, Momentum
    under exponential LR decay."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 8, 8],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   padding=1, act="relu")
        bn = fluid.layers.batch_norm(input=conv)
        drop = fluid.layers.dropout(bn, dropout_prob=0.4)
        pred = fluid.layers.fc(input=drop, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        lr = fluid.layers.exponential_decay(
            learning_rate=0.1, decay_steps=2, decay_rate=0.8)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def _conv_bn_feed():
    rng = np.random.RandomState(0)
    return {"img": rng.rand(4, 1, 8, 8).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}


PROGRAMS = {"mlp": (_build_mlp, _mlp_feed),
            "conv_bn": (_build_conv_bn, _conv_bn_feed)}


def _snapshot(scope):
    return {n: scope.get(n).clone() for n in scope.names()
            if scope.get(n) is not None}


def _start(which):
    """(program, loss, feed, executor, startup state, seed counter)."""
    build, make_feed = PROGRAMS[which]
    main, startup, loss = build(tfluid)
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, loss, make_feed(), exe, _snapshot(scope), scope._rng_counter


def _scope_at(init, counter):
    scope = tfluid.Scope()
    for n, v in init.items():
        scope.set(n, v.clone())
    scope._rng_counter = counter
    return scope


def _sequential(main, loss, feed, exe, scope, k=K):
    return np.concatenate([
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        .reshape(1, -1) for _ in range(k)])


def _assert_scopes_equal(a, b):
    assert sorted(a.names()) == sorted(b.names())
    for n in a.names():
        assert torch.equal(a.get(n), b.get(n)), n


@pytest.mark.parametrize("which", sorted(PROGRAMS))
def test_multi_step_is_bit_identical_to_sequential_runs(which):
    main, loss, feed, exe, init, counter = _start(which)
    seq_scope = _scope_at(init, counter)
    seq = _sequential(main, loss, feed, exe, seq_scope)
    # the losses evolve, or the comparison proves nothing
    assert len({float(s[0]) for s in seq}) > 1
    ms_scope = _scope_at(init, counter)
    stacked, = exe.run(main, feed=feed, fetch_list=[loss], scope=ms_scope,
                       steps=K)
    assert stacked.shape[0] == K
    np.testing.assert_array_equal(stacked.reshape(K, -1), seq)
    # params, velocities, batch-norm statistics, @LR_DECAY_COUNTER@
    _assert_scopes_equal(seq_scope, ms_scope)
    assert any("LR_DECAY_COUNTER" in n for n in ms_scope.names())
    assert ms_scope._rng_counter == seq_scope._rng_counter == counter + K
    # a second call continues where K more sequential runs would
    np.testing.assert_array_equal(
        exe.run(main, feed=feed, fetch_list=[loss], scope=ms_scope,
                steps=K)[0].reshape(K, -1),
        _sequential(main, loss, feed, exe, seq_scope))
    _assert_scopes_equal(seq_scope, ms_scope)


def test_dropout_masks_line_up_with_sequential_runs():
    """The dropout mask of each of the K steps, fetched stacked, is the
    mask of the matching sequential run (each step its own draw)."""
    main, loss, feed, exe, init, counter = _start("mlp")
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].outputs["Mask"][0]
    seq_scope = _scope_at(init, counter)
    seq = [exe.run(main, feed=feed, fetch_list=[mask], scope=seq_scope)[0]
           for _ in range(K)]
    masks, = exe.run(main, feed=feed, fetch_list=[mask],
                     scope=_scope_at(init, counter), steps=K)
    np.testing.assert_array_equal(masks, np.stack(seq))
    assert not np.array_equal(masks[0], masks[1])


def test_fetch_reduce_policies():
    main, loss, feed, exe, init, counter = _start("mlp")
    seq = _sequential(main, loss, feed, exe, _scope_at(init, counter))
    last, = exe.run(main, feed=feed, fetch_list=[loss],
                    scope=_scope_at(init, counter), steps=K,
                    fetch_reduce="last")
    np.testing.assert_array_equal(last.reshape(1, -1), seq[-1:])
    mean, = exe.run(main, feed=feed, fetch_list=[loss],
                    scope=_scope_at(init, counter), steps=K,
                    fetch_reduce="mean")
    assert mean.dtype == np.float32
    np.testing.assert_allclose(mean.reshape(-1), seq.mean(0), rtol=1e-6)


def test_bad_args_raise():
    main, loss, feed, exe, init, counter = _start("conv_bn")
    scope = _scope_at(init, counter)
    with pytest.raises(ValueError, match="steps"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=0)
    with pytest.raises(ValueError, match="fetch_reduce"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2,
                fetch_reduce="sum")
    for kw in ({"validate": True}, {"apply_tuned": True}):
        with pytest.raises(NotImplementedError, match="A11"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope, **kw)
    # nothing ran: the scope is as it started
    for n, v in init.items():
        assert torch.equal(scope.get(n), v), n
    assert scope._rng_counter == counter


def test_runner_cache_keys_on_steps_and_reduce(monkeypatch):
    main, loss, feed, exe, init, counter = _start("conv_bn")
    scope = _scope_at(init, counter)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n1 = len(exe._cache)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2)
    n2 = len(exe._cache)
    assert n2 == n1 + 1                      # K joined the key
    runner = next(reversed(exe._cache.values()))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2)
    assert len(exe._cache) == n2             # a hit: the same runner
    assert next(reversed(exe._cache.values())) is runner
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=3)
    assert len(exe._cache) == n2 + 1         # another K
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=3,
            fetch_reduce="mean")
    assert len(exe._cache) == n2 + 2         # another fetch_reduce
    # steps=1 ignores fetch_reduce (no loop to reduce over)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
            fetch_reduce="mean")
    assert len(exe._cache) == n2 + 2
    # another feed shape is another key
    small = {n: v[:2] for n, v in feed.items()}
    exe.run(main, feed=small, fetch_list=[loss], scope=scope, steps=2)
    assert len(exe._cache) == n2 + 3
    # use_program_cache=False builds a fresh runner and keeps nothing
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=5,
            use_program_cache=False)
    assert len(exe._cache) == n2 + 3
    # the LRU bound of the JAX package's knob
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", "2")
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=6)
    assert len(exe._cache) == 2
    assert next(reversed(exe._cache))[4] == 6


def test_uncached_run_matches_cached_run():
    main, loss, feed, exe, init, counter = _start("mlp")
    a, = exe.run(main, feed=feed, fetch_list=[loss],
                 scope=_scope_at(init, counter), steps=3)
    b_scope = _scope_at(init, counter)
    b, = exe.run(main, feed=feed, fetch_list=[loss], scope=b_scope,
                 steps=3, use_program_cache=False)
    np.testing.assert_array_equal(a, b)
    assert len(exe._cache) == 1   # the first call's runner only


def test_fetches_stay_on_the_device_without_numpy():
    main, loss, feed, exe, init, counter = _start("conv_bn")
    scope = _scope_at(init, counter)
    h, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2,
                 fetch_reduce="last", return_numpy=False)
    assert isinstance(h, torch.Tensor) and h.device == exe.device
    assert tuple(h.shape) == (1,)
    s, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2,
                 return_numpy=False)
    assert tuple(s.shape) == (2, 1) and torch.isfinite(s).all()


@pytest.mark.parametrize("k", [1, 2, 5])
def test_next_seed_block_moves_the_counter_as_k_runs(k):
    main, loss, feed, exe, init, counter = _start("mlp")
    seq_scope = _scope_at(init, counter)
    _sequential(main, loss, feed, exe, seq_scope, k)
    scope = _scope_at(init, counter)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=k)
    assert scope._rng_counter == seq_scope._rng_counter == counter + k
    s = tfluid.Scope()
    assert s.next_seed_block(k) == 1 and s.next_seed() == k + 1


def test_nothing_handed_out_changes_under_a_later_call():
    """Fetches, fetch_var(return_numpy=False), get_parameter_value and
    the scope's own tensors from one call are untouched by the next."""
    main, loss, feed, exe, init, counter = _start("mlp")
    scope = _scope_at(init, counter)
    first, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                     steps=2, return_numpy=False)
    first_copy = first.clone()
    param = main.all_parameters()[0]
    held = tfluid.fetch_var(param.name, scope=scope, return_numpy=False)
    held_copy = held.clone()
    as_numpy = tio.get_parameter_value(param, exe, scope=scope)
    numpy_copy = as_numpy.copy()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2)
    assert torch.equal(first, first_copy)
    assert torch.equal(held, held_copy)
    np.testing.assert_array_equal(as_numpy, numpy_copy)
    assert not torch.equal(scope.get(param.name), held)


def test_scope_changes_between_calls_are_seen():
    """A scope.set, a startup re-run or an eager step between two K-step
    calls reaches the next call: it equals sequential runs from the
    changed state."""
    main, startup, loss = _build_mlp(tfluid)
    feed = _mlp_feed()
    exe = tfluid.Executor("cpu")
    ms, seq = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=ms)
    for n in ms.names():
        seq.set(n, ms.get(n).clone())
    seq._rng_counter = ms._rng_counter

    def both(k=2):
        a, = exe.run(main, feed=feed, fetch_list=[loss], scope=ms, steps=k)
        np.testing.assert_array_equal(
            a.reshape(k, -1), _sequential(main, loss, feed, exe, seq, k))
        _assert_scopes_equal(seq, ms)

    both()
    name = main.all_parameters()[0].name
    for s in (ms, seq):
        s.set(name, s.get(name) * 0.5)
    both()
    # an in-place change of a scope tensor is seen too
    for s in (ms, seq):
        s.get(name).mul_(0.5)
    both()
    exe.run(main, feed=feed, fetch_list=[loss], scope=ms)
    exe.run(main, feed=feed, fetch_list=[loss], scope=seq)
    both()
    exe.run(startup, scope=ms)
    exe.run(startup, scope=seq)
    both()


def test_prefetch_on_a_feed_fed_program_changes_nothing():
    """Port of the JAX package's test_training_prefetch_feed_fed_identical:
    prefetch=True on a program fed through `feed` gives the same bits,
    single-step and K-step."""
    main, loss, feed, exe, init, counter = _start("mlp")
    ref_scope, pf_scope = _scope_at(init, counter), _scope_at(init, counter)
    for steps in (1, 3, 1):
        a, = exe.run(main, feed=feed, fetch_list=[loss], scope=ref_scope,
                     steps=steps)
        b, = exe.run(main, feed=feed, fetch_list=[loss], scope=pf_scope,
                     steps=steps, prefetch=True)
        np.testing.assert_array_equal(a, b)
    _assert_scopes_equal(ref_scope, pf_scope)


def test_analyze_state_matches_the_jax_package():
    from paddle_tpu.core import lowering as jlowering
    for which in sorted(PROGRAMS):
        build, make_feed = PROGRAMS[which]
        tmain, _, tloss = build(tfluid)
        jmain, _, jloss = build(jfluid)
        feeds = sorted(make_feed())
        assert lowering.analyze_state(tmain, feeds, [tloss.name]) == \
            tuple(jlowering.analyze_state(jmain, feeds, [jloss.name]))


@pytest.mark.parametrize("which", sorted(PROGRAMS))
def test_steps_match_the_jax_package(which, monkeypatch):
    """Dropout off, the JAX package's startup state in both: the JAX
    steps=4 stacked losses and final state against the port's."""
    monkeypatch.setenv("FLAGS_multistep_unroll", "0")
    build, make_feed = PROGRAMS[which]
    feed = make_feed()
    jmain, jstartup, jloss = build(jfluid)
    for op in jmain.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
        if op.type == "grad_of" and op.attrs.get("fwd_type") == "dropout":
            op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        jout, = jexe.run(jmain, feed=feed, fetch_list=[jloss], steps=K)
    tmain, _, tloss = build(tfluid)
    for op in tmain.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    tout, = tfluid.Executor("cpu").run(tmain, feed=feed, fetch_list=[tloss],
                                       scope=tscope, steps=K)
    np.testing.assert_allclose(tout.reshape(K, -1),
                               np.asarray(jout).reshape(K, -1), **PARITY_TOL)
    assert len({float(x) for x in np.asarray(jout).reshape(-1)}) > 1
    for n in state:
        np.testing.assert_allclose(
            tscope.get(n).numpy(), np.asarray(jscope.get(n)),
            err_msg=n, **PARITY_TOL)


def test_a_failed_build_is_built_again_not_run_half_built():
    """A runner whose first build raised builds again on the next call:
    it never runs over the buffers of a build that did not finish."""
    from paddle_tpu_torch.core import registry
    calls = []

    def flaky(ctx, ins, attrs):
        if ins["X"][0].device.type != "meta":   # not shape inference
            calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("flaky op")
        return {"Out": [ins["X"][0] * 2.0]}

    name = "test_flaky_double"
    registry.register(name, flaky)
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            block = main.global_block()
            doubled = block.create_var(name="doubled", shape=[-1, 4],
                                       dtype="float32")
            block.append_op(type=name, inputs={"X": [x]},
                            outputs={"Out": [doubled]})
            loss = tfluid.layers.mean(tfluid.layers.fc(input=doubled,
                                                       size=2))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = tfluid.Executor("cpu")
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        init, counter = _snapshot(scope), scope._rng_counter
        feed = {"x": np.random.RandomState(1).rand(3, 4).astype("float32")}
        with pytest.raises(RuntimeError, match="flaky op"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=3)
        for n, v in init.items():
            assert torch.equal(scope.get(n), v), n
        ms_scope = _scope_at(init, counter)
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=ms_scope,
                       steps=3)
        seq_scope = _scope_at(init, counter)
        np.testing.assert_array_equal(
            got.reshape(3, -1), _sequential(main, loss, feed, exe, seq_scope,
                                            3))
        _assert_scopes_equal(seq_scope, ms_scope)
    finally:
        del registry._OPS[name]
