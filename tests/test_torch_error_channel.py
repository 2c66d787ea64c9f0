"""The in-graph assertion channel (LowerCtx.add_error) against the JAX
package, on the CPU.

Both packages build the same programs and run them on the same numpy feeds
from a seed; where a run trips an assertion, both raise a RuntimeError
with the same text:
- an indivisible sequence_reshape and a mismatched lod_reset, alone and
  together (two trips listed in one error, sorted as the JAX package
  lists them);
- an assertion inside an rnn_scan body records no flag (the JAX package's
  lax loop body cannot carry one out), and the layers warn at build time;
- Executor.run(steps=4) whose step 2 alone trips an assertion raises from
  the call (the flags are a sticky OR over the K steps), writes the state
  back first, and the next call starts from cleared flags;
- the host reads: one combined flag a run of an asserting program, none
  for a program without an asserting op (Executor.flag_reads).
No tolerance: texts, counts and flags are compared exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor

_PKG = {"jax": (jfluid, JLoDTensor), "port": (tfluid, TLoDTensor)}


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


def _seqs(seed, width, lens):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, width).astype("float32") for n in lens]


def _session(pkg, build):
    """(run(feed, steps=1), executor, scope) of `build` in package `pkg`,
    its startup program run."""
    fluid, _ = _PKG[pkg]
    main, startup, fetch = _build(fluid, build)
    if pkg == "jax":
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)

        def run(feed, steps=1):
            with fluid.scope_guard(scope):
                return exe.run(main, feed=feed, fetch_list=fetch,
                               steps=steps)
    else:
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)

        def run(feed, steps=1):
            return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                           steps=steps)
    return run, exe, scope


def _error_text(pkg, build, feed):
    run, _, _ = _session(pkg, build)
    lod_cls = _PKG[pkg][1]
    with pytest.raises(RuntimeError) as e:
        run({n: lod_cls.from_sequences(v) for n, v in feed.items()})
    return str(e.value)


def _reshape(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32", lod_level=1)
    return [fluid.layers.sequence_reshape(x, 8)]


def _lod_reset(fluid):
    x = fluid.layers.data(name="y", shape=[2], dtype="float32", lod_level=1)
    return [fluid.layers.lod_reset(x, target_lod=[0, 2, 5])]


def _both(fluid):
    return _reshape(fluid) + _lod_reset(fluid)


_FEEDS = {"x": _seqs(1, 4, [3, 2]), "y": _seqs(2, 2, [2, 4])}


@pytest.mark.parametrize("case", ["reshape", "lod_reset", "both"])
def test_the_same_error_text_in_both_packages(case):
    build = {"reshape": _reshape, "lod_reset": _lod_reset,
             "both": _both}[case]
    feed = {n: v for n, v in _FEEDS.items()
            if case == "both" or n == ("x" if case == "reshape" else "y")}
    text = _error_text("port", build, feed)
    assert text == _error_text("jax", build, feed)
    if case == "both":
        assert text.startswith("2 in-graph assertions tripped in this run")
        # sorted, as the JAX package's jitted step returns its flag dict
        assert text.index("lod_reset") < text.index("sequence_reshape")
    else:
        assert text.startswith({"reshape": "sequence_reshape:",
                                "lod_reset": "lod_reset:"}[case])


def test_a_clean_run_reads_one_flag_and_a_flag_free_one_none():
    run, exe, _ = _session("port", _reshape)
    ok = {"x": TLoDTensor.from_sequences(_seqs(3, 4, [2, 4]))}
    out, = run(ok)
    assert out.shape == (2, 4, 8) and exe.flag_reads == 1
    run(ok, steps=3)
    assert exe.flag_reads == 2

    def plain(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        return [fluid.layers.sequence_pool(x, "sum")]
    run, exe, _ = _session("port", plain)
    run(ok)
    run(ok, steps=3)
    assert exe.flag_reads == 0


def _rnn_with_assertions(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[3, 2], dtype="float32")
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        layers.lod_reset(xt, target_lod=[0, 1, 7])   # 2 rows, not 7
        rnn.output(layers.scale(xt, scale=2.0))
    return [rnn()]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_no_flag_inside_an_rnn_scan_body(pkg):
    with pytest.warns(UserWarning, match="not enforceable in-graph"):
        run, exe, _ = _session(pkg, _rnn_with_assertions)
    xv = np.random.RandomState(4).randn(2, 3, 2).astype("float32")
    out, = run({"x": xv})
    np.testing.assert_allclose(out, 2 * xv, rtol=1e-6)
    if pkg == "port":
        assert exe.flag_reads == 0


def test_add_error_records_nothing_in_a_loop_body():
    from paddle_tpu_torch.core.lowering import LowerCtx
    ctx = LowerCtx(None, torch.device("cpu"))
    ctx._loop_iters.append(0)
    ctx.add_error("m", torch.tensor(True))
    assert ctx.op_errors == {}
    ctx._loop_iters.pop()
    ctx.add_error("m", torch.tensor(False))
    ctx.add_error("m", torch.tensor(True))
    ctx.add_error("m", torch.tensor(False))
    assert list(ctx.op_errors) == ["m"] and bool(ctx.op_errors["m"])


def _tripped_at_step_2(fluid):
    """lod_reset onto offsets base + shift * (counter == 2), then
    sequence_reshape to width 4: at step 2 the lengths are odd (3, 1) and
    len * 2 is not a multiple of 4; every other step they are (2, 2)."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
    base = layers.data(name="base", shape=[3], dtype="int32",
                       append_batch_size=False)
    shift = layers.data(name="shift", shape=[3], dtype="int32",
                        append_batch_size=False)
    counter = layers.autoincreased_step_counter(begin=1)
    two = layers.fill_constant(shape=[1], dtype="int64", value=2)
    at_two = layers.cast(layers.equal(counter, two), "int32")
    offsets = layers.elementwise_add(base,
                                     layers.elementwise_mul(shift, at_two))
    r = layers.sequence_reshape(layers.lod_reset(x, y=offsets), 4)
    return [layers.reduce_sum(layers.sequence_pool(r, "sum")), counter]


def _step2_feed(lod_cls):
    return {"x": lod_cls.from_sequences(_seqs(5, 2, [2, 2])),
            "base": np.array([0, 2, 4], "int32"),
            "shift": np.array([0, 1, 0], "int32")}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_steps_4_tripped_at_step_2_raises(pkg):
    """steps=4 raises (step 2 tripped); the counter moved on to 4 all the
    same; the next steps=4 call (steps 5-8) is clean: its flags started
    cleared; a steps=1 call at step 2 raises the same text."""
    run, exe, scope = _session(pkg, _tripped_at_step_2)
    feed = _step2_feed(_PKG[pkg][1])
    with pytest.raises(RuntimeError) as e:
        run(feed, steps=4)
    text = str(e.value)
    assert text.startswith("sequence_reshape:")
    counter = [v.name for v in _build(_PKG[pkg][0], _tripped_at_step_2)[0]
               .list_vars() if v.persistable][0]
    assert int(np.asarray(scope.get(counter)).reshape(-1)[0]) == 4
    total, count = run(feed, steps=4)
    assert np.asarray(count).reshape(-1).tolist() == [5, 6, 7, 8]
    run2, _, _ = _session(pkg, _tripped_at_step_2)
    run2(feed)
    with pytest.raises(RuntimeError) as e1:
        run2(feed)
    assert str(e1.value) == text
    if pkg == "port":
        assert exe.flag_reads == 2


def test_steps_4_error_text_is_the_jax_packages():
    texts = []
    for pkg in ("jax", "port"):
        run, _, _ = _session(pkg, _tripped_at_step_2)
        with pytest.raises(RuntimeError) as e:
            run(_step2_feed(_PKG[pkg][1]), steps=4)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
