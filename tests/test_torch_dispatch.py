"""The port's core/dispatch.py on the CPU: the in-flight window and the
Executor.run(timeout=) watchdog.

InflightWindow: its bound, its release and track paths and its stats, as
the JAX package's test_inflight_window_bounds_and_accounts holds them; on
the CPU a tracked dispatch has completed by the time it is tracked.

The watchdog: a test-only op rule that sleeps makes a run miss its
deadline. Executor.run(timeout=) then raises DispatchTimeoutError with
the run's cache key, and the abandoned worker, when it wakes, writes
nothing into the scope. A run that meets its deadline returns what a run
without one returns. The rule is removed from the registry afterwards.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.dispatch import (InflightWindow,
                                            dispatch_with_deadline,
                                            run_with_deadline)
from paddle_tpu_torch.core.executor import DispatchTimeoutError

SLEEP_OP = "test_sleep_then_copy"


def _wait_for(pred, timeout=5.0):
    limit = time.monotonic() + timeout
    while not pred() and time.monotonic() < limit:
        time.sleep(0.005)
    return pred()


def test_inflight_window_bounds_and_accounts():
    w = InflightWindow(2, tag="unit")
    try:
        assert w.acquire(timeout=1) and w.acquire(timeout=1)
        assert not w.acquire(timeout=0.05)   # window full
        w.track([torch.ones(4)])             # completion frees a slot
        assert w.acquire(timeout=5)
        w.release()                          # failed-dispatch path
        w.track([])                          # empty dispatch completes
        assert _wait_for(lambda: w.stats()["completed"] == 2)
        assert w.acquire(timeout=5) and w.acquire(timeout=5)
        assert not w.acquire(timeout=0.05)   # all slots taken again
    finally:
        w.close(timeout=5)
    with pytest.raises(ValueError):
        InflightWindow(0)


def test_window_idle_gaps_and_completion_callbacks():
    """A dispatch enqueued after the previous one completed counts its
    gap as idle; one enqueued before counts nothing. on_complete runs on
    the completion thread after each."""
    w = InflightWindow(3)
    seen = []
    try:
        assert w.acquire(timeout=1)
        w.track([torch.zeros(2)], on_complete=lambda **kw: seen.append(kw))
        assert _wait_for(lambda: w.stats()["completed"] == 1)
        time.sleep(0.05)
        assert w.acquire(timeout=1)
        w.track([torch.zeros(2)], enqueued_at=time.monotonic(),
                on_complete=lambda **kw: seen.append(kw))
        assert _wait_for(lambda: w.stats()["completed"] == 2)
        stats = w.stats()
        assert stats["gaps"] == 1 and stats["idle_s"] >= 0.04
        # enqueued before the last completion: no idle time
        assert w.acquire(timeout=1)
        w.track([], enqueued_at=time.monotonic() - 10)
        assert _wait_for(lambda: w.stats()["completed"] == 3)
        assert w.stats()["gaps"] == 1
        assert seen == [{}, {}]
    finally:
        w.close(timeout=5)


def test_run_with_deadline_returns_raises_and_times_out():
    assert run_with_deadline(lambda cancelled: 7, 5) == 7
    with pytest.raises(KeyError, match="boom"):
        run_with_deadline(lambda cancelled: {}["boom"], 5)
    flags = []

    def slow(cancelled):
        time.sleep(0.3)
        flags.append(cancelled.is_set())

    with pytest.raises(DispatchTimeoutError, match="hang watchdog"):
        run_with_deadline(slow, 0.05, what="unit")
    assert _wait_for(lambda: flags == [True])

    def recording(cancelled, info):
        info["cache_key"] = ("k", 1)
        time.sleep(0.3)

    with pytest.raises(DispatchTimeoutError) as e:
        dispatch_with_deadline(recording, 0.05, "unit")
    assert e.value.cache_key == ("k", 1)


@pytest.fixture
def sleeping_op():
    """Register the test-only op: Out = X after sleeping attr `seconds`
    (set per test through `delay`); removed again afterwards."""
    delay = {"s": 0.0}
    woke = threading.Event()

    def rule(ctx, ins, attrs):
        time.sleep(delay["s"])
        woke.set()
        return {"Out": [ins["X"][0].clone()]}

    assert not registry.is_registered(SLEEP_OP)
    registry.register(SLEEP_OP, rule)
    try:
        yield delay, woke
    finally:
        del registry._OPS[SLEEP_OP]


def _counter_program():
    """x -> sleep op -> fc -> mean, SGD: a run writes the fc weight and
    bias into the scope."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        block = main.global_block()
        slept = block.create_var(name="slept", shape=[-1, 4],
                                 dtype="float32")
        block.append_op(type=SLEEP_OP, inputs={"X": [x]},
                        outputs={"Out": [slept]})
        loss = tfluid.layers.mean(tfluid.layers.fc(input=slept, size=2))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("steps", [1, 2])
def test_timeout_raises_with_the_cache_key_and_writes_nothing(sleeping_op,
                                                              steps):
    delay, woke = sleeping_op
    main, startup, loss = _counter_program()
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.get(n).clone() for n in scope.names()}
    feed = {"x": np.ones((3, 4), "float32")}
    delay["s"] = 0.5
    with pytest.raises(DispatchTimeoutError) as e:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                timeout=0.05, steps=steps)
    key = e.value.cache_key
    assert key[0] == main._uid and key[1] == main._version
    assert key[3] == (loss.name,) and key[4] == steps
    # the abandoned worker wakes, finishes its run and writes nothing
    assert woke.wait(5)
    time.sleep(0.5 * steps + 0.2)
    for n, v in before.items():
        assert torch.equal(scope.get(n), v), n


@pytest.mark.parametrize("steps", [1, 3])
def test_a_run_within_its_deadline_is_a_plain_run(sleeping_op, steps):
    main, startup, loss = _counter_program()
    exe = tfluid.Executor("cpu")
    a, b = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=a)
    for n in a.names():
        b.set(n, a.get(n).clone())
    feed = {"x": np.random.RandomState(0).rand(3, 4).astype("float32")}
    got, = exe.run(main, feed=feed, fetch_list=[loss], scope=a, timeout=30,
                   steps=steps)
    want, = exe.run(main, feed=feed, fetch_list=[loss], scope=b,
                    steps=steps)
    np.testing.assert_array_equal(got, want)
    for n in a.names():
        assert torch.equal(a.get(n), b.get(n)), n
    # argument errors raise through the watchdog on the caller's thread
    with pytest.raises(ValueError, match="steps"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=a, timeout=30,
                steps=0)
