"""The port's pipelined serving (continuous batching behind an in-flight
window) on the CPU, against run_direct and against the JAX package's
engine.

Ported from tests/unittests/test_pipelined_dispatch.py's serving cases to
the port's InferenceEngine(device="cpu"): concurrent mixed-row clients at
pipeline_depth 2 get answers bit-identical to run_direct at the bucket
each future records, with expired deadlines among them; a hard close
mid-window completes every future with a result or a typed error; drain
and close complete everything; serial mode (depth 0) still works. The
default depth is 2 and FLAGS_serving_pipeline_depth overrides it.

The model is an MLP (8 -> 16 relu -> 6 softmax) saved by the JAX
package. Both packages' engines answer the same requests from that one
directory within rtol = atol = 1e-6 (fp32, two layers, sums in another
order); the port's coalesced answers against its run_direct: bit for
bit (one device, one shape, the same arithmetic).
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving

from paddle_tpu_torch.serving import InferenceEngine
from paddle_tpu_torch.serving.batcher import (DeadlineExceededError,
                                              RequestFuture,
                                              ServingClosedError,
                                              ServingError)

FEAT, CLASSES = 8, 6
ENGINE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The MLP, initialized and saved by the JAX package."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 3
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[FEAT], dtype="float32")
        h = jfluid.layers.fc(input=x, size=16, act="relu")
        pred = jfluid.layers.fc(input=h, size=CLASSES, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    path = os.path.join(str(tmp_path_factory.mktemp("pipelined")), "mlp")
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(path, ["x"], [pred], exe,
                                       main_program=main)
    return path


def _engine(model_dir, **kw):
    return InferenceEngine(model_dir, device="cpu", **kw)


def test_pipelined_serving_bit_exact_concurrent_mixed_rows(model_dir):
    """24 concurrent mixed-row requests through the depth-2 pipeline,
    each bit-identical to run_direct at the bucket its future records;
    every 6th carries an absurd deadline and fails with
    DeadlineExceededError without disturbing its neighbours."""
    engine = _engine(model_dir, name="pipe", max_batch_size=8,
                     batch_buckets=[1, 2, 4, 8], max_queue_delay_ms=4,
                     pipeline_depth=2)
    try:
        assert engine.pipeline_depth == 2
        assert engine._batcher._window is not None
        rng = np.random.RandomState(0)
        feeds = [rng.rand(1 + (i % 4), FEAT).astype("float32")
                 for i in range(24)]
        results, errors = {}, {}
        lock = threading.Lock()

        def client(i):
            try:
                dl = 0.01 if i % 6 == 5 else None
                fut = engine.submit({"x": feeds[i]}, deadline_ms=dl)
                out = fut.result(60).numpy()
                with lock:
                    results[i] = (out, fut.bucket)
            except Exception as e:  # noqa: BLE001 — judged below
                with lock:
                    errors[i] = e

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, e in errors.items():
            assert isinstance(e, DeadlineExceededError), (i, e)
        assert len(results) >= 16
        for i, (out, bucket) in results.items():
            ref, _ = engine.run_direct({"x": feeds[i]},
                                       batch_bucket=bucket[0],
                                       seq_bucket=bucket[1])
            for name in ref:
                np.testing.assert_array_equal(out[name], ref[name],
                                              err_msg="req %d" % i)
        assert engine.drain(timeout=60)
        stats = engine.pipeline_stats()
        # every dispatch went through the window and completed there
        assert _wait(lambda: engine.pipeline_stats()["completed"] ==
                     engine.metrics.snapshot()["batches_total"])
        assert stats["depth"] == 2 and stats["completed"] >= 1
    finally:
        engine.close()


def _wait(pred, timeout=10.0):
    import time
    limit = time.monotonic() + timeout
    while not pred() and time.monotonic() < limit:
        time.sleep(0.005)
    return pred()


def test_pipelined_serving_kill_mid_window(model_dir):
    """close(drain=False) while a burst is in flight: every future
    completes (a result or a typed error), nothing hangs, and requests
    caught in the formed queue fail with ServingClosedError too."""
    engine = _engine(model_dir, name="kill", max_batch_size=4,
                     batch_buckets=[1, 2, 4], max_queue_delay_ms=50,
                     pipeline_depth=2, queue_capacity=512)
    rng = np.random.RandomState(1)
    futures = [engine.submit({"x": rng.rand(1, FEAT).astype("float32")})
               for _ in range(64)]
    engine.close(drain=False)
    done = ok = closed = 0
    for f in futures:
        try:
            f.result(30).numpy()
            ok += 1
        except ServingClosedError:
            closed += 1
        except ServingError:
            pass
        except TimeoutError:
            raise AssertionError("future hung across a hard close")
        done += 1
    assert done == len(futures)
    # a 50 ms coalescing window and an immediate kill: most of the burst
    # failed fast instead of being served
    assert ok < len(futures) and closed > 0
    assert not any(w.is_alive() for w in engine._batcher._workers)


def test_pipelined_drain_and_close_complete_everything(model_dir):
    """drain() after a burst resolves every future with a result (both
    queues and the in-flight window drained); close() after it is a
    no-op, and a closed engine refuses new work."""
    engine = _engine(model_dir, name="drain", max_batch_size=4,
                     batch_buckets=[1, 2, 4], max_queue_delay_ms=20,
                     pipeline_depth=3, queue_capacity=512)
    rng = np.random.RandomState(2)
    futures = [engine.submit({"x": rng.rand(1, FEAT).astype("float32")})
               for _ in range(40)]
    assert engine.drain(timeout=60)
    assert all(f.done() for f in futures)
    engine.close()
    for f in futures:
        f.result(1).numpy()
    with pytest.raises(ServingClosedError):
        engine.submit({"x": rng.rand(1, FEAT).astype("float32")})


def test_close_with_drain_serves_every_queued_request(model_dir):
    engine = _engine(model_dir, name="closedrain", max_batch_size=4,
                     batch_buckets=[1, 2, 4], max_queue_delay_ms=50,
                     pipeline_depth=2, queue_capacity=512)
    rng = np.random.RandomState(5)
    feeds = [rng.rand(1, FEAT).astype("float32") for _ in range(30)]
    futures = [engine.submit({"x": x}) for x in feeds]
    engine.close(drain=True)
    for x, f in zip(feeds, futures):
        got = f.result(1).numpy()
        ref, _ = engine.run_direct({"x": x}, batch_bucket=f.bucket[0])
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name])


def test_serial_mode_still_available(model_dir):
    """pipeline_depth=0 keeps the serial loop: the same results, no
    window."""
    engine = _engine(model_dir, name="serial", max_batch_size=4,
                     pipeline_depth=0)
    try:
        assert engine._batcher._window is None
        assert engine.pipeline_stats() is None
        x = np.random.RandomState(3).rand(2, FEAT).astype("float32")
        out = engine.infer({"x": x})
        ref, _ = engine.run_direct({"x": x}, batch_bucket=2)
        for name in ref:
            np.testing.assert_array_equal(out[name], ref[name])
    finally:
        engine.close()


@pytest.mark.parametrize("flag, want", [(None, 2), ("0", 0), ("3", 3),
                                        ("junk", 2)])
def test_default_depth_and_the_flag(model_dir, monkeypatch, flag, want):
    if flag is None:
        monkeypatch.delenv("FLAGS_serving_pipeline_depth", raising=False)
    else:
        monkeypatch.setenv("FLAGS_serving_pipeline_depth", flag)
    engine = _engine(model_dir, warmup=False)
    try:
        assert engine.pipeline_depth == want
        assert (engine.pipeline_stats() is None) == (want == 0)
    finally:
        engine.close()
    # an explicit argument wins over the flag
    monkeypatch.setenv("FLAGS_serving_pipeline_depth", "3")
    engine = _engine(model_dir, warmup=False, pipeline_depth=1)
    try:
        assert engine.pipeline_depth == 1
    finally:
        engine.close()


def test_done_callbacks_fire_once_on_any_thread():
    fut = RequestFuture()
    seen = []
    fut.add_done_callback(lambda f: seen.append(("early", f.result(0))))
    fut.add_done_callback(lambda f: 1 / 0)    # an observer that raises
    fut.set_result(5)
    fut.add_done_callback(lambda f: seen.append(("late", f.result(0))))
    assert seen == [("early", 5), ("late", 5)]
    err = RequestFuture()
    err.add_done_callback(lambda f: seen.append(f.done()))
    err.set_exception(ServingError("x"))
    assert seen[-1] is True


def test_jax_saved_model_same_answers_from_both_engines(model_dir):
    rng = np.random.RandomState(7)
    feeds = [rng.rand(n, FEAT).astype("float32") for n in (1, 3, 4, 2)]
    port = _engine(model_dir, batch_buckets=[1, 2, 4], pipeline_depth=2)
    jax_engine = jserving.InferenceEngine(model_dir, batch_buckets=[1, 2, 4],
                                          pipeline_depth=2)
    try:
        futures = [port.submit({"x": x}) for x in feeds]
        for x, f in zip(feeds, futures):
            got = f.result(60).numpy()
            want = jax_engine.infer({"x": x})
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                           **ENGINE_TOL)
                assert np.allclose(got[name].sum(-1), 1.0, atol=1e-5)
    finally:
        port.close()
        jax_engine.close()
