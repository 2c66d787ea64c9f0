"""The port's tensor-parallel InferenceEngine(tp=, mesh_devices=) against a
one-device engine and the JAX package's tp engine, on the CPU.

The model is tests/test_torch_replica_pool.py's: a small Transformer
scoring model (1+1 layers, d_model 16, 2 heads, T 8) saved by the JAX
package with weights drawn from a seed.

- `tp=2` over mesh_devices ["cpu"] * 2 (a mesh of two replicas that
  share the CPU, as ["cuda:0"] * 2 shares the card): the plan splits
  weights over tp with "gather" placement; answers, coalesced and
  run_direct, at every bucket, are bit-equal to the one-device engine's
  (the gathered weights are the weights; same shapes, same arithmetic),
  in fp32 and with weights_dtype="bf16", and within rtol = atol = 1e-6
  of the JAX tp=2 engine's over two of its virtual CPU devices (bf16:
  max |port - jax| / max |jax| <= 1e-2, the quantized-serving divergence
  measure: a bf16 logit near 3 rounds in steps of 1.6e-2, and another
  summation order may round it one step apart);
- the JAX package's refusals with its messages: tp=0, int8 with tp, a
  mesh_devices list of another length, more devices than are visible
  (the port sees CUDA devices only: none here), and a tp pool whose span
  needs more devices than are visible;
- a 2-replica tp pool built through engine_factory survives
  kill_replica under load with zero client errors, its replicas' spans
  in pool_state() and on /metrics' ptpu_serving_replica_device; under
  replica_poison the NaN reaches a tp replica's answers and the pool
  fails over.
"""
import re
import threading

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jfluid
from paddle_tpu import serving as jserving

from paddle_tpu_torch import serving
from paddle_tpu_torch.serving.metrics import render_prometheus_all

from test_torch_replica_pool import requests, save_model

BUCKETS = [1, 4]
TOL = dict(rtol=1e-6, atol=1e-6)
BF16_DIVERGENCE = 1e-2
TOO_FEW = r"tp=\d+ needs \d+ devices but only \d+ are visible"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_model")
    return str(d), save_model(d, 4)


def _engine(d, **kw):
    kw.setdefault("batch_buckets", BUCKETS)
    kw.setdefault("max_queue_delay_ms", 2)
    return serving.InferenceEngine(d, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tp_engine_bit_equal_to_one_device(model, dtype):
    d, fetch = model
    feeds = requests(21, 8)
    one = _engine(d, weights_dtype=dtype, pipeline_depth=0)
    tpe = _engine(d, weights_dtype=dtype, tp=2, mesh_devices=["cpu"] * 2)
    jtp = jserving.InferenceEngine(d, batch_buckets=BUCKETS, tp=2,
                                   weights_dtype=dtype)
    try:
        assert tpe.tp == 2 and tpe.describe()["tp"] == 2
        assert tpe.device_span() == ["cpu", "cpu"]
        assert dict(tpe.mesh.shape) == {"dp": 1, "tp": 2}
        assert any(e.sharded for e in tpe.plan if e.kind == "param")
        m = tpe.plan.memory_report()
        assert m["params"]["per_chip_bytes"] < \
            m["params"]["replicated_per_chip_bytes"]
        futures = [None] * len(feeds)

        def fire(i):
            futures[i] = tpe.submit(feeds[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for i, fut in enumerate(futures):
            got = fut.result(60).numpy()[fetch]
            want, _ = one.run_direct(feeds[i], batch_bucket=fut.bucket[0])
            np.testing.assert_array_equal(got, want[fetch], err_msg=str(i))
        for b in BUCKETS:
            for f in feeds[:2]:
                got = tpe.run_direct(f, batch_bucket=b)[0][fetch]
                np.testing.assert_array_equal(
                    got, one.run_direct(f, batch_bucket=b)[0][fetch])
                got = got.astype("float32")
                jgot = np.asarray(jtp.run_direct(f, batch_bucket=b)[0][fetch],
                                  "float32")
                if dtype == "fp32":
                    np.testing.assert_allclose(got, jgot, **TOL)
                else:
                    div = np.abs(got - jgot).max() / np.abs(jgot).max()
                    assert div <= BF16_DIVERGENCE, div
    finally:
        one.close()
        tpe.close()
        jtp.close()


def test_tp_refusals_carry_the_jax_messages(model):
    d, _ = model

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for kw in (dict(tp=0), dict(tp=1, weights_dtype="int8"),
               dict(tp=2, mesh_devices=["cpu"] * 3)):
        jkw = {k: (jax.devices()[:3] if k == "mesh_devices" else v)
               for k, v in kw.items()}
        assert message(lambda: _engine(d, warmup=False, **kw)) == \
            message(lambda: jserving.InferenceEngine(
                d, warmup=False, **jkw))
    port = message(lambda: _engine(d, tp=2, warmup=False))
    jmsg = message(lambda: jserving.InferenceEngine(
        d, tp=len(jax.devices()) + 1, warmup=False))
    assert re.fullmatch(TOO_FEW, port) and re.fullmatch(TOO_FEW, jmsg)
    assert port == "tp=2 needs 2 devices but only 0 are visible"
    assert message(lambda: serving.ReplicaPool(d, replicas=2, tp=0,
                                               place="cpu")) == \
        message(lambda: jserving.ReplicaPool(d, replicas=2, tp=0))
    pool_msg = message(lambda: serving.ReplicaPool(d, replicas=1, tp=2))
    jpool_msg = message(lambda: jserving.ReplicaPool(
        d, replicas=1, tp=len(jax.devices()) + 1))
    per_replica = r"tp=\d+ needs \d+ devices per replica but only \d+ " \
        r"are visible"
    assert re.fullmatch(per_replica, pool_msg)
    assert re.fullmatch(per_replica, jpool_msg)


def test_tp_pool_survives_kill_replica(model):
    d, fetch = model
    feeds = requests(23, 16)
    one = _engine(d, pipeline_depth=0)

    def factory(idx, place):
        return _engine(d, tp=2, mesh_devices=["cpu"] * 2,
                       name="tp@%d" % idx)

    pool = serving.ReplicaPool(engine_factory=factory, replicas=2,
                               name="tp", retries=3)
    try:
        state = pool.pool_state()
        assert [r["tp"] for r in state["replicas"]] == [2, 2]
        assert [r["devices"] for r in state["replicas"]] == \
            [["cpu", "cpu"]] * 2
        futures, errors = [None] * len(feeds), []

        def fire(i):
            futures[i] = pool.submit(feeds[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        pool.kill_replica(0)
        for i in range(8, len(feeds)):
            fire(i)
        for i, fut in enumerate(futures):
            try:
                got = fut.result(60).numpy()[fetch]
            except Exception as e:  # noqa: BLE001 — asserted empty below
                errors.append((i, repr(e)))
                continue
            want, _ = one.run_direct(feeds[i], batch_bucket=fut.bucket[0])
            np.testing.assert_array_equal(got, want[fetch])
        assert errors == []
        assert pool.pool_state()["replicas"][0]["dead"]
        text = render_prometheus_all({}, pools={"tp": pool})
        assert text.count("ptpu_serving_replica_device{") == 4
        assert 'ptpu_serving_replica_state{model="tp",replica="0"} 6' \
            in text
    finally:
        pool.close()
        one.close()


def test_tp_replica_poison_reaches_the_answers(model):
    """replica_poison NaNs a tp engine's weights through the scope (the
    split weights are assembled, poisoned and split again at the next
    dispatch): the pool's finite check catches it and fails over."""
    from paddle_tpu_torch.resilience.faults import FaultPlan
    d, fetch = model
    feeds = requests(25, 4)
    one = _engine(d, pipeline_depth=0)

    def factory(idx, place):
        return _engine(d, tp=2, mesh_devices=["cpu"] * 2,
                       name="tp-poison@%d" % idx)

    pool = serving.ReplicaPool(engine_factory=factory, replicas=2,
                               retries=3, eject_consecutive=2)
    try:
        with FaultPlan(["replica_poison@1"]):
            for f in feeds:
                fut = pool.submit(f)
                got = fut.result(60).numpy()[fetch]
                want, _ = one.run_direct(f, batch_bucket=fut.bucket[0])
                np.testing.assert_array_equal(got, want[fetch])
        snap = pool.metrics.snapshot()
        assert snap["poisoned_results_total"] >= 1
        assert snap["errors_total"] == 0
        assert [r["state"] for r in pool.pool_state()["replicas"]] == \
            ["ejected", "healthy"]
    finally:
        pool.close()
        one.close()
