"""The port's HTTP front (serving/server.ModelServer) on the CPU at port 0,
mirroring the ModelServer tests of tests/unittests/test_serving.py that
need neither the era-wire model format (ROADMAP A8) nor the verifier
(A11), plus a streamed :decode.

- a model saved by the JAX package served over HTTP: :predict answers
  equal the JAX engine's within rtol 1e-5 / atol 1e-6 (fp32, two layers,
  sums in another order) and the port's run_direct exactly; /healthz,
  /v1/models, /metrics; 404 for an unknown model and 400 for a malformed
  request; after shutdown the engine refuses work;
- a request that expires in the queue comes back as 504;
- a chunked POST is refused with 411;
- two models: each family's HELP/TYPE once, one sample per model;
- a DecodeEngine: :decode streams one NDJSON line per token, the tokens
  equal the solo decode's exactly, :predict on it is a 400, and /metrics
  carries ptpu_decode_slots and ptpu_decode_tokens_total;
- a ModelFleet of two ReplicaPools (priorities 0 and 1, brownout forced
  by a pressure threshold of 0) with a watched cluster directory:
  /healthz carries `pools` and `fleet` (the JAX server's keys), the
  browned-out model answers 429 with a Retry-After header while the top
  tier answers like the lone engine, and /metrics is one exposition
  (HELP and TYPE once per family) with the pools' {model, replica}
  families and ptpu_cluster_worker_steps_behind at the writers' lag; a
  pool whose every replica is dead reads unavailable (503).
"""
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability import registry as obsreg
from paddle_tpu_torch.resilience.heartbeat import HeartbeatWriter

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forget(engine):
    b = engine._batcher
    objs = {id(b), id(b._window)}
    with obsreg._note_lock:
        for table in (obsreg._live_windows, obsreg._live_batchers,
                      obsreg._live_decoders):
            for label in [k for k, v in table.items() if id(v) in objs]:
                del table[label]


def _save_dense_model(tmp_path, seed=0, feat=6, classes=3):
    """fc -> relu -> fc -> softmax, initialized and saved by the JAX
    package."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = seed
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[feat], dtype="float32")
        h = jfluid.layers.fc(input=x, size=16, act="relu")
        pred = jfluid.layers.fc(input=h, size=classes, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    d = str(tmp_path / "dense_model")
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe, main)
    return d


def _post(url, payload):
    body = json.dumps(payload).encode()
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}),
        timeout=30)


def test_model_served_over_http(tmp_path):
    d = _save_dense_model(tmp_path)
    xs = np.random.RandomState(9).rand(2, 6).astype("f")
    jeng = jserving.InferenceEngine(d, batch_buckets=[2, 4])
    want, _ = jeng.run_direct({"x": xs})
    jeng.close(drain=False)
    engine = serving.InferenceEngine(d, name="mlp", batch_buckets=[2, 4],
                                     max_queue_delay_ms=1, device="cpu")
    direct, _ = engine.run_direct({"x": xs})
    server = serving.ModelServer(engine, port=0).start()
    base = "http://%s" % server.address
    try:
        resp = json.loads(_post(base + "/v1/models/mlp:predict",
                                {"inputs": {"x": xs.tolist()}}).read())
        name = engine.fetch_names[0]
        got = np.asarray(resp["outputs"][name], dtype="f")
        np.testing.assert_allclose(got, want[name], **TOL)
        np.testing.assert_array_equal(got, direct[name])
        assert resp["bucket"][0] == 2

        health = json.loads(urllib.request.urlopen(
            base + "/healthz").read())
        assert health["status"] == "ok"
        models = json.loads(urllib.request.urlopen(
            base + "/v1/models").read())
        assert [m["name"] for m in models["models"]] == ["mlp"]
        assert models["models"][0]["metrics"]["responses_total"] == 1
        assert models["models"][0]["devices"] == ["cpu"]
        metrics_text = urllib.request.urlopen(
            base + "/metrics").read().decode()
        assert 'ptpu_serving_qps{model="mlp"}' in metrics_text

        body = {"inputs": {"x": xs.tolist()}}
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(base + "/v1/models/nope:predict", body)
        assert he.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(base + "/v1/models/mlp:predict",
                  {"inputs": {"x": [[1.0, 2.0]]}})
        assert he.value.code == 400
    finally:
        server.shutdown()
        _forget(engine)
    with pytest.raises(serving.ServingClosedError):
        engine.submit({"x": xs})


def test_http_deadline_maps_to_504(tmp_path):
    d = _save_dense_model(tmp_path)
    engine = serving.InferenceEngine(d, name="m", batch_buckets=[1],
                                     max_queue_delay_ms=0,
                                     queue_capacity=64, device="cpu")
    server = serving.ModelServer(engine, port=0).start()
    base = "http://%s" % server.address
    rng = np.random.RandomState(0)
    try:
        # hold the run lock so the 1 ms deadline expires while queued
        # behind a dispatch in progress; release it shortly after
        engine._run_lock.acquire()
        engine.submit({"x": rng.rand(1, 6).astype("f")})
        threading.Timer(0.1, engine._run_lock.release).start()
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(base + "/v1/models/m:predict",
                  {"inputs": {"x": rng.rand(1, 6).tolist()},
                   "deadline_ms": 1})
        assert he.value.code == 504
    finally:
        server.shutdown()
        _forget(engine)


def test_chunked_post_rejected_411(tmp_path):
    d = _save_dense_model(tmp_path)
    engine = serving.InferenceEngine(d, name="m", batch_buckets=[1],
                                     max_queue_delay_ms=1, device="cpu")
    server = serving.ModelServer(engine, port=0).start()
    host, port = server.httpd.server_address[:2]
    try:
        s = socket.create_connection((host, port), timeout=10)
        s.sendall(b"POST /v1/models/m:predict HTTP/1.1\r\n"
                  b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                  b"5\r\nhello\r\n0\r\n\r\n")
        resp = s.recv(65536).decode()
        assert resp.startswith("HTTP/1.1 411"), resp[:80]
        s.close()
    finally:
        server.shutdown()
        _forget(engine)


def test_multi_model_metrics_single_exposition(tmp_path):
    d = _save_dense_model(tmp_path)
    a = serving.InferenceEngine(d, name="a", batch_buckets=[1],
                                max_queue_delay_ms=1, warmup=False,
                                device="cpu")
    b = serving.InferenceEngine(d, name="b", batch_buckets=[1],
                                max_queue_delay_ms=1, warmup=False,
                                device="cpu")
    server = serving.ModelServer({"a": a, "b": b}, port=0).start()
    try:
        text = urllib.request.urlopen(
            "http://%s/metrics" % server.address).read().decode()
        assert text.count("# TYPE ptpu_serving_requests_total counter") \
            == 1
        assert text.count("# TYPE ptpu_serving_qps gauge") == 1
        assert 'ptpu_serving_qps{model="a"}' in text
        assert 'ptpu_serving_qps{model="b"}' in text
    finally:
        server.shutdown()
        _forget(a)
        _forget(b)


def _decoder(slots=4, d=8, v=16, seed=7):
    """tests/test_torch_decode_serving.py's build_decoder."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.create_global_var([slots, 1], 0, "int64",
                                             persistable=True, name="tok")
        h = fluid.layers.create_global_var([slots, d], 0.0, "float32",
                                           persistable=True, name="h")
        ctx = fluid.layers.create_global_var([slots, d], 0.0, "float32",
                                             persistable=True, name="ctx")
        z = fluid.layers.fc(input=fluid.layers.concat(
            [fluid.layers.cast(tok, "float32"), h, ctx], axis=1),
            size=d, act="tanh")
        logits = fluid.layers.fc(input=z, size=v)
        nxt = fluid.layers.reshape(fluid.layers.argmax(logits, axis=1),
                                   shape=[slots, 1])
        fin = fluid.layers.equal(
            nxt, fluid.layers.fill_constant([slots, 1], "int64", 0))
        fluid.layers.assign(nxt, output=tok)
        fluid.layers.assign(z, output=h)
    return serving.DecodeEngine(program=main, startup_program=startup,
                                token_var=nxt, finished_var=fin,
                                max_slots=slots, name="dec", place="cpu")


def test_streamed_decode_and_decode_metrics():
    engine = _decoder()
    solo = engine.solo_clone()
    server = serving.ModelServer(engine, port=0).start()
    base = "http://%s" % server.address
    feed = {"tok": [3], "ctx": np.random.RandomState(1).randn(8).tolist()}
    try:
        want = np.asarray(solo.decode(
            {"tok": np.array([3]), "ctx": np.asarray(feed["ctx"], "f")},
            max_new_tokens=6)).reshape(-1)
        resp = _post(base + "/v1/models/dec:decode",
                     {"inputs": feed, "max_new_tokens": 6})
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(x) for x in resp.read().decode().splitlines()
                 if x.strip()]
        assert lines[-1]["done"] is True
        got = [line["token"][0] for line in lines[:-1]]
        assert [line["index"] for line in lines[:-1]] == \
            list(range(len(got)))
        np.testing.assert_array_equal(got, want)
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(base + "/v1/models/dec:predict", {"inputs": feed})
        assert he.value.code == 400
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "ptpu_decode_slots" in text
        assert "ptpu_decode_tokens_total" in text
        models = json.loads(urllib.request.urlopen(
            base + "/v1/models").read())
        assert models["models"][0]["mode"] == "decode"
    finally:
        server.shutdown()
        solo.close(drain=False)
        _forget(engine)
        _forget(solo)


def _forget_pool(pool):
    for rep in pool._replicas:
        _forget(rep.engine)


def _exposition_families(text):
    """Each family's TYPE line count; raises on a sample whose family has
    no TYPE line before it."""
    typed = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name = line.split()[2]
            typed[name] = typed.get(name, 0) + 1
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            base = name[:-len("_bucket")] if name.endswith("_bucket") \
                else name
            for suffix in ("_sum", "_count"):
                if base.endswith(suffix) and base[:-len(suffix)] in typed:
                    base = base[:-len(suffix)]
            assert base in typed, "sample before its TYPE: " + line
    return typed


def test_fleet_pools_and_cluster_over_http(tmp_path):
    d = _save_dense_model(tmp_path)
    xs = np.random.RandomState(5).rand(1, 6).astype("f")
    kw = dict(replicas=2, place="cpu", batch_buckets=[1, 4],
              max_queue_delay_ms=1)
    fleet = serving.ModelFleet(shed_dwell_s=0.0, pressure_high=0.0,
                               pressure_low=-1.0)
    bulk = fleet.add_model("bulk", priority=0, model_dir=d, **kw)
    live = fleet.add_model("live", priority=1, model_dir=d, **kw)
    lone = serving.InferenceEngine(d, name="lone", batch_buckets=[1],
                                   device="cpu", pipeline_depth=0)
    cdir = str(tmp_path / "cluster")
    writers = [HeartbeatWriter(cdir, "w%d" % i, interval=60.0)
               for i in range(2)]
    for w, step in zip(writers, (20, 14)):
        w.update(status="running", step=step)
    obsreg.watch_cluster(cdir, heartbeat_timeout=600.0)
    server = serving.ModelServer(fleet, port=0).start()
    base = "http://%s" % server.address
    body = {"inputs": {"x": xs.tolist()}}
    try:
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(base + "/v1/models/bulk:predict", body)
        assert he.value.code == 429
        assert int(he.value.headers["Retry-After"]) >= 1
        err = json.loads(he.value.read())
        assert err["code"] == "BrownoutError" and err["retry_after_s"] > 0
        resp = json.loads(_post(base + "/v1/models/live:predict",
                                body).read())
        name = lone.fetch_names[0]
        want, _ = lone.run_direct({"x": xs}, batch_bucket=1)
        np.testing.assert_array_equal(
            np.asarray(resp["outputs"][name], dtype="f"), want[name])

        health = json.loads(urllib.request.urlopen(
            base + "/healthz").read())
        assert health["status"] == "ok"
        assert sorted(health["pools"]) == ["bulk", "live"]
        assert health["pools"]["live"]["healthy"] == 2
        assert health["fleet"]["brownout_level"] == 1

        text = urllib.request.urlopen(base + "/metrics").read().decode()
        typed = _exposition_families(text)
        assert all(n == 1 for n in typed.values()), \
            [k for k, n in typed.items() if n != 1]
        assert 'ptpu_serving_requests_total{model="live",replica="0"}' \
            in text
        assert 'ptpu_serving_pool_requests_total{model="live"} 1' in text
        assert 'ptpu_serving_replica_state{model="bulk",replica="1"} 0' \
            in text
        assert 'ptpu_serving_replica_device{model="live",replica="0",' \
            'device="cpu"} 1' in text
        cl = os.path.basename(cdir)
        assert 'ptpu_cluster_worker_steps_behind{cluster="%s",' \
            'worker="w1"} 6' % cl in text
        assert "ptpu_cluster_worker_alive" in typed

        # every replica of one pool dead: that entry cannot serve; the
        # other keeps the process healthy, then none: 503
        for idx in (0, 1):
            bulk.kill_replica(idx)
        health = json.loads(urllib.request.urlopen(
            base + "/healthz").read())
        assert health["status"] == "ok"
        assert health["pools"]["bulk"]["healthy"] == 0
        for idx in (0, 1):
            live.kill_replica(idx)
        with pytest.raises(urllib.error.HTTPError) as he:
            urllib.request.urlopen(base + "/healthz")
        assert he.value.code == 503
    finally:
        obsreg.unwatch_cluster(cdir)
        server.shutdown()
        for w in writers:
            w.close()
        for pool in (bulk, live):
            _forget_pool(pool)
        lone.close()
        _forget(lone)
    assert fleet.closed
    with pytest.raises(serving.ServingClosedError):
        fleet.submit("live", {"x": xs})
