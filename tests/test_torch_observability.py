"""The port's observability layer (paddle_tpu_torch/observability): the
flight recorder and its spans, the metrics registry, and the serving
traces, on the CPU. Mirrors the trace and registry tests of
tests/unittests/test_observability.py that need neither the profiler
(ROADMAP A11) nor the cluster watch (A10).

- trace: nesting, dump, Chrome export, the bounded ring, the disabled
  recorder, end_open, a window completion error reaching on_complete,
  the text timeline with open spans;
- registry: counter / gauge / histogram rendering and escaping, a broken
  collector isolated, the default registry fronting live windows and the
  trace ring, the standalone /metrics endpoint and the textfile;
- serving: 24 concurrent requests through the depth-2 pipeline with the
  recorder on reconstruct every request's queue -> formation -> dispatch
  -> pad/enqueue -> execute -> materialize timeline, execute spans never
  overlap more than the depth, each batch's trace reaches the
  Executor's exec/step span, and the answers equal run_direct's at the
  recorded bucket bit for bit (one device, one shape, the same
  arithmetic); the ModelServer's /metrics is one exposition of the
  serving families and the registry.

Every test runs on a fresh ring and restores the always-on recorder;
engines it makes are closed and their registry entries dropped.
"""
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.core.dispatch import InflightWindow
from paddle_tpu_torch.observability import registry as obsreg
from paddle_tpu_torch.observability import trace


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.configure(capacity=4096, enabled=True)
    yield
    trace.configure(capacity=4096, enabled=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forget(*objs):
    """Drop objects from the registry's live tables (weak references a
    test could otherwise leave on /metrics)."""
    ids = {id(o) for o in objs}
    with obsreg._note_lock:
        for table in (obsreg._live_windows, obsreg._live_batchers,
                      obsreg._live_decoders):
            for label in [k for k, v in table.items() if id(v) in ids]:
                del table[label]


def _forget_engine(engine):
    b = engine._batcher
    _forget(b, *([b._window] if b._window is not None else []))


# ------------------------------------------------------------ trace core --

def test_span_nesting_dump_and_chrome_export():
    tr = trace.new_trace()
    with trace.span("outer", cat="t", trace=tr, k=1) as sp:
        with sp.child("inner"):
            pass
        sp.event("mark", why="x")
    leak = trace.span("leaky", cat="t", trace=trace.new_trace())
    d = trace.dump()
    names = [e["name"] for e in d["events"]]
    assert names == ["inner", "mark", "outer"]  # children end first
    inner, outer = d["events"][0], d["events"][2]
    assert inner["trace"] == outer["trace"] == tr
    assert inner["parent"] == outer["span"]
    assert outer["args"]["k"] == 1
    assert [o["name"] for o in d["open"]] == ["leaky"]
    assert d["open"][0]["age_s"] >= 0
    ct = trace.export_chrome_trace(data=d)
    evs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in evs} == {"inner", "outer", "leaky"}
    leaky = [e for e in evs if e["name"] == "leaky"][0]
    assert leaky["args"]["open"] is True
    insts = [e for e in ct["traceEvents"] if e["ph"] == "i"]
    assert insts and insts[0]["name"] == "mark"
    assert any(e["ph"] == "M" for e in ct["traceEvents"])
    leak.end()


def test_ring_bounded_under_sustained_load():
    trace.configure(capacity=256)
    for i in range(5000):
        trace.instant("tick", i=i)
    d = trace.dump()
    assert len(d["events"]) <= 256
    assert d["dropped"] >= 5000 - 256
    assert d["events"][-1]["args"]["i"] == 4999


def test_disabled_recorder_is_noop():
    trace.set_enabled(False)
    sp = trace.span("x", trace=trace.new_trace())
    assert sp.child("y") is sp
    sp.end()
    trace.instant("z")
    trace.set_enabled(True)
    assert trace.dump()["events"] == []


def test_end_open_closes_a_trace_not_others():
    t1, t2 = trace.new_trace(), trace.new_trace()
    a = trace.span("a", trace=t1)
    b = trace.span("b", trace=t2)
    trace.end_open(t1, error="Boom")
    d = trace.dump()
    assert [e["name"] for e in d["events"]] == ["a"]
    assert d["events"][0]["args"]["error"] == "Boom"
    assert [o["name"] for o in d["open"]] == ["b"]
    b.end()
    assert a._ended


def test_window_completion_error_reaches_on_complete(monkeypatch):
    """A failure at the window's completion wait reaches on_complete as
    error=, and the slot comes back regardless."""
    class _Poisoned(object):
        def synchronize(self):
            raise RuntimeError("device exploded")

    monkeypatch.setattr(dispatch, "_completion_event",
                        lambda handles: _Poisoned())
    got, done = {}, threading.Event()

    def on_complete(**kw):
        got.update(kw)
        done.set()

    w = InflightWindow(1, tag="err-test")
    try:
        assert w.acquire(timeout=5)
        w.track([torch.zeros(1)], on_complete=on_complete)
        assert done.wait(5)
        assert got == {"error": "RuntimeError"}
        assert w.acquire(timeout=5)
        w.release()
    finally:
        w.close(5)
        _forget(w)


def test_render_timeline_lists_open_spans():
    with trace.span("done", trace=trace.new_trace()):
        pass
    sp = trace.span("wedged/here", trace=trace.new_trace())
    text = trace.render_timeline(trace.dump())
    assert "done" in text
    assert "OPEN" in text and "wedged/here" in text
    sp.end()


# --------------------------------------------------------- registry core --

def test_registry_counter_gauge_histogram_render():
    reg = obsreg.MetricsRegistry()
    c = reg.counter("ptpu_test_events_total", "events")
    c.inc(**{"class": "numeric", "action": "skip"})
    c.inc(2, **{"class": "numeric", "action": "skip"})
    g = reg.gauge("ptpu_test_depth", "depth")
    g.set(3, window='we"ird\n')
    h = reg.histogram("ptpu_test_latency_seconds", "lat",
                      buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = reg.render_prometheus()
    assert '# TYPE ptpu_test_events_total counter' in text
    assert 'ptpu_test_events_total{action="skip",class="numeric"} 3' \
        in text
    assert 'window="we\\"ird\\n"' in text
    assert 'ptpu_test_latency_seconds_bucket{le="0.1"} 1' in text
    assert 'ptpu_test_latency_seconds_bucket{le="1.0"} 2' in text
    assert 'ptpu_test_latency_seconds_bucket{le="+Inf"} 3' in text
    assert 'ptpu_test_latency_seconds_count 3' in text
    assert text.count("# TYPE ptpu_test_events_total") == 1
    with pytest.raises(ValueError):
        reg.gauge("ptpu_test_events_total")
    snap = reg.snapshot()
    assert snap["ptpu_test_events_total"]["samples"] == [
        [{"action": "skip", "class": "numeric"}, 3.0]]


def test_registry_collector_and_broken_collector_isolated():
    reg = obsreg.MetricsRegistry()

    @reg.register_collector
    def _ok():
        return [("ptpu_test_coll", "gauge", "x", [({"a": "b"}, 7)])]

    @reg.register_collector
    def _broken():
        raise RuntimeError("unreadable surface")

    assert 'ptpu_test_coll{a="b"} 7' in reg.render_prometheus()
    reg.unregister_collector(_ok)
    assert "ptpu_test_coll" not in reg.render_prometheus()


def test_default_registry_fronts_windows_and_the_ring():
    w = InflightWindow(2, tag="obs-test")
    try:
        text = obsreg.REGISTRY.render_prometheus()
        assert "ptpu_window_depth" in text and "obs-test" in text
        assert "ptpu_trace_ring_events" in text
        assert "ptpu_batcher_queue_depth" in text
        assert "ptpu_decode_slots" in text
    finally:
        w.close(1.0)
        _forget(w)


def test_metrics_http_endpoint_and_textfile(tmp_path):
    reg = obsreg.MetricsRegistry()
    reg.counter("ptpu_test_served_total", "x").inc(5)
    srv = obsreg.serve_metrics(port=0, registry=reg)
    try:
        url = "http://127.0.0.1:%d" % srv.port
        body = urllib.request.urlopen(url + "/metrics",
                                      timeout=10).read().decode()
        assert "ptpu_test_served_total 5" in body
        hz = urllib.request.urlopen(url + "/healthz", timeout=10)
        assert hz.status == 200
    finally:
        srv.close()
    path = obsreg.write_textfile(str(tmp_path / "metrics.prom"),
                                 registry=reg)
    with open(path) as f:
        assert "ptpu_test_served_total 5" in f.read()


# --------------------------------------------------------------- serving --

def _save_mlp(tmp_path, feat=8, classes=6, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[feat], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=classes, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = os.path.join(str(tmp_path), "mlp")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                      main_program=main)
    return model_dir, feat


def test_pipelined_serving_trace_reconstructs_and_stays_bit_exact(
        tmp_path):
    model_dir, feat = _save_mlp(tmp_path)
    engine = serving.InferenceEngine(
        model_dir, name="obs", max_batch_size=8,
        batch_buckets=[1, 2, 4, 8], max_queue_delay_ms=4,
        pipeline_depth=2, device="cpu")
    try:
        trace.clear()
        rng = np.random.RandomState(0)
        feeds = [rng.rand(1 + (i % 4), feat).astype("float32")
                 for i in range(24)]
        results, lock = {}, threading.Lock()

        def client(i):
            fut = engine.submit({"x": feeds[i]})
            out = fut.result(60).numpy()
            with lock:
                results[i] = (out, fut.bucket)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        engine.drain(30)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and trace.dump()["open"]:
            time.sleep(0.02)

        d = trace.dump()
        by_name = {}
        for ev in d["events"]:
            by_name.setdefault(ev["name"], []).append(ev)
        req_traces = {e["trace"] for e in by_name["serving/request"]}
        assert len(req_traces) == 24
        assert req_traces <= {e["trace"] for e in by_name["serving/queue"]}

        def batch_traces(name):
            out = set()
            for ev in by_name.get(name, ()):
                out.update(ev["args"]["traces"])
            return out

        for stage in ("serving/formed_wait", "serving/dispatch",
                      "serving/pad_h2d", "serving/enqueue",
                      "serving/execute"):
            assert req_traces <= batch_traces(stage), stage
        assert req_traces <= {e["trace"]
                              for e in by_name["serving/materialize"]}

        execs = [(e["ts"], e["ts"] + e["dur"])
                 for e in by_name["serving/execute"]]
        assert execs
        for s0, e0 in execs:
            overlap = sum(1 for s1, e1 in execs if s1 < e0 and e1 > s0)
            assert overlap <= 2, "window occupancy exceeded depth"

        # each batch's trace reaches the engine's spans and the
        # Executor's exec/step span
        btraces = {e["trace"] for e in by_name["serving/execute"]}
        for stage in ("serving/pad_h2d", "serving/enqueue", "exec/step"):
            covered = {e["trace"] for e in by_name.get(stage, ())}
            assert btraces <= covered, stage

        ct = trace.export_chrome_trace(data=d)
        names = {e["name"] for e in ct["traceEvents"]}
        assert "serving/request" in names and "serving/execute" in names

        for i, (out, bucket) in results.items():
            ref, _ = engine.run_direct({"x": feeds[i]},
                                       batch_bucket=bucket[0],
                                       seq_bucket=bucket[1])
            for name in ref:
                np.testing.assert_array_equal(out[name], ref[name],
                                              err_msg="req %d" % i)
    finally:
        engine.close()
        _forget_engine(engine)
        trace.clear()


def test_serving_server_metrics_includes_registry(tmp_path):
    from paddle_tpu_torch.serving.server import ModelServer
    model_dir, feat = _save_mlp(tmp_path)
    engine = serving.InferenceEngine(model_dir, name="m", max_batch_size=4,
                                     pipeline_depth=2, device="cpu")
    server = ModelServer(engine, port=0).start()
    try:
        engine.infer({"x": np.ones((1, feat), "float32")})
        body = urllib.request.urlopen(
            "http://%s/metrics" % server.address,
            timeout=10).read().decode()
        assert "ptpu_serving_requests_total" in body
        assert "ptpu_window_depth" in body
        assert "ptpu_batcher_queue_depth" in body
        assert "ptpu_trace_ring_events" in body
        for line in body.splitlines():
            if line.startswith("# TYPE"):
                assert body.count(line + "\n") <= 1, line
    finally:
        server.shutdown()
        _forget_engine(engine)
