"""The port's fleet layer against the JAX package's, on the CPU:
PoolAutoscaler (serving/autoscaler.py), ModelFleet (serving/fleet.py),
shadow promotion, and DecodePool (serving/pool.py).

- PoolAutoscaler.tick(now=) under one script of signals (429 deltas,
  queue depth, in-flight work, the clock) makes the JAX controller's
  decisions, one for one, over a stand-in pool that records the
  membership calls; on a real port pool the controller grows it on
  rejections and shrinks it back by draining, zero requests failing;
- ModelFleet's brownout level and shed decisions under one script of
  pool pressures are the JAX fleet's, with the same Retry-After hints;
  on real pools (tests/test_torch_replica_pool.py's model) the lower
  priority tier browns out first and the top tier keeps answering;
- shadow promotion of a poisoned canary serves only the incumbent's
  answers and rolls back;
- render_prometheus_all(pools=) gives the JAX package's family names,
  types and label sets for a plain engine beside two pools (a killed
  replica's state gauge reads 6: ejected + dead);
- a DecodePool of two port DecodeEngines over a decode step the JAX
  package saved gives every stream the tokens of a solo decode and of a
  JAX DecodePool, and its pool_state() has the JAX keys.

The controllers are driven by tick() and submit-time decisions with
shed_dwell_s=0: no test waits on the clock's margins.
"""
import re
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.serving import autoscaler as jautoscaler
from paddle_tpu.serving import pool as jpool_mod

from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import autoscaler as tautoscaler
from paddle_tpu_torch.serving import pool as tpool_mod
from paddle_tpu_torch.resilience.faults import FaultPlan

from test_torch_decode_serving import (SLOTS, _close, _save_jax_decoder,
                                       stream_feed, toks)
from test_torch_replica_pool import (answers_of, assert_like_lone,
                                     concurrent, jax_pool, port_pool,
                                     requests, save_model, wait_for)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_model")
    fetch = save_model(d, 2)
    lone = serving.InferenceEngine(str(d), device="cpu",
                                   batch_buckets=[1, 4], pipeline_depth=0)
    yield str(d), fetch, lone
    lone.close()


class _StandInPool(object):
    """The signals PoolAutoscaler reads, set by the test, and the
    membership calls it makes, recorded. `metrics` is the package's own
    PoolMetrics."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.closed = False
        self.live, self.qd, self.cap, self.inflight = 1, 0, 64, 0
        self.calls = []

    def live_replica_count(self):
        return self.live

    def queue_depth(self):
        return self.qd

    def queue_capacity_total(self):
        return self.cap

    def total_inflight(self):
        return self.inflight

    def add_replica(self):
        self.live += 1
        self.calls.append("add")
        return self.live - 1

    def remove_replica(self, idx=None, timeout=None):
        self.live -= 1
        self.calls.append("remove")
        return self.live


# (now, 429s since the last tick, queue depth, in flight)
SCRIPT = [(0.0, 0, 0, 0), (0.1, 3, 10, 5), (0.5, 2, 10, 5), (1.2, 1, 40, 8),
          (2.5, 4, 40, 8), (3.0, 0, 0, 2), (3.2, 0, 0, 0), (5.0, 0, 0, 0),
          (7.0, 0, 33, 0), (8.5, 0, 0, 0), (12.0, 0, 0, 0), (15.0, 0, 0, 0),
          (18.5, 0, 0, 0), (19.0, 0, 0, 0), (25.0, 0, 0, 0)]


def _run_script(autoscaler_mod, pool_mod):
    pool = _StandInPool(pool_mod.PoolMetrics())
    ctl = autoscaler_mod.PoolAutoscaler(
        pool, min_replicas=1, max_replicas=3, scale_up_cooldown_s=1.0,
        scale_down_cooldown_s=5.0, down_idle_s=3.0)
    decisions = []
    for now, rejects, qd, inflight in SCRIPT:
        for _ in range(rejects):
            pool.metrics.on_queue_full()
        pool.qd, pool.inflight = qd, inflight
        decisions.append(ctl.tick(now=now))
    state = ctl.state()
    state.pop("last_scale_up_s")
    return decisions, pool.calls, state


def test_autoscaler_decisions_match_the_jax_controller():
    got = _run_script(tautoscaler, tpool_mod)
    want = _run_script(jautoscaler, jpool_mod)
    assert got == want
    decisions, calls, state = got
    assert calls.count("add") == 2 and calls.count("remove") == 2, calls
    assert state["live_replicas"] == 1
    with pytest.raises(ValueError, match="max_replicas"):
        tautoscaler.PoolAutoscaler(_StandInPool(tpool_mod.PoolMetrics()),
                                   min_replicas=2, max_replicas=1)


def test_autoscaler_grows_and_drains_a_real_pool(model):
    d, fetch, lone = model
    feeds = requests(31, 12)
    pool = port_pool(d, replicas=1)
    ctl = tautoscaler.PoolAutoscaler(pool, min_replicas=1, max_replicas=3,
                                     down_idle_s=1.0)
    try:
        pool.metrics.on_queue_full()             # clients were shed
        assert ctl.tick(now=100.0) == ("up", 1)
        assert ctl.last_scale_up_s is not None
        assert pool.live_replica_count() == 2
        assert pool._admission.hi == pool.queue_capacity_total()
        futures = concurrent(pool, feeds)
        got, errors = answers_of(futures, fetch)
        assert errors == []
        assert_like_lone(lone, feeds, futures, got, fetch)
        assert ctl.tick(now=101.0) is None       # idle clock starts
        assert ctl.tick(now=106.0) == ("down", 1)
        assert pool.live_replica_count() == 1
        assert [e[1] for e in pool.events] == ["scale_up", "scale_down"]
        assert pool.metrics.snapshot()["errors_total"] == 0
    finally:
        pool.close()
    with pytest.raises(ValueError, match="autoscale=True"):
        port_pool(d, replicas=1, min_replicas=1)
    with pytest.raises(ValueError, match="ABOVE max_replicas"):
        port_pool(d, replicas=3, autoscale=True, min_replicas=1,
                  max_replicas=2)


class _Adm(object):
    def __init__(self, limit):
        self.limit = limit

    def retry_after_s(self):
        return 0.05 * 64 / self.limit


class _PressurePool(object):
    """A pool of scripted pressure for ModelFleet."""

    def __init__(self):
        self._admission = _Adm(64.0)
        self.inflight, self.qd = 0, 0
        self.closed = False

    def total_inflight(self):
        return self.inflight

    def queue_capacity_total(self):
        return 128

    def queue_depth(self):
        return self.qd

    def submit(self, feed, deadline_ms=None):
        return "served"

    def close(self, drain=True, timeout=None):
        self.closed = True


# per step: (low tier in flight, high in flight, the admission limits,
# the model submitted to)
FLEET_SCRIPT = [(0, 0, 64.0, "lo"), (60, 0, 64.0, "lo"), (60, 10, 64.0, "hi"),
                (60, 60, 64.0, "lo"), (60, 60, 64.0, "hi"),
                (10, 0, 16.0, "lo"), (4, 0, 64.0, "lo"), (4, 0, 64.0, "lo"),
                (70, 1, 64.0, "hi"), (1, 70, 64.0, "hi")]


def _run_fleet(fleet_cls):
    fleet = fleet_cls(shed_dwell_s=0.0, pressure_high=0.85,
                      pressure_low=0.5)
    pools = {"lo": _PressurePool(), "hi": _PressurePool()}
    fleet.add_model("lo", pool=pools["lo"], priority=0, weight=1.0)
    fleet.add_model("hi", pool=pools["hi"], priority=5, weight=3.0)
    out = []
    for lo, hi, limit, name in FLEET_SCRIPT:
        pools["lo"].inflight, pools["hi"].inflight = lo, hi
        for p in pools.values():
            p._admission.limit = limit
        try:
            out.append(fleet.submit(name, {}))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append((type(e).__name__, round(e.retry_after_s, 6),
                        str(e)))
        out.append(fleet.brownout_level())
    state = fleet.fleet_state()
    for m in state["models"].values():
        m.pop("pool")
    return out, state


def test_fleet_brownout_decisions_match_the_jax_fleet():
    got, state = _run_fleet(serving.ModelFleet)
    want, jstate = _run_fleet(jserving.ModelFleet)
    assert got == want
    assert state == jstate
    kinds = [o[0] for o in got if isinstance(o, tuple)]
    assert kinds and set(kinds) == {"BrownoutError"}
    assert issubclass(serving.BrownoutError, serving.QueueFullError)


def test_fleet_sheds_the_lower_tier_first_on_real_pools(model):
    d, fetch, lone = model
    feeds = requests(33, 4)
    fleet = serving.ModelFleet(shed_dwell_s=0.0, pressure_high=0.0,
                               pressure_low=-1.0)
    jfleet = jserving.ModelFleet(shed_dwell_s=0.0, pressure_high=0.0,
                                 pressure_low=-1.0)
    fleet.add_model("bulk", pool=port_pool(d, replicas=1), priority=0)
    fleet.add_model("live", priority=1, model_dir=d, replicas=1,
                    place="cpu", batch_buckets=[1, 4])
    jfleet.add_model("bulk", pool=jserving.ReplicaPool(
        d, replicas=1, place=jfluid.CPUPlace(), batch_buckets=[1, 4]),
        priority=0)
    jfleet.add_model("live", priority=1, model_dir=d, replicas=1,
                     place=jfluid.CPUPlace(), batch_buckets=[1, 4])
    try:
        for fl in (fleet, jfleet):
            with pytest.raises(Exception) as e:
                fl.submit("bulk", feeds[0])
            assert type(e.value).__name__ == "BrownoutError"
            assert e.value.retry_after_s > 0
            assert fl.brownout_level() == 1
            assert fl.is_browned_out("bulk") and \
                not fl.is_browned_out("live")
        got = fleet.infer("live", feeds[1])[fetch]
        want, _ = lone.run_direct(feeds[1], batch_bucket=1)
        np.testing.assert_array_equal(got, want[fetch])
        entry = fleet.registry()["live"]
        assert entry.describe()["priority"] == 1
        assert entry.infer(feeds[2])[fetch].shape == want[fetch].shape
        state = fleet.fleet_state()
        assert state["models"]["bulk"]["shed_total"] == 1
        assert sorted(state) == sorted(jfleet.fleet_state())
    finally:
        fleet.close()
        jfleet.close()
    with pytest.raises(serving.ServingClosedError):
        fleet.submit("live", feeds[0])


def test_shadow_promotion_serves_only_the_incumbent(model):
    d, fetch, lone = model
    feeds = requests(35, 8)
    pool = port_pool(d)
    try:
        with FaultPlan(["canary_poison@0"]):
            ctrl = pool.promote(model_dir=d, shadow=True,
                                traffic_fraction=1.0, min_requests=50,
                                max_breaches=2, latency_ratio=None)
            futures = [pool.submit(f) for f in feeds]
            got, errors = answers_of(futures, fetch)
            wait_for(lambda: ctrl.state()["state"] == "rolled_back", 30,
                     "the shadow canary to roll back")
        assert errors == []
        assert_like_lone(lone, feeds, futures, got, fetch)
        st = ctrl.state()
        assert st["mode"] == "shadow" and \
            st["breach_kinds"] == {"non_finite": 2}
    finally:
        pool.close()


def _families(text):
    """{family: (TYPE, sorted label-name tuples of its samples)} of a
    Prometheus exposition; each family's HELP and TYPE appear once."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert name not in types, name
            types[name] = kind
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            names = tuple(sorted(re.findall(r'(\w+)="', line)))
            labels.setdefault(name, set()).add(names)
    return {n: (types[n], sorted(labels.get(n, ()))) for n in types}


def test_pool_metrics_render_like_the_jax_pools(model):
    """render_prometheus_all(pools=): the JAX package's family names,
    types and label sets, for a plain engine beside two pools."""
    from paddle_tpu.serving.metrics import \
        render_prometheus_all as jax_render
    from paddle_tpu_torch.serving.metrics import render_prometheus_all
    d0, fetch, lone = model
    feeds = requests(15, 6)
    pools = {"a": port_pool(d0), "b": port_pool(d0, replicas=1)}
    jpools = {"a": jax_pool(d0), "b": jax_pool(d0, replicas=1)}
    jlone = jserving.InferenceEngine(d0, batch_buckets=[1, 4])
    try:
        for p in list(pools.values()) + list(jpools.values()):
            answers_of([p.submit(f) for f in feeds], fetch)
        pools["a"].kill_replica(1)
        jpools["a"].kill_replica(1)
        text = render_prometheus_all({"lone": lone.metrics}, pools=pools)
        jtext = jax_render({"lone": jlone.metrics}, pools=jpools)
        got, want = _families(text), _families(jtext)
        assert got == want
        assert 'ptpu_serving_replica_state{model="a",replica="1"} 6' \
            in text
        assert 'ptpu_serving_pool_responses_total{model="b"} 6' in text
    finally:
        for p in list(pools.values()) + list(jpools.values()):
            p.close()
        jlone.close()


def test_decode_pool_streams_equal_solo_and_the_jax_pool(tmp_path):
    path = str(tmp_path / "decoder")
    _save_jax_decoder(path)
    rng = np.random.RandomState(12)
    feeds = [stream_feed(i, rng) for i in range(10)]
    engines = [serving.DecodeEngine(path, max_slots=SLOTS,
                                    name="port-dec-%d" % i, place="cpu")
               for i in range(2)]
    jengines = [jserving.DecodeEngine(path, max_slots=SLOTS,
                                      name="jax-dec-%d" % i)
                for i in range(2)]
    solo = serving.DecodeEngine(path, max_slots=SLOTS, name="port-solo",
                                place="cpu")
    pool = serving.DecodePool(engines, name="port-decode")
    jpool = jserving.DecodePool(jengines, name="jax-decode")
    try:
        want = [toks(solo.decode(f, max_new_tokens=8, timeout=120))
                for f in feeds]
        streams = [None] * len(feeds)

        def fire(i):
            streams[i] = pool.submit(feeds[i], max_new_tokens=8)

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        jstreams = [jpool.submit(f, max_new_tokens=8) for f in feeds]
        for i, (s, js) in enumerate(zip(streams, jstreams)):
            got = toks(s.result(120))
            np.testing.assert_array_equal(got, want[i], err_msg=str(i))
            np.testing.assert_array_equal(got, toks(js.result(120)))
        stats = pool.decode_stats()
        assert stats["replicas"] == 2 and stats["streams_completed"] == 10
        assert sum(e.decode_stats()["streams_completed"]
                   for e in engines) == 10
        assert all(e.decode_stats()["streams_completed"] for e in engines)
        state, jstate = pool.pool_state(), jpool.pool_state()
        assert sorted(state) == sorted(jstate)
        assert [sorted(r) for r in state["replicas"]] == \
            [sorted(r) for r in jstate["replicas"]]
        assert pool.describe()["pool"]["mode"] == "decode"
    finally:
        pool.close(drain=False)
        jpool.close(drain=False)
        for e in engines + [solo]:
            _close(e)
    with pytest.raises(serving.ServingClosedError):
        pool.submit(feeds[0])
