"""The port's ReplicaPool (serving/pool.py) and canary promotion
(serving/canary.py) against the JAX package's, on the CPU.

Both packages serve one directory, saved by the JAX package's
save_inference_model: a small Transformer scoring model (1+1 layers,
d_model 16, 2 heads of 8, d_inner 32, vocab 50, T 8, fused attention)
whose weights are numpy draws from a seed. The JAX engines run their
fused attention through its plain reference (T 8 is below
FLAGS_flash_min_seq), the port's through its kernel wrappers' plain
versions on CPU tensors.

- answers: a pooled answer is bit-equal to a lone port engine's
  run_direct at the same bucket (one device, one shape, the same
  arithmetic), and within rtol = atol = 1e-5 of the JAX pool's answer to
  the same request (fp32, two layers, sums in another order);
- `pool_state()` has the JAX package's keys, top level and per replica
  (the metrics' render: tests/test_torch_serving_fleet.py);
- each serving fault kind (replica_exc, replica_poison, replica_wedge,
  replica_crash) fires through the port's ReplicaTap: requests sent one
  at a time (so routing is deterministic) all answer, none fails, and
  the pool's event kinds are the JAX pool's, in the same order;
- kill_replica under concurrent load: zero client errors;
- reload(model_dir=) under concurrent load drops nothing, bumps every
  replica's generation, and later answers are bit-equal to a fresh
  engine on the new weights;
- promote() with canary_poison rolls back with zero client errors and
  every answer the incumbent's; a healthy canary is promoted; both end
  in the JAX controller's state.

No test waits on a margin under 10x its timeout: the wedge sleeps 3 s
behind a 0.3 s attempt timeout; promotions settle within 30 s polls.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jtr
from paddle_tpu.resilience.faults import FaultPlan as JFaultPlan

from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.resilience.faults import FaultPlan

VOCAB, T = 50, 8
CFG = dict(n_layer=1, n_head=2, d_key=8, d_value=8, d_model=16,
           d_inner_hid=32)
TOL = dict(rtol=1e-5, atol=1e-5)
FEEDS = list(ttr.SCORING_FEED_NAMES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def save_model(path, seed):
    """The small Transformer scoring model, its weights numpy draws from
    `seed` (N(0, 0.3^2); layer-norm scales 1 + that), saved by the JAX
    package. Returns the fetch name."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        _, _, predict = jtr.transformer(VOCAB, VOCAB, T,
                                        use_fused_attention=True, **CFG)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    rng = np.random.RandomState(seed)
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for p in sorted(main.all_parameters(), key=lambda p: p.name):
            w = 0.3 * rng.standard_normal(p.shape).astype("float32")
            if "layer_norm" in p.name and p.name.endswith(".w_0"):
                w += 1.0
            scope.set(p.name, w)
        jfluid.io.save_inference_model(str(path), FEEDS, [predict], exe,
                                       main)
    return predict.name


def requests(seed, n):
    """n one-row scoring requests, source and target lengths 2-8."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rng.randint(3, VOCAB, rng.randint(2, T + 1)).tolist()
        trg = rng.randint(3, VOCAB, rng.randint(2, T + 1)).tolist()
        out.append(ttr.prepare_batch([src], [trg], T))
    return out


def port_pool(d, replicas=2, **kw):
    kw.setdefault("batch_buckets", [1, 4])
    kw.setdefault("max_queue_delay_ms", 2)
    kw.setdefault("place", "cpu")
    return serving.ReplicaPool(d, replicas=replicas, **kw)


def jax_pool(d, replicas=2, **kw):
    kw.setdefault("batch_buckets", [1, 4])
    kw.setdefault("max_queue_delay_ms", 2)
    kw.setdefault("place", jfluid.CPUPlace())
    return jserving.ReplicaPool(d, replicas=replicas, **kw)


def wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for %s" % what)


def concurrent(pool, feeds):
    """Submit every feed from its own thread; the futures (or the
    exception a submit raised)."""
    futures = [None] * len(feeds)

    def fire(i):
        try:
            futures[i] = pool.submit(feeds[i])
        except Exception as e:  # noqa: BLE001 — collected, not raised
            futures[i] = e

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(feeds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return futures


def answers_of(futures, fetch, timeout=60):
    """(answers, client errors) of `futures`."""
    out, errors = [], []
    for i, f in enumerate(futures):
        if not hasattr(f, "result"):
            errors.append((i, f))
            out.append(None)
            continue
        try:
            out.append(f.result(timeout).numpy()[fetch])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append((i, e))
            out.append(None)
    return out, errors


def assert_like_lone(engine, feeds, futures, answers, fetch):
    """Each answer bit-equal to the lone engine's run_direct at the
    bucket the pool dispatched it at."""
    for i, (f, a) in enumerate(zip(futures, answers)):
        want, _ = engine.run_direct(feeds[i], batch_bucket=f.bucket[0])
        np.testing.assert_array_equal(a, want[fetch], err_msg=str(i))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(dir of seed 0, dir of seed 1, fetch name, a lone port engine on
    each)."""
    d0 = tmp_path_factory.mktemp("pool_model_a")
    d1 = tmp_path_factory.mktemp("pool_model_b")
    fetch = save_model(d0, 0)
    assert save_model(d1, 1) == fetch
    lone = [serving.InferenceEngine(str(d), device="cpu",
                                    batch_buckets=[1, 4], pipeline_depth=0)
            for d in (d0, d1)]
    yield str(d0), str(d1), fetch, lone
    for e in lone:
        e.close()


def test_pool_answers_like_the_jax_pool_and_a_lone_engine(model):
    d0, _, fetch, (lone, _) = model
    feeds = requests(3, 12)
    pool, jpool = port_pool(d0, replicas=3), jax_pool(d0, replicas=3)
    try:
        futures = concurrent(pool, feeds)
        got, errors = answers_of(futures, fetch)
        assert errors == []
        assert_like_lone(lone, feeds, futures, got, fetch)
        want, jerrors = answers_of(concurrent(jpool, feeds), fetch)
        assert jerrors == []
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        assert sum(1 for r in pool._replicas if r.dispatches) >= 2
        snap = pool.metrics.snapshot()
        assert (snap["responses_total"], snap["errors_total"]) == (12, 0)
        assert sorted(snap) == sorted(jpool.metrics.snapshot())
        state, jstate = pool.pool_state(), jpool.pool_state()
        assert sorted(state) == sorted(jstate)
        assert [sorted(r) for r in state["replicas"]] == \
            [sorted(r) for r in jstate["replicas"]]
        assert [r["devices"] for r in state["replicas"]] == [["cpu"]] * 3
        d = pool.describe()
        assert d["pool"]["healthy"] == 3 and d["name"] == pool.name
    finally:
        pool.close()
        jpool.close()


def test_pool_refuses_a_bad_request_without_blaming_a_replica(model):
    d0 = model[0]
    pool = port_pool(d0)
    try:
        with pytest.raises(serving.InvalidRequestError):
            pool.submit({"src_word": np.zeros((1, T, 1), "int64")})
        assert pool.metrics.snapshot()["retries_total"] == 0
        assert all(len(r.window) == 0 for r in pool._replicas)
    finally:
        pool.close()


FAULTS = {
    # kind: (plan, pool options, the metric the fault must move)
    "replica_exc": (["replica_exc@1"], dict(eject_consecutive=2),
                    "retries_total"),
    "replica_poison": (["replica_poison@1"], dict(eject_consecutive=2),
                       "poisoned_results_total"),
    "replica_wedge": (["replica_wedge@1:3.0"],
                      dict(attempt_timeout_s=0.3, eject_consecutive=1),
                      "attempt_timeouts_total"),
    "replica_crash": (["replica_crash@1"], dict(eject_consecutive=2),
                      "retries_total"),
}


def _sequential(pool, feeds, fetch, plan):
    """Requests one at a time under `plan`: (answers, futures, client
    errors)."""
    answers, futures, errors = [], [], []
    with plan:
        for i, f in enumerate(feeds):
            try:
                fut = pool.submit(f)
                answers.append(fut.result(60).numpy()[fetch])
                futures.append(fut)
            except Exception as e:  # noqa: BLE001 — reported by the caller
                errors.append((i, repr(e)))
    return answers, futures, errors


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_serving_fault_fails_over_like_the_jax_pool(model, kind):
    d0, _, fetch, (lone, _) = model
    plan, opts, metric = FAULTS[kind]
    feeds = requests(5, 6)
    opts = dict(opts, retries=3, eject_cooldown_s=60.0)
    pool, jpool = port_pool(d0, **opts), jax_pool(d0, **opts)
    try:
        got, futures, errors = _sequential(pool, feeds, fetch,
                                           FaultPlan(plan))
        assert errors == []
        assert_like_lone(lone, feeds, futures, got, fetch)
        want, _, jerrors = _sequential(jpool, feeds, fetch,
                                       JFaultPlan(plan))
        assert jerrors == []
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        snap = pool.metrics.snapshot()
        assert snap[metric] >= 1 and snap["errors_total"] == 0, snap
        kinds = [e[1] for e in pool.events]
        assert kinds == [e[1] for e in jpool.events], (pool.events,
                                                       jpool.events)
        states = [r["state"] for r in pool.pool_state()["replicas"]]
        assert states == [r["state"]
                          for r in jpool.pool_state()["replicas"]]
    finally:
        pool.close(timeout=10)
        jpool.close(timeout=10)


def test_kill_replica_under_load_and_restart(model):
    d0, _, fetch, (lone, _) = model
    feeds = requests(7, 24)
    pool = port_pool(d0, replicas=3, retries=3, max_queue_delay_ms=10)
    try:
        futures = concurrent(pool, feeds[:12])
        pool.kill_replica(1)
        futures += concurrent(pool, feeds[12:])
        got, errors = answers_of(futures, fetch)
        assert errors == []
        assert_like_lone(lone, feeds, futures, got, fetch)
        state = pool.pool_state()
        assert state["replicas"][1]["dead"] and state["healthy"] == 2
        assert pool.metrics.snapshot()["replica_kills_total"] == 1
        before = pool._replicas[1].dispatches
        answers_of(concurrent(pool, feeds[:6]), fetch)
        assert pool._replicas[1].dispatches == before
        pool.restart_replica(1)
        assert pool.pool_state()["healthy"] == 3
        assert pool._replicas[1].generation == 1
    finally:
        pool.close()


def test_reload_under_load_drops_nothing(model):
    d0, d1, fetch, (lone0, lone1) = model
    feeds = requests(9, 16)
    pool, jpool = port_pool(d0), jax_pool(d0)
    stop = threading.Event()
    results, errors = [], []

    def client(k):
        i = k
        while not stop.is_set():
            try:
                fut = pool.submit(feeds[i % len(feeds)])
                results.append((i % len(feeds), fut,
                                fut.result(60).numpy()[fetch]))
            except Exception as e:  # noqa: BLE001 — asserted empty
                errors.append(repr(e))
            i += 4

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: len(results) >= 8, 30, "traffic before the reload")
        pool.reload(model_dir=d1)
        n_at_reload = len(results)
        wait_for(lambda: len(results) >= n_at_reload + 8, 30,
                 "traffic after the reload")
        stop.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert [r.generation for r in pool._replicas] == [1, 1]
        assert pool.metrics.snapshot()["reloads_total"] == 1
        # each answer is one weight set's, bit for bit (which one depends
        # on when its replica flipped)
        for i, fut, a in results:
            old = lone0.run_direct(feeds[i], batch_bucket=fut.bucket[0])
            new = lone1.run_direct(feeds[i], batch_bucket=fut.bucket[0])
            assert np.array_equal(a, old[0][fetch]) or \
                np.array_equal(a, new[0][fetch]), i
        after = [pool.submit(f) for f in feeds[:4]]
        got, errs = answers_of(after, fetch)
        assert errs == []
        assert_like_lone(lone1, feeds[:4], after, got, fetch)
        jpool.reload(model_dir=d1)
        want, jerrs = answers_of([jpool.submit(f) for f in feeds[:4]], fetch)
        assert jerrs == []
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        assert [e[1] for e in pool.events] == [e[1] for e in jpool.events]
    finally:
        stop.set()
        pool.close()
        jpool.close()


def _promote_and_serve(pool, feeds, fetch, plan, **promote_kw):
    answers, futures, errors = [], [], []
    with plan:
        ctrl = pool.promote(**promote_kw)
        for i, f in enumerate(feeds):
            try:
                fut = pool.submit(f)
                answers.append(fut.result(60).numpy()[fetch])
                futures.append(fut)
            except Exception as e:  # noqa: BLE001 — reported by the caller
                errors.append((i, repr(e)))
        wait_for(lambda: ctrl.state()["state"] not in ("canary",
                                                       "promoting"),
                 30, "the promotion to settle")
    return ctrl, answers, futures, errors


def test_poisoned_canary_rolls_back_with_the_incumbents_answers(model):
    d0, d1, fetch, (lone0, _) = model
    feeds = requests(11, 12)
    kw = dict(model_dir=d1, traffic_fraction=0.25, min_requests=50,
              max_breaches=2, latency_ratio=None)
    pool, jpool = port_pool(d0), jax_pool(d0)
    try:
        ctrl, got, futures, errors = _promote_and_serve(
            pool, feeds, fetch, FaultPlan(["canary_poison@0"]), **kw)
        assert errors == []
        assert_like_lone(lone0, feeds, futures, got, fetch)
        jctrl, want, _, jerrors = _promote_and_serve(
            jpool, feeds, fetch, JFaultPlan(["canary_poison@0"]), **kw)
        assert jerrors == []
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        st, jst = ctrl.state(), jctrl.state()
        assert st["state"] == jst["state"] == "rolled_back"
        assert st["breach_kinds"] == jst["breach_kinds"] == \
            {"non_finite": 2}
        assert sorted(st) == sorted(jst)
        assert pool.promotion_state()["state"] == "rolled_back"
        assert [r.generation for r in pool._replicas] == [0, 0]
        # the rollback unblocks reload
        pool.reload()
    finally:
        pool.close()
        jpool.close()


def test_healthy_canary_is_promoted(model):
    d0, d1, fetch, (lone0, lone1) = model
    feeds = requests(13, 8)
    kw = dict(model_dir=d1, traffic_fraction=0.5, min_requests=3,
              max_breaches=1, divergence_bound=1e9, latency_ratio=None)
    pool, jpool = port_pool(d0), jax_pool(d0)
    try:
        ctrl, got, futures, errors = _promote_and_serve(
            pool, feeds, fetch, FaultPlan([]), **kw)
        assert errors == []
        jctrl, _, _, jerrors = _promote_and_serve(
            jpool, feeds, fetch, JFaultPlan([]), **kw)
        assert jerrors == []
        st, jst = ctrl.state(), jctrl.state()
        assert st["state"] == jst["state"] == "promoted"
        assert (st["oks"], st["breaches"]) == (jst["oks"], jst["breaches"])
        assert [r.generation for r in pool._replicas] == [1, 1]
        after = [pool.submit(f) for f in feeds[:3]]
        got, errs = answers_of(after, fetch)
        assert errs == []
        assert_like_lone(lone1, feeds[:3], after, got, fetch)
        # reload() refuses while a promotion routes traffic
        pool.promote(model_dir=d0, min_requests=50)
        with pytest.raises(RuntimeError, match="promotion is in flight"):
            pool.reload()
        pool.cancel_promotion()
        assert pool.promotion_state()["state"] == "cancelled"
    finally:
        pool.close()
        jpool.close()
