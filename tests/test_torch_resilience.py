"""Fault plans, the dispatch and reader fault seams, and the Supervisor
against the JAX package, on the CPU.

- Fault plans: the same spec strings parse to the same entries in both
  packages (one-shot and `*`); each seam fires: dispatch (an injected
  error consumes no seed), reader (through double_buffer, with
  prefetch=True), checkpoint (`ckpt_kill` through PTPU_FAULT_PLAN in a
  subprocess); the canary seam is in test_torch_sentinel.py.
- The fault-policy matrix: for each fault class (numeric, dispatch,
  hang, reader) and policy (skip, retry, rollback, abort) the port's
  supervisor logs the same action sequence as the JAX package's, and
  ends within 1e-5 of it (no dropout, the same startup state).
- In the port: a rollback is bit-exact against a fault-free run, feed-fed
  and reader-fed (dropout on, so the seed cursor matters); rollback's
  lr_scale re-entry; a persistent fault escalating to an exact skip; a
  hang that writes a bundle and rolls back bit-exactly, its abandoned
  worker consuming no record and no seed when it wakes; the reader
  worker fault channel; a divergence rollback; and the port's Executor
  is not taken for a parallel executor.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import resilience as jrz
from paddle_tpu.checkpoint import CheckpointManager as JManager

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as rz
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.core.readers import (DoubleBufferReader,
                                           IteratorReader, ReaderBase)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = np.random.RandomState(7)
DATA = [R.rand(8, 6).astype("f") for _ in range(16)]
EXE = tfluid.Executor("cpu")
JEXE = jfluid.Executor(jfluid.CPUPlace())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan_left():
    yield
    plan = rz.active_plan()
    if plan is not None:
        plan.disarm()
    assert rz.active_plan() is None and jrz.active_plan() is None


def _feed_fn(i):
    return {"x": DATA[i % len(DATA)], "y": DATA[i % len(DATA)][:, :1]}


def _records(path):
    def gen():
        r = np.random.RandomState(3)
        for _ in range(64):
            xs = r.rand(4, 6).astype("float32")
            yield xs, xs[:, :1].copy()
    tfluid.recordio_writer.convert_reader_to_recordio_file(path, gen)
    return path


@pytest.fixture(scope="module")
def recordio(tmp_path_factory):
    return _records(str(tmp_path_factory.mktemp("resil") / "d.recordio"))


def _body(fluid, dropout, path=None, double_buffer=False):
    if path is None:
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    else:
        rdr = fluid.layers.open_recordio_file(
            filename=path, shapes=[[-1, 6], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "float32"])
        if double_buffer:
            rdr = fluid.layers.double_buffer(rdr)
        x, y = fluid.layers.read_file(rdr)
    h = fluid.layers.fc(input=x, size=8, act="tanh")
    if dropout:
        h = fluid.layers.dropout(h, dropout_prob=0.2)
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=p, label=y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


_PROGRAMS = {}


def _program(fluid, rzmod, dropout=True, path=None, double_buffer=False):
    """A guarded trainer (shared per configuration: one build each)."""
    key = (fluid.__name__, dropout, path, double_buffer)
    if key not in _PROGRAMS:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = _body(fluid, dropout, path, double_buffer)
        rzmod.install_numeric_guards(main, loss=loss)
        _PROGRAMS[key] = (main, startup, loss)
    return _PROGRAMS[key]


def _reader_name(main):
    return next(op.inputs["Reader"][0] for op in main.global_block().ops
                if op.type == "read")


def _state(scope):
    return {n: v.detach().float().numpy().copy()
            for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}


def _assert_state_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def _port_run(fault, policies, ck=None, path=None, n=10, dropout=True,
              checkpoint_every=4, watchdog=None, divergence=None,
              bundle_dir=None, feed_fn=_feed_fn, start=None):
    main, startup, loss = _program(tfluid, rz, dropout, path)
    if start is None:
        scope = tfluid.Scope()
        EXE.run(startup, scope=scope)
    else:
        # a reader var holds host state, not an array: checked by name
        # only for the feed-fed program
        scope = tio.scope_from_numpy(start, "cpu",
                                     program=main if path is None else None)
        if path is not None:   # the reader state: the startup's reader op
            rd = tfluid.Scope()
            EXE.run(startup, scope=rd)
            for nm, v in rd._vars.items():
                if isinstance(v, ReaderBase):
                    scope.set(nm, v)
    mgr = CheckpointManager(ck, async_save=False) if ck else None
    sup = rz.Supervisor(EXE, main, scope=scope, checkpoint_manager=mgr,
                        policies=policies, watchdog_timeout=watchdog,
                        divergence=divergence, bundle_dir=bundle_dir)
    plan = rz.FaultPlan(fault).arm() if fault else None
    try:
        res = sup.train(n, feed_fn=feed_fn if path is None else None,
                        fetch_list=[loss],
                        checkpoint_every=checkpoint_every if mgr else None)
    finally:
        if plan:
            plan.disarm()
        sup.close()
        if mgr:
            mgr.close()
    return _state(scope), res, sup


def _jax_run(fault, policies, ck, path=None, n=8, watchdog=None):
    main, startup, loss = _program(jfluid, jrz, False, path)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        JEXE.run(startup)
        start = {k: np.asarray(scope.get(k)).copy() for k in scope.names()
                 if not hasattr(scope.get(k), "next")}
        mgr = JManager(ck, async_save=False)
        sup = jrz.Supervisor(JEXE, main, scope=scope,
                             checkpoint_manager=mgr, policies=policies,
                             watchdog_timeout=watchdog)
        plan = jrz.FaultPlan(fault).arm()
        try:
            sup.train(n, feed_fn=_feed_fn if path is None else None,
                      fetch_list=[loss], checkpoint_every=2)
        finally:
            plan.disarm()
            sup.close()
            mgr.close()
        final = {k: np.asarray(scope.get(k)).copy() for k in scope.names()
                 if not hasattr(scope.get(k), "next")}
    return start, final, sup


# ---------------------------------------------------------- fault plans --
@pytest.mark.parametrize("spec", [
    "nan_feed@5;reader_stall@8:0.25;dispatch_exc@3*",
    "loss_spike@3:50;grad_blowup@5;bitflip@1:1",
    "slow_step@2:0.5;reader_exc@4;reader_nan@9*;ckpt_kill@1",
])
def test_fault_plan_specs_parse_alike(spec):
    def entries(mod):
        return [(e.kind, e.at, e.arg, e.repeat)
                for e in mod.FaultPlan.from_env(spec).entries]
    assert entries(rz) == entries(jrz)
    assert rz.FaultPlan.from_env("") is None
    with pytest.raises(ValueError):
        rz.FaultPlan(["definitely_not_a_kind@1"])
    with pytest.raises(ValueError):
        rz.FaultPlan(["nan_feed"])


def test_one_shot_repeat_and_single_armed_plan():
    p = rz.FaultPlan([("dispatch_exc", 1)])
    assert p._take(("dispatch_exc",), 1) is not None
    assert p._take(("dispatch_exc",), 1) is None
    pr = rz.FaultPlan(["dispatch_exc@1*"])
    assert pr._take(("dispatch_exc",), 1) is not None
    assert pr._take(("dispatch_exc",), 1) is not None
    with rz.FaultPlan(["nan_feed@1"]):
        with pytest.raises(RuntimeError):
            rz.FaultPlan(["nan_feed@2"]).arm()
    assert rz.active_plan() is None


def test_dispatch_seam_fires_before_the_seed_draw():
    """An injected dispatch error consumes no seed and writes nothing; a
    nan_feed on the same seam poisons the feed and trips the guard."""
    main, startup, loss = _program(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    EXE.run(main, feed=_feed_fn(0), fetch_list=[loss], scope=scope)
    seed, before = scope.seed_state(), _state(scope)
    with rz.FaultPlan(["dispatch_exc@1", "nan_feed@2"]) as plan:
        plan.set_step(1)
        with pytest.raises(rz.InjectedDispatchError):
            EXE.run(main, feed=_feed_fn(1), fetch_list=[loss], scope=scope)
        assert scope.seed_state() == seed
        _assert_state_equal(before, _state(scope))
        plan.set_step(2)
        with pytest.raises(rz.NumericalGuardError):
            EXE.run(main, feed=_feed_fn(1), fetch_list=[loss], scope=scope)
    _assert_state_equal(before, _state(scope))


def test_reader_seam_through_double_buffer_and_prefetch(recordio):
    """reader_nan@5 poisons the 6th record on the host before the double
    buffer's copy: with prefetch=True and steps=2, the third call trips,
    its one poisoned step gated, and the stream stands at 8 records."""
    main, startup, loss = _program(tfluid, rz, True, recordio, True)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    trips = 0
    with rz.FaultPlan(["reader_nan@5"]):
        for _ in range(4):
            try:
                EXE.run(main, fetch_list=[loss], scope=scope, steps=2,
                        prefetch=True)
            except rz.NumericalGuardError as e:
                trips += 1
                assert "@GRAD" in str(e)
    assert trips == 1
    name = _reader_name(main)
    EXE._prefetcher.rollback()
    assert scope.get(name)._consumed == 8
    assert all(np.isfinite(v).all() for v in _state(scope).values())


_CKPT_KILL_VICTIM = """
import sys
import numpy as np
sys.path.insert(0, %(repo)r)
import paddle_tpu_torch as fluid
from paddle_tpu_torch import resilience as rz
from paddle_tpu_torch.checkpoint import CheckpointManager
d = sys.argv[1]
main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    loss = fluid.layers.mean(x=fluid.layers.fc(input=x, size=1))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
exe, scope = fluid.Executor("cpu"), fluid.Scope()
exe.run(startup, scope=scope)
xb = np.random.RandomState(0).rand(4, 4).astype("f")
exe.run(main, feed={"x": xb}, fetch_list=[loss], scope=scope)
mgr = CheckpointManager(d, async_save=False)
mgr.save(1, program=main, scope=scope)
plan = rz.FaultPlan.from_env()  # PTPU_FAULT_PLAN=ckpt_kill@N
if plan:
    plan.arm()
mgr.save(2, program=main, scope=scope)
mgr.close()
print("SURVIVED")
"""


def test_ckpt_kill_through_the_fault_plan(tmp_path):
    from paddle_tpu_torch.checkpoint import find_valid_snapshot
    script = tmp_path / "victim.py"
    script.write_text(_CKPT_KILL_VICTIM % {"repo": REPO})
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PTPU_CKPT_FAULT_AT", None)
    killed = 0
    for n in (1, 3):
        d = str(tmp_path / ("ck%d" % n))
        env["PTPU_FAULT_PLAN"] = "ckpt_kill@%d" % n
        cp = subprocess.run([sys.executable, str(script), d], env=env,
                            capture_output=True, text=True, timeout=300)
        killed += cp.returncode == -9
        found = find_valid_snapshot(d)
        assert found is not None and found[0] in (1, 2), (n, cp.stderr)
    assert killed == 2


# ------------------------------------------------ the fault-policy matrix --
_POLICY = {
    "skip": lambda m: m.skip_batch(3),
    "retry": lambda m: m.retry(3, backoff=0.0),
    "rollback": lambda m: m.rollback(3),
    "abort": lambda m: m.abort(),
}
_FAULT = {
    "numeric": (["nan_feed@3"], None, True),
    "dispatch": (["dispatch_exc@3"], None, True),
    "hang": (["slow_step@3:1.5"], 0.4, True),
    "reader": (["reader_exc@4"], None, False),
}


@pytest.mark.parametrize("fault_cls", sorted(_FAULT))
@pytest.mark.parametrize("policy", sorted(_POLICY))
def test_fault_policy_matrix_matches_jax(fault_cls, policy, tmp_path,
                                         recordio):
    faults, watchdog, feed = _FAULT[fault_cls]
    path = None if feed else recordio

    def chain(mod):
        out = [_POLICY[policy](mod)]
        return out + ([mod.abort()] if policy != "abort" else [])

    def actions(sup):
        return [(e["class"], e["action"]) for e in sup.events]

    if policy == "abort":
        with pytest.raises(jrz.TrainingAborted) as ej:
            _jax_run(faults, {fault_cls: chain(jrz)}, str(tmp_path / "j"),
                     path, watchdog=watchdog)
        with pytest.raises(rz.TrainingAborted) as et:
            _port_run(faults, {fault_cls: chain(rz)}, str(tmp_path / "t"),
                      path, n=8, dropout=False, checkpoint_every=2,
                      watchdog=watchdog)
        assert type(et.value.cause).__name__ == \
            type(ej.value.cause).__name__
        return
    start, fj, sj = _jax_run(faults, {fault_cls: chain(jrz)},
                             str(tmp_path / "j"), path, watchdog=watchdog)
    ft, _, st = _port_run(faults, {fault_cls: chain(rz)},
                          str(tmp_path / "t"), path, n=8, dropout=False,
                          checkpoint_every=2, watchdog=watchdog, start=start)
    assert actions(st) == actions(sj)
    assert st.step == sj.step >= 8
    for n, v in fj.items():
        np.testing.assert_allclose(ft[n], v, rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# ---------------------------------------------- the port: exact recovery --
def test_rollback_bit_exact_feed_fed(tmp_path):
    fa, ra, _ = _port_run(None, None, ck=str(tmp_path / "a"))
    fb, rb, sup = _port_run(["nan_feed@6"],
                            {"numeric": [rz.rollback(1), rz.abort()]},
                            ck=str(tmp_path / "b"))
    assert ("numeric", "rollback") in [(e["class"], e["action"])
                                       for e in sup.events]
    _assert_state_equal(fa, fb)

    def losses(res):
        return {x["step"]: float(np.asarray(x["fetches"][0]).reshape(-1)[0])
                for x in res if x["fetches"] is not None}
    assert losses(ra) == losses(rb)


def test_rollback_bit_exact_reader_fed(tmp_path, recordio):
    fa, _, _ = _port_run(None, None, ck=str(tmp_path / "a"), path=recordio)
    fb, _, sup = _port_run(["reader_nan@6"],
                           {"numeric": [rz.rollback(2), rz.abort()]},
                           ck=str(tmp_path / "b"), path=recordio)
    assert ("numeric", "rollback") in [(e["class"], e["action"])
                                       for e in sup.events]
    _assert_state_equal(fa, fb)


def test_persistent_fault_escalates_to_an_exact_skip(tmp_path):
    bad = {"x": DATA[6].copy(), "y": DATA[6][:, :1]}
    bad["x"][1, 2] = np.nan

    def feed_fn(i):
        return bad if i == 6 else _feed_fn(i)

    main, startup, loss = _program(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    for i in range(10):
        try:
            EXE.run(main, feed=feed_fn(i), fetch_list=[loss], scope=scope)
        except rz.NumericalGuardError:
            assert i == 6
    fb, _, sup = _port_run(None, {"numeric": [rz.rollback(1),
                                              rz.skip_batch(2), rz.abort()]},
                           ck=str(tmp_path / "ck"), feed_fn=feed_fn)
    acts = [(e["class"], e["action"]) for e in sup.events]
    assert ("numeric", "rollback") in acts
    assert ("numeric", "skip_batch") in acts
    _assert_state_equal(_state(scope), fb)


def test_rollback_lr_scale_reentry(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        loss = tfluid.layers.mean(x=tfluid.layers.square_error_cost(
            input=tfluid.layers.fc(input=x, size=1), label=y))
        tfluid.optimizer.SGD(learning_rate=0.08).minimize(loss)
    rz.install_numeric_guards(main, loss=loss)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    lr_name = next(n for op in main.global_block().ops
                   for n in op.inputs.get("LearningRate", ()))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    sup = rz.Supervisor(EXE, main, scope=scope, checkpoint_manager=mgr,
                        policies={"numeric": [rz.rollback(1, lr_scale=0.5),
                                              rz.abort()]})
    plan = rz.FaultPlan(["nan_feed@5"]).arm()
    try:
        sup.train(8, feed_fn=_feed_fn, fetch_list=[loss], checkpoint_every=2)
    finally:
        plan.disarm()
        sup.close()
        mgr.close()
    np.testing.assert_allclose(scope.get(lr_name).numpy(), 0.04, rtol=1e-6)
    ev = next(e for e in sup.events if e["action"] == "rollback")
    assert lr_name in ev["detail"]


def test_hang_bundle_rollback_and_the_abandoned_worker(tmp_path, recordio):
    """slow_step trips the watchdog; the supervisor writes a bundle, rolls
    back and ends bit-exact vs the fault-free run. The worker that slept
    through its deadline wakes afterwards and pops no record, draws no
    seed and writes nothing."""
    bundles = str(tmp_path / "bundles")
    fa, _, _ = _port_run(None, None, ck=str(tmp_path / "a"), path=recordio)
    fb, _, sup = _port_run(["slow_step@6:1.0"],
                           {"hang": [rz.rollback(1), rz.abort()]},
                           ck=str(tmp_path / "b"), path=recordio,
                           watchdog=0.3, bundle_dir=bundles)
    acts = [(e["class"], e["action"]) for e in sup.events]
    assert ("hang", "bundle") in acts and ("hang", "rollback") in acts
    _assert_state_equal(fa, fb)
    meta, program, feeds, state = rz.read_bundle(
        os.path.join(bundles, sorted(os.listdir(bundles))[0]))
    assert meta["fault_class"] == "hang" and meta["thread_stacks"]
    assert program is not None and state

    # the abandoned worker, watched across its wake-up
    main, startup, loss = _program(tfluid, rz, True, recordio)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    EXE.run(main, fetch_list=[loss], scope=scope)
    name = _reader_name(main)
    seed, at, before = (scope.seed_state(), scope.get(name)._consumed,
                        _state(scope))
    with rz.FaultPlan(["slow_step@1:0.6"]) as plan:
        plan.set_step(1)
        with pytest.raises(rz.DispatchTimeoutError) as ei:
            EXE.run(main, fetch_list=[loss], scope=scope, timeout=0.2)
        assert ei.value.cache_key is None or ei.value.cache_key
        time.sleep(1.0)   # the worker wakes and unwinds
    assert scope.seed_state() == seed
    assert scope.get(name)._consumed == at
    _assert_state_equal(before, _state(scope))


def test_reader_worker_fault_channel():
    main, startup, _ = _program(tfluid, rz)

    def creator():
        def gen():
            yield (np.zeros(2, "f"),)
            raise ValueError("organic reader death")
        return gen()

    sup = rz.Supervisor(EXE, main, scope=tfluid.Scope())
    try:
        db = DoubleBufferReader(IteratorReader(creator), capacity=2)
        deadline = time.monotonic() + 5.0
        while not any(e["action"] == "notified" for e in sup.events):
            assert time.monotonic() < deadline, "the channel never fired"
            time.sleep(0.02)
        db.next()
        for _ in range(2):   # sticky: a dead stream keeps raising
            with pytest.raises(ValueError) as ei:
                db.next()
            assert getattr(ei.value, "_reader_fault", False)
        db.close()
    finally:
        sup.close()
    ev = next(e for e in sup.events if e["action"] == "notified")
    assert "DoubleBufferReader" in ev["detail"]


def test_divergence_rollback(tmp_path):
    spike = {"x": DATA[5], "y": DATA[5][:, :1] * 1000.0}

    def feed_fn(i):
        return spike if i == 6 else _feed_fn(i)

    final, _, sup = _port_run(
        None, {"numeric": [rz.rollback(2), rz.skip_batch(1), rz.abort()]},
        ck=str(tmp_path), feed_fn=feed_fn, checkpoint_every=2,
        divergence=rz.DivergenceDetector(window=3, threshold=10.0))
    assert any(e["action"] == "rollback" and "spiked" in (e["error"] or "")
               for e in sup.events)
    assert all(np.isfinite(v).all() for v in final.values())


def test_the_port_executor_is_not_a_parallel_executor():
    main, _, _ = _program(tfluid, rz)
    scope = tfluid.Scope()
    sup = rz.Supervisor(EXE, main, scope=scope)
    try:
        assert sup._is_parallel is False and sup.scope is scope
        assert not hasattr(EXE, "place")   # the JAX package's test
    finally:
        sup.close()
    # restore_layout= reshards every rollback since the parallel slice
    lay = tfluid.parallel.DeviceLayout(local_device_count=1,
                                       devices=["cpu"])
    sup = rz.Supervisor(EXE, main, scope=scope, restore_layout=lay)
    try:
        assert sup.restore_layout is lay and sup._is_parallel is False
    finally:
        sup.close()
