"""The training sentinel, rollback_skip_data, the canary and the bundle
tooling against the JAX package, on the CPU.

- RobustWindow and TrainingSentinel give the same z-scores and decisions
  as the JAX package's on the same seeded sequences (exact: both are host
  float arithmetic), and their state dicts round-trip.
- rollback_skip_data: one seeded reader stream with a NaN record, a
  reader error and a finite x1000 batch after the step-8 snapshot; the
  spike rolls back and skips past the window, and the final state is
  bit-exact against a clean run that skipped the same records (dropout
  on). Feed-fed, the action degrades to a plain rollback.
- The loss_spike feed seam is finite and one-shot.
- The canary (devices=["cpu"]): a stable digest, the reference in its
  state dict, `bitflip` convicting the exact check, the Supervisor's sdc
  abort carrying the typed cause, and the TF32 global put back.
- Bundles across packages: tools/ptpu_doctor.py (JAX_PLATFORMS=cpu, in a
  subprocess) inspects and replays a bundle the port wrote, and the
  port's read_bundle reads a bundle the JAX package wrote.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import resilience as jrz
from paddle_tpu.resilience import sentinel as jsentinel

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import resilience as rz
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.checkpoint.manager import skip_reader_records
from paddle_tpu_torch.resilience import sentinel as tsentinel
from paddle_tpu_torch.resilience.sdc import (CanaryChecker,
                                             SilentCorruptionError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXE = tfluid.Executor("cpu")
R = np.random.RandomState(11)
DATA = [R.rand(8, 6).astype("f") for _ in range(16)]


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


def _build(fluid, rzmod, path=None, dropout=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if path is None:
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        else:
            x, y = fluid.layers.read_file(fluid.layers.open_recordio_file(
                filename=path, shapes=[[-1, 6], [-1, 1]], lod_levels=[0, 0],
                dtypes=["float32", "float32"]))
        h = fluid.layers.fc(input=x, size=8, act="tanh")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.2)
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    rzmod.install_numeric_guards(main, loss=loss)
    return main, startup, loss


@pytest.fixture(scope="module")
def recordio(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sentinel") / "d.recordio")

    def gen():
        r = np.random.RandomState(3)
        for _ in range(64):
            xs = r.rand(4, 6).astype("float32")
            yield xs, xs[:, :1].copy()
    tfluid.recordio_writer.convert_reader_to_recordio_file(path, gen)
    return path


def _state(scope):
    return {n: v.detach().float().numpy().copy()
            for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}


def _assert_state_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


# -------------------------------------------------- statistics vs JAX --
def _sequence(seed):
    """A loss stream with warm-up, jitter, spikes, a NaN, a collapse of
    the grad norm, a blowup, and a slow drift at the end."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(160):
        loss = 1.0 + 0.05 * r.rand() + (0.03 * (i - 100) if i > 100 else 0)
        gn = 2.0 + 0.1 * r.rand()
        if i in (20, 47):
            loss *= 1000.0
        if i == 33:
            loss = float("nan")
        if i == 60:
            gn = 1e-6
        if i == 61:
            gn = 1e6
        out.append((loss, gn))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robust_window_zscores_match_jax(seed):
    wt = tsentinel.RobustWindow(window=16, warmup=8)
    wj = jsentinel.RobustWindow(window=16, warmup=8)
    for loss, _ in _sequence(seed):
        if not np.isfinite(loss):
            continue
        assert wt.zscore(loss) == wj.zscore(loss)
        assert wt.median() == wj.median()
        wt.push(loss)
        wj.push(loss)
    w2 = tsentinel.RobustWindow(window=16, warmup=8)
    w2.load_state_dict(wt.state_dict())
    assert w2.state_dict() == wj.state_dict()
    w2.reset()
    assert len(w2) == 0 and w2.zscore(1.0) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_sentinel_decisions_match_jax(seed):
    kw = dict(window=16, warmup=6, z_threshold=8.0, grad_z_threshold=6.0,
              divergence_factor=1.5, divergence_patience=8)
    st, sj = tsentinel.TrainingSentinel(**kw), jsentinel.TrainingSentinel(**kw)
    decisions = []
    for i, (loss, gn) in enumerate(_sequence(seed)):
        et = st.observe(loss, grad_norm=gn, step=i)
        ej = sj.observe(loss, grad_norm=gn, step=i)
        assert type(et).__name__ == type(ej).__name__, i
        if et is not None:
            assert str(et) == str(ej)
            decisions.append(type(et).__name__)
        assert (st.last_z, st.last_grad_z) == (sj.last_z, sj.last_grad_z)
    assert "LossSpikeError" in decisions
    assert st.state_dict() == sj.state_dict()
    assert st.status() == sj.status()
    s3 = tsentinel.TrainingSentinel(**kw)
    s3.load_state_dict(st.state_dict())
    assert s3.state_dict() == st.state_dict()


# --------------------------------------------------- rollback_skip_data --
def _live_reader(sup):
    states = sup._reader_states()
    assert len(states) == 1
    return states[0]


def test_rollback_skip_data_bit_exact_reader_fed(tmp_path, recordio):
    main, startup, loss = _build(tfluid, rz, recordio, dropout=True)
    # reference: a clean run that trained records 0..7, skipped 8..13
    scope_a = tfluid.Scope()
    EXE.run(startup, scope=scope_a)
    sup_a = rz.Supervisor(EXE, main, scope=scope_a)
    try:
        sup_a.train(8, fetch_list=[loss])
        name, state = _live_reader(sup_a)
        assert int(state._consumed) == 8
        assert skip_reader_records(scope_a, [name], 6) == 6
        sup_a.train(16, fetch_list=[loss])
    finally:
        sup_a.close()
    assert int(scope_a.get(name)._consumed) == 22

    scope_b = tfluid.Scope()
    EXE.run(startup, scope=scope_b)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    sentinel = rz.TrainingSentinel(window=32, warmup=6, z_threshold=50.0)
    sup_b = rz.Supervisor(
        EXE, main, scope=scope_b, checkpoint_manager=mgr, sentinel=sentinel,
        policies={"numeric": [rz.skip_batch(times=2), rz.abort()],
                  "reader": [rz.skip_batch(times=2), rz.abort()],
                  "loss_spike": [rz.rollback_skip_data(times=2, skip=1),
                                 rz.abort()]})
    plan = rz.FaultPlan(["reader_nan@9", "reader_exc@10",
                         "loss_spike@12"]).arm()
    try:
        sup_b.train(16, fetch_list=[loss], checkpoint_every=8)
    finally:
        plan.disarm()
        sup_b.close()
        mgr.close()
    acts = [(e["class"], e["action"]) for e in sup_b.events]
    assert ("numeric", "skip_batch") in acts
    assert ("reader", "skip_batch") in acts
    assert ("loss_spike", "rollback") in acts
    skip_ev = [e for e in sup_b.events if e["action"] == "rollback_skip"][0]
    assert "skipped 6 records" in skip_ev["detail"]
    assert sentinel.spikes == 1 and sup_b.step == 16
    _assert_state_equal(_state(scope_a), _state(scope_b))


def test_rollback_skip_data_feed_fed_degrades_to_rollback(tmp_path):
    main, startup, loss = _build(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    sup = rz.Supervisor(
        EXE, main, scope=scope, checkpoint_manager=mgr,
        sentinel=rz.TrainingSentinel(window=16, warmup=4, z_threshold=50.0),
        policies={"loss_spike": [rz.rollback_skip_data(times=1),
                                 rz.abort()]})
    plan = rz.FaultPlan(["loss_spike@6:1000"]).arm()
    try:
        sup.train(10, feed_fn=_feed_fn, fetch_list=[loss], checkpoint_every=4)
    finally:
        plan.disarm()
        sup.close()
        mgr.close()
    ev = [e for e in sup.events if e["action"] == "rollback_skip"]
    assert ev and "no in-graph readers" in ev[0]["detail"]
    assert sup.step == 10


def test_loss_spike_feed_seam_is_finite_and_one_shot():
    main, startup, loss = _build(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    vals = []
    with rz.FaultPlan(["loss_spike@1:100"]) as plan:
        for i in range(3):
            plan.set_step(i)
            out, = EXE.run(main, feed=_feed_fn(0), fetch_list=[loss],
                           scope=scope)
            vals.append(float(out.reshape(-1)[0]))
    assert all(np.isfinite(v) for v in vals)
    assert vals[1] > 100.0 * max(vals[0], vals[2])


# --------------------------------------------------------------- canary --
def test_canary_digest_stable_and_reference_travels():
    c = CanaryChecker(shape=(32, 32), seed=1, iters=2, devices=["cpu"])
    ref = c.record_reference()
    for _ in range(4):
        assert c.check() == ref
    assert c.checks == 5 and c.mismatches == 0
    c2 = CanaryChecker(shape=(32, 32), seed=1, iters=2, devices=["cpu"])
    c2.load_state_dict(c.state_dict())
    assert c2.reference == ref and c2.check() == ref
    assert CanaryChecker(shape=(32, 32), seed=2, iters=2,
                         devices=["cpu"]).record_reference() != ref
    with pytest.raises(ValueError):
        CanaryChecker(shape=(32, 16))


def test_canary_pins_fp32_and_restores_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        c = CanaryChecker(shape=(16, 16), iters=1, devices=["cpu"])
        c.check()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CanaryChecker().devices()


def test_bitflip_convicts_the_exact_check_then_healthy():
    c = CanaryChecker(shape=(32, 32), seed=0, iters=2, devices=["cpu"])
    with rz.FaultPlan(["bitflip@2"]):
        ref = c.record_reference()
        assert c.check() == ref
        with pytest.raises(SilentCorruptionError) as ei:
            c.check()
        assert ei.value.device_index == 0
        assert ei.value.expected == ref and ei.value.got != ref
        assert c.check() == ref
    assert [v["ok"] for v in c.verdicts] == [True, True, False, True]


def test_supervisor_sdc_abort_carries_the_cause():
    main, startup, loss = _build(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    sup = rz.Supervisor(EXE, main, scope=scope, sdc_every=1,
                        sdc=CanaryChecker(shape=(16, 16), iters=1,
                                          devices=["cpu"]))
    try:
        with rz.FaultPlan(["bitflip@1"]):
            with pytest.raises(rz.TrainingAborted) as ei:
                sup.train(6, feed_fn=_feed_fn, fetch_list=[loss])
    finally:
        sup.close()
    assert isinstance(ei.value.cause, SilentCorruptionError)
    assert ei.value.cause.device_index == 0
    assert ("sdc", "abort") in [(e["class"], e["action"])
                                for e in sup.events]
    assert sup.step >= 1


# -------------------------------------------- bundles across packages --
def _doctor(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("PTPU_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ptpu_doctor.py")]
        + list(args), env=env, capture_output=True, text=True, timeout=600)


def test_ptpu_doctor_reads_and_replays_a_port_bundle(tmp_path):
    bundles = str(tmp_path / "bundles")
    bad = {"x": DATA[3].copy(), "y": DATA[3][:, :1]}
    bad["x"][0, 0] = np.nan
    main, startup, loss = _build(tfluid, rz)
    scope = tfluid.Scope()
    EXE.run(startup, scope=scope)
    sup = rz.Supervisor(EXE, main, scope=scope,
                        policies={"numeric": [rz.abort(bundle_dir=bundles)]})
    try:
        with pytest.raises(rz.TrainingAborted) as ei:
            sup.train(6, feed_fn=lambda i: bad if i == 3 else _feed_fn(i),
                      fetch_list=[loss])
    finally:
        sup.close()
    bundle = ei.value.bundle
    cp = _doctor("inspect", bundle, "--json")
    assert cp.returncode == 0, cp.stderr
    rec = json.loads(cp.stdout)
    assert rec["fault_class"] == "numeric" and rec["step"] == 3
    assert rec["has_program"] and rec["has_feeds"]
    assert rec["num_state_vars"] > 0 and rec["trace"]
    cp = _doctor("replay", bundle)
    assert cp.returncode == 1 and "REPRODUCED" in cp.stdout, \
        cp.stdout + cp.stderr


def test_port_reads_a_jax_bundle(tmp_path):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[6], dtype="float32")
        loss = jfluid.layers.mean(x=jfluid.layers.fc(input=x, size=1))
        jfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    path = jrz.write_bundle(str(tmp_path), "manual", fault_class="hang",
                            step=4, program=main,
                            feed={"x": DATA[0]}, scope=scope)
    meta, program, feeds, state = rz.read_bundle(path)
    assert meta["fault_class"] == "hang" and meta["step"] == 4
    assert [op.type for op in program.global_block().ops] == \
        [op.type for op in main.global_block().ops]
    np.testing.assert_array_equal(feeds["x"], DATA[0])
    assert set(state) == set(scope.names())
