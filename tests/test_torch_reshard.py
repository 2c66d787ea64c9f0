"""Reshard-on-restore in the port (CheckpointManager.restore(layout=),
Supervisor(restore_layout=)), on CPU replica meshes (["cpu"] * n).

A snapshot written under an n-replica ZeRO ParallelExecutor restores onto
m replicas (m < n, m > n, m = n): every persistable equal bit for bit to
the source's global value, the sharded ones landing as per-replica pieces
with their recorded spec adapted to the target mesh, the seed cursor
back. A snapshot the JAX package wrote under its 8-device mesh restores
onto a port mesh with the JAX values bit for bit, and training continues
within the MLP tolerance of the JAX package's own continuation (rtol
1e-4, atol 1e-5: partial sums add in another order). A Supervisor with
restore_layout= rolls a guarded 2-replica run back onto its layout and
ends bit-equal to the uninterrupted run.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.checkpoint import CheckpointManager as JManager
from paddle_tpu.parallel import DeviceLayout as JLayout
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import resilience as rz
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.checkpoint import snapshot as snap
from paddle_tpu_torch.checkpoint.manager import _adapt_spec, _spec_to_json
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.core.sharded import ShardedValue
from paddle_tpu_torch.parallel import DeviceLayout, make_mesh, P

R = np.random.RandomState(11)
DATA = [R.rand(8, 6).astype("f") for _ in range(8)]
MLP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, dropout=True, guards=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 21
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="tanh")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.2)
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    if guards:
        rz.install_numeric_guards(main, loss=loss)
    return main, startup, loss


def _feed(i):
    return {"x": DATA[i % 8], "y": DATA[i % 8][:, :1]}


def _layout(n):
    return DeviceLayout(local_device_count=n, devices=["cpu"] * 8)


def _state(scope):
    return {n: to_numpy(scope.get(n)) for n in scope.names()
            if not hasattr(scope.get_raw(n), "next")}


def _train_and_snapshot(tmp, n, steps=3):
    main, startup, loss = _build(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(
            main_program=main, mesh=_layout(n).local_mesh(),
            sharded_weight_update=True)
        for i in range(steps):
            pexe.run([loss.name], feed=_feed(i))
    d = str(tmp / ("ckpt_n%d" % n))
    with CheckpointManager(d, async_save=False) as mgr:
        mgr.save(steps, program=main, scope=scope, layout=_layout(n))
    return d, _state(scope), scope.seed_state()


def _restored(d, layout, step=3):
    main, startup, loss = _build(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with CheckpointManager(d, async_save=False) as mgr:
        assert mgr.restore(program=main, scope=scope, step=step,
                           layout=layout) == step
    return scope


@pytest.mark.parametrize("m", [2, 8, 4])
def test_reshard_n4_to_m(tmp_path, m):
    d, want, cursor = _train_and_snapshot(tmp_path, 4)
    man = snap.load_manifest(snap.list_steps(d)[0][1])
    sharded = [n for n, e in man.items() if e.get("sharding")]
    assert any(n.startswith("moment") for n in sharded), sharded
    assert snap.read_snapshot_meta(snap.list_steps(d)[0][1])[
        "device_layout"]["local_device_count"] == 4
    scope = _restored(d, _layout(m))
    for n, v in want.items():
        np.testing.assert_array_equal(to_numpy(scope.get(n)), v, err_msg=n)
    for n in sharded:
        raw = scope.get_raw(n)
        shape = man[n]["shape"] if "shape" in man[n] else raw.shape
        if shape[0] % m == 0:
            assert isinstance(raw, ShardedValue) and raw.spec == ("dp",), n
            assert len(raw.pieces) == m
    assert scope.seed_state() == cursor


def test_reshard_same_shape_equals_plain_restore_and_trains_on(tmp_path):
    d, _, _ = _train_and_snapshot(tmp_path, 4)
    main, startup, loss = _build(tfluid)
    plain = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=plain)
    with CheckpointManager(d, async_save=False) as mgr:
        mgr.restore(program=main, scope=plain, step=3)
    laid = _restored(d, _layout(4))
    for n in plain.names():
        np.testing.assert_array_equal(to_numpy(plain.get(n)),
                                      to_numpy(laid.get(n)), err_msg=n)

    def continue_on_two(scope):
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(
                main_program=main, mesh=_layout(2).local_mesh(),
                sharded_weight_update=True)
            out = [pexe.run([loss.name], feed=_feed(i))[0]
                   for i in range(3, 6)]
        return out, _state(scope)

    la, sa = continue_on_two(_restored(d, _layout(2)))
    lb, sb = continue_on_two(_restored(d, _layout(2)))
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    for n in sa:
        np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)


def test_jax_snapshot_from_its_8_device_mesh_restores_on_port_mesh(
        tmp_path):
    jmain, jstartup, jloss = _build(jfluid, dropout=False)
    jscope = jfluid.Scope()
    d = str(tmp_path / "jax_ckpt")
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
        pexe = jfluid.ParallelExecutor(
            main_program=jmain, mesh=jmake_mesh({"dp": 8},
                                                jax.devices()[:8]),
            sharded_weight_update=True)
        for i in range(3):
            pexe.run([jloss.name], feed=_feed(i))
        mgr = JManager(d, async_save=False)
        mgr.save(3, program=jmain, scope=jscope,
                 layout=JLayout(local_device_count=8))
        mgr.close()
        jwant = {n: np.asarray(jscope.get(n)).copy() for n in jscope.names()}
        jcont = [np.asarray(pexe.run([jloss.name], feed=_feed(i))[0])
                 for i in range(3, 6)]
    man = snap.load_manifest(snap.list_steps(d)[0][1])
    assert any(e.get("sharding") for e in man.values())

    main, startup, loss = _build(tfluid, dropout=False)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with CheckpointManager(d, async_save=False) as mgr:
        assert mgr.restore(program=main, scope=scope,
                           layout=_layout(4)) == 3
    for n, v in jwant.items():
        np.testing.assert_array_equal(
            to_numpy(scope.get(n)).astype(v.dtype), v, err_msg=n)
    assert any(isinstance(scope.get_raw(n), ShardedValue)
               for n in scope.names())
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(
            main_program=main, mesh=_layout(4).local_mesh(),
            sharded_weight_update=True)
        cont = [pexe.run([loss.name], feed=_feed(i))[0]
                for i in range(3, 6)]
    np.testing.assert_allclose(np.ravel(cont), np.ravel(jcont), **MLP_TOL)


def test_adapt_spec_units_and_oversized_layout(tmp_path):
    mesh2 = make_mesh({"dp": 2}, ["cpu"] * 2)
    assert tuple(_adapt_spec(["dp", None], mesh2, (8, 3))) == ("dp", None)
    assert tuple(_adapt_spec(["mp", None], mesh2, (8, 3))) == (None, None)
    assert tuple(_adapt_spec(["dp"], mesh2, (7,))) == (None,)
    assert tuple(_adapt_spec([["dp", "mp"]], mesh2, (8,))) == ("dp",)
    assert tuple(_adapt_spec(None, mesh2, (4, 4))) == ()
    assert _spec_to_json(P("dp", None)) == ["dp", None]
    assert _spec_to_json(P(("dp", "mp"))) == [["dp", "mp"]]
    d, _, _ = _train_and_snapshot(tmp_path, 2)
    main, startup, loss = _build(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    before = _state(scope)
    with CheckpointManager(d, async_save=False) as mgr:
        with pytest.raises(ValueError, match="local devices"):
            mgr.restore(program=main, scope=scope, step=3,
                        layout=_layout(9))
    after = _state(scope)
    for n, v in before.items():
        np.testing.assert_array_equal(v, after[n])


def test_supervisor_restore_layout_rolls_back_onto_the_mesh(tmp_path):
    """A NaN batch under guards on a 2-replica ZeRO run: the supervisor
    rolls back onto its layout (the executor's plan), replays, and ends
    bit-equal to the uninterrupted run, its state still split."""
    def run(fault, ck):
        main, startup, loss = _build(tfluid, dropout=True, guards=True)
        scope = tfluid.Scope()
        tfluid.Executor("cpu").run(startup, scope=scope)
        scope._rng_counter = 0
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(
                main_program=main, mesh=_layout(2).local_mesh(),
                sharded_weight_update=True)
        mgr = CheckpointManager(ck, async_save=False)
        sup = rz.Supervisor(pexe, main, checkpoint_manager=mgr,
                            policies={"numeric": (rz.rollback(),)},
                            restore_layout=pexe.plan)
        plan = rz.FaultPlan(fault).arm() if fault else None
        try:
            sup.train(8, feed_fn=_feed, fetch_list=[loss],
                      checkpoint_every=2)
        finally:
            if plan:
                plan.disarm()
            sup.close()
            mgr.close()
        return scope, sup

    clean, _ = run(None, str(tmp_path / "a"))
    faulted, sup = run(["nan_feed@5"], str(tmp_path / "b"))
    assert any(e["action"] == "rollback" for e in sup.events), sup.events
    for n in clean.names():
        np.testing.assert_array_equal(to_numpy(faulted.get(n)),
                                      to_numpy(clean.get(n)), err_msg=n)
    split = [e.name for e in sup.exe.plan
             if e.kind != "gradient" and e.sharded]
    assert any(n.startswith("moment") for n in split)
    assert all(isinstance(faulted.get_raw(n), ShardedValue) for n in split)
