"""The port's checkpoint subsystem (paddle_tpu_torch.checkpoint, io's
checkpoint shims) against the JAX package's, on the CPU.

Mirrors tests/unittests/test_checkpoint_manager.py and
test_checkpoint_and_errors.py:
- bit-exact resume in the port: training straight through equals
  training K steps, restoring the step-K snapshot into a fresh scope and
  training on (params, optimizer moments, fetches), feed-fed under SGD and
  Adam with dropout (the seed cursor), reader-fed mid-epoch at steps 1
  and 4, plain and behind a double buffer, and dropout under steps=4;
- across packages: a snapshot the JAX package writes (an MLP, Adam, 3
  steps) restores in the port with equal values, and the next 3 steps
  stay within 1e-5 of the JAX package's next 3; the other way round too;
  the JAX package's `tools/ptpu_ckpt.py verify` passes on a port snapshot;
- failure handling: a PTPU_CKPT_FAULT_AT sweep of kill points (one
  subprocess each) never leaves an unloadable newest snapshot; a flipped
  byte and a corrupt snapshot.json are skipped; retention; a failed async
  save raised at the next save; backpressure and capture isolation; the
  io shims on old layouts and on empty or missing directories; optimizer
  accumulators tagged with their owners; layout= recording and
  resharding (tests/test_torch_reshard.py holds it across meshes) and
  validate raising naming A11.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.checkpoint import CheckpointManager as JManager

import paddle_tpu_torch as fluid
from paddle_tpu_torch.checkpoint import (CheckpointManager, RetentionPolicy,
                                         find_valid_snapshot, list_steps,
                                         load_manifest, verify_snapshot)
from paddle_tpu_torch.checkpoint import snapshot as snap
from paddle_tpu_torch.core.readers import ReaderBase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(f=fluid, optimizer="adam", dropout=False, seed=5):
    main, startup = f.Program(), f.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with f.unique_name.guard(), f.program_guard(main, startup):
        x = f.layers.data(name="x", shape=[6], dtype="float32")
        y = f.layers.data(name="y", shape=[1], dtype="float32")
        h = f.layers.fc(input=x, size=8, act="tanh")
        if dropout:
            h = f.layers.dropout(h, dropout_prob=0.3)
        p = f.layers.fc(input=h, size=1)
        loss = f.layers.mean(x=f.layers.square_error_cost(input=p, label=y))
        if optimizer == "adam":
            # a decaying LR: resume restores @LR_DECAY_COUNTER@ too
            lr = f.layers.exponential_decay(0.01, 4, 0.7)
            f.optimizer.Adam(learning_rate=lr).minimize(loss)
        else:
            f.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _exe():
    return fluid.Executor(fluid.CPUPlace())


def _persisted(scope):
    return {n: scope.get(n).numpy() for n in scope.names()
            if not isinstance(scope.get(n), ReaderBase)}


def _assert_state_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for n, va in a.items():
        np.testing.assert_array_equal(
            va, b[n], err_msg="state %r diverged after resume" % n)


def _batches(n=8, rows=16, seed=7):
    r = np.random.RandomState(seed)
    w = r.randn(6, 1).astype("f")
    return [(xb, xb @ w) for xb in
            (r.rand(rows, 6).astype("f") for _ in range(n))]


def _step(exe, main, loss, scope, xb, yb):
    return exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                   scope=scope)[0]


# ------------------------------------------------------ bit-exact resume --
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_bit_exact_resume_feed(tmp_path, optimizer):
    """Straight through vs stop at 4 + resume: identical params, optimizer
    state and fetches, with dropout in the graph (the seed cursor)."""
    data = _batches()
    main, startup, loss = _build(optimizer=optimizer, dropout=True)
    exe = _exe()
    scope_a = fluid.Scope()
    exe.run(startup, scope=scope_a)
    fetches_a = []
    for i, (xb, yb) in enumerate(data):
        if i == 4:
            with CheckpointManager(str(tmp_path)) as mgr:
                mgr.save(4, program=main, scope=scope_a).result(60)
        fetches_a.append(_step(exe, main, loss, scope_a, xb, yb))

    scope_b = fluid.Scope()
    exe.run(startup, scope=scope_b)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.restore(program=main, scope=scope_b, executor=exe) == 4
    fetches_b = [_step(exe, main, loss, scope_b, xb, yb)
                 for xb, yb in data[4:]]
    _assert_state_equal(_persisted(scope_a), _persisted(scope_b))
    for fa, fb in zip(fetches_a[4:], fetches_b):
        np.testing.assert_array_equal(fa, fb)
    assert scope_a.seed_state() == scope_b.seed_state()


def _reader_program(tmp_path, batches=16, double_buffer=False):
    def gen():
        r = np.random.RandomState(3)
        for _ in range(batches):
            xs = r.rand(4, 6).astype("float32")
            yield xs, xs[:, :1].copy()

    path = str(tmp_path / "data.recordio")
    fluid.recordio_writer.convert_reader_to_recordio_file(path, gen)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        rdr = fluid.layers.open_recordio_file(
            filename=path, shapes=[[-1, 6], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "float32"])
        if double_buffer:
            # a decorator chain: only the outermost reader is recorded,
            # the recordio reader replays through it
            rdr = fluid.layers.double_buffer(rdr)
        x, y = fluid.layers.read_file(rdr)
        h = fluid.layers.fc(input=x, size=8, act="tanh")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss, rdr


@pytest.mark.parametrize("steps_k,double_buffer",
                         [(1, False), (4, False), (1, True), (4, True)])
def test_bit_exact_resume_reader_mid_epoch(tmp_path, steps_k,
                                           double_buffer):
    """Reader-fed training checkpointed mid-epoch: the resumed run
    consumes exactly the records the straight run would have."""
    main, startup, loss, rdr = _reader_program(
        tmp_path, double_buffer=double_buffer)
    exe = _exe()
    ck = str(tmp_path / "ck")
    total_calls = 12 // steps_k if steps_k > 1 else 10
    split = total_calls // 2
    run_kw = {"steps": steps_k} if steps_k > 1 else {}

    scope_a = fluid.Scope()
    exe.run(startup, scope=scope_a)
    fetches_a = []
    for i in range(total_calls):
        if i == split:
            with CheckpointManager(ck, async_save=False) as mgr:
                mgr.save(split, program=main, scope=scope_a)
            at_split = scope_a.get(rdr.name).state_dict()
        fetches_a.append(exe.run(main, fetch_list=[loss], scope=scope_a,
                                 **run_kw)[0])

    scope_b = fluid.Scope()
    exe.run(startup, scope=scope_b)  # fresh readers at position 0
    with CheckpointManager(ck) as mgr:
        assert mgr.restore(program=main, scope=scope_b,
                           executor=exe) == split
    assert scope_b.get(rdr.name).state_dict() == at_split
    assert at_split["consumed"] == split * steps_k
    fetches_b = [exe.run(main, fetch_list=[loss], scope=scope_b,
                         **run_kw)[0] for _ in range(total_calls - split)]
    _assert_state_equal(_persisted(scope_a), _persisted(scope_b))
    for fa, fb in zip(fetches_a[split:], fetches_b):
        np.testing.assert_array_equal(fa, fb)
    for s in (scope_a, scope_b):
        s.get(rdr.name).close()


def test_restore_skip_records_routes_the_reader_past_records(tmp_path):
    """restore(skip_records=3) replays the recorded position, then
    discards 3 records more; the next record is the one the straight run
    read 3 calls later."""
    main, startup, loss, rdr = _reader_program(tmp_path)
    x = next(v for v in main.list_vars() if v.name.startswith("read_file"))
    exe = _exe()
    scope_a = fluid.Scope()
    exe.run(startup, scope=scope_a)
    exe.run(main, fetch_list=[loss], scope=scope_a)
    with CheckpointManager(str(tmp_path / "ck"), async_save=False) as mgr:
        mgr.save(1, program=main, scope=scope_a)
    seen = [exe.run(main, fetch_list=[x], scope=scope_a)[0]
            for _ in range(4)]
    scope_b = fluid.Scope()
    exe.run(startup, scope=scope_b)
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        assert mgr.restore(program=main, scope=scope_b, executor=exe,
                           skip_records=3) == 1
    assert scope_b.get(rdr.name).state_dict()["consumed"] == 4
    np.testing.assert_array_equal(
        exe.run(main, fetch_list=[x], scope=scope_b)[0], seen[3])


def test_bit_exact_resume_dropout_seed_cursor_steps_k(tmp_path):
    """Dropout under steps=4 (the feed replays every step, each step
    drawing its own mask): the restored seed cursor replays the masks of
    the straight run's calls 2 and 3 bit for bit; moved, they differ."""
    (xs, ys), = _batches(n=1, rows=8, seed=11)
    main, startup, loss = _build(optimizer="adam", dropout=True)
    exe = _exe()

    def call(scope):
        return exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                       scope=scope, steps=4)[0]

    scope_a = fluid.Scope()
    exe.run(startup, scope=scope_a)
    call(scope_a)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(4, program=main, scope=scope_a)
    want = [call(scope_a), call(scope_a)]

    scope_b = fluid.Scope()
    exe.run(startup, scope=scope_b)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.restore(program=main, scope=scope_b, executor=exe) == 4
    got = [call(scope_b), call(scope_b)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    _assert_state_equal(_persisted(scope_a), _persisted(scope_b))

    # the cursor is load-bearing: restored with it moved, the masks differ
    scope_c = fluid.Scope()
    exe.run(startup, scope=scope_c)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.restore(program=main, scope=scope_c, executor=exe)
    scope_c.set_seed_state(scope_c.seed_state() + 1)
    assert not np.array_equal(call(scope_c), want[0])


# --------------------------------------------------------- cross-package --
def _jax_steps(main, loss, scope, data):
    exe = jfluid.Executor(jfluid.CPUPlace())
    out = []
    with jfluid.scope_guard(scope):
        for xb, yb in data:
            out.append(np.asarray(exe.run(
                main, feed={"x": xb, "y": yb}, fetch_list=[loss])[0]))
    return out


def test_jax_snapshot_restores_in_the_port(tmp_path):
    data = _batches(n=6, rows=8, seed=21)
    jmain, jstartup, jloss = _build(jfluid, "adam")
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    _jax_steps(jmain, jloss, jscope, data[:3])
    with JManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(3, program=jmain, scope=jscope)

    main, startup, loss = _build(fluid, "adam")
    exe = _exe()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.restore(program=main, scope=scope, executor=exe) == 3
    declared = {v.name: v.dtype for v in main.list_vars() if v.persistable}
    from paddle_tpu_torch.core.framework import convert_dtype
    from paddle_tpu_torch.core.registry import torch_dtype
    for name, arr in snap.load_verified_arrays(
            str(tmp_path / "step_3")).items():
        got = scope.get(name)
        # values equal; dtypes the port declares (the JAX int32 counter
        # comes back int64)
        assert got.dtype == torch_dtype(convert_dtype(declared[name])), name
        np.testing.assert_array_equal(got.numpy(), arr.astype(
            got.numpy().dtype), err_msg=name)
    want = _jax_steps(jmain, jloss, jscope, data[3:])
    got = [_step(exe, main, loss, scope, xb, yb) for xb, yb in data[3:]]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               **TOL)
    with jfluid.scope_guard(jscope):
        for name in declared:
            np.testing.assert_allclose(
                scope.get(name).numpy(), np.asarray(jscope.get(name)),
                err_msg=name, **TOL)


def test_port_snapshot_restores_in_the_jax_package(tmp_path):
    data = _batches(n=6, rows=8, seed=23)
    main, startup, loss = _build(fluid, "adam")
    exe = _exe()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for xb, yb in data[:3]:
        _step(exe, main, loss, scope, xb, yb)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(3, program=main, scope=scope)
    at_save = _persisted(scope)

    jmain, jstartup, jloss = _build(jfluid, "adam")
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        with JManager(str(tmp_path)) as mgr:
            assert mgr.restore(program=jmain, scope=jscope) == 3
        for name, want in at_save.items():
            np.testing.assert_array_equal(
                np.asarray(jscope.get(name)).astype(want.dtype), want,
                err_msg=name)
    want = [_step(exe, main, loss, scope, xb, yb) for xb, yb in data[3:]]
    got = _jax_steps(jmain, jloss, jscope, data[3:])
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               **TOL)


def test_ptpu_ckpt_verify_and_inspect_a_port_snapshot(tmp_path):
    main, startup, loss = _build(fluid, "adam")
    exe = _exe()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ck = str(tmp_path / "ck")
    with CheckpointManager(ck, async_save=False) as mgr:
        for s, (xb, yb) in enumerate(_batches(n=2, rows=4), 1):
            _step(exe, main, loss, scope, xb, yb)
            mgr.save(s, program=main, scope=scope)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.pop("PTPU_CKPT_FAULT_AT", None)

    def run(*args):
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "ptpu_ckpt.py")]
            + list(args), env=env, capture_output=True, text=True,
            timeout=300)

    cp = run("verify", ck)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    cp = run("inspect", ck, "--json")
    assert cp.returncode == 0, cp.stderr
    rec = json.loads(cp.stdout)
    assert rec["step"] == 2 and rec["seed_cursor"] == scope.seed_state()
    assert any(e.get("owner") for e in rec["vars"].values())


# ------------------------------------------------------------ torn write --
_VICTIM = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, %(repo)r)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.checkpoint import CheckpointManager
    d = sys.argv[1]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        p = fluid.layers.fc(input=x, size=1, bias_attr=False)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xb = np.random.RandomState(0).rand(4, 4).astype("f")
    feed = {"x": xb, "y": xb[:, :1]}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    mgr = CheckpointManager(d)               # the async writer thread
    mgr.save(1, program=main, scope=scope).result(60)   # known good
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    os.environ["PTPU_CKPT_FAULT_AT"] = sys.argv[2]   # arm the kill
    mgr.save(2, program=main, scope=scope).result(60)
    mgr.close()
    print("SURVIVED")
""")


def test_torn_write_never_corrupts_latest(tmp_path):
    """kill -9 at every injection point of the write protocol (one
    subprocess each, four at a time): restore always finds a valid
    snapshot, the old one before the publishing rename and the new one
    after; the point past the last crossing survives."""
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM % {"repo": REPO})
    env = dict(os.environ)
    env.pop("PTPU_CKPT_FAULT_AT", None)
    results = {}
    points = list(range(12))
    for lo in range(0, len(points), 4):
        procs = {n: subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / ("ck%d" % n)),
             str(n)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for n in points[lo:lo + 4]}
        for n, p in procs.items():
            out, err = p.communicate(timeout=300)
            results[n] = (p.returncode, out, err)
    saw_old = saw_new = False
    survived = None
    for n in points:
        rc, out, err = results[n]
        found = find_valid_snapshot(str(tmp_path / ("ck%d" % n)))
        assert found is not None, "fault@%d left no loadable snapshot: " \
            "%s%s" % (n, out, err)
        step, path = found
        assert not verify_snapshot(path) and step in (1, 2)
        if rc == -9:
            assert survived is None, "a kill point after a survivor"
            saw_old |= step == 1
            saw_new |= step == 2
        else:
            assert rc == 0 and "SURVIVED" in out, out + err
            assert step == 2
            survived = n if survived is None else survived
    assert survived is not None, "the sweep never passed the last kill"
    assert saw_old and saw_new


# --------------------------------------------------- retention + hashes --
def _trained(seed=1, optimizer="sgd"):
    main, startup, loss = _build(optimizer=optimizer)
    exe = _exe()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xb = np.random.RandomState(seed).rand(4, 6).astype("f")
    _step(exe, main, loss, scope, xb, xb[:, :1])
    return main, startup, loss, exe, scope, xb


def test_retention_policy_and_gc(tmp_path):
    main, _, _, _, scope, _ = _trained()
    with CheckpointManager(str(tmp_path), max_to_keep=2,
                           keep_every_n_steps=4, async_save=False) as mgr:
        for s in range(1, 11):
            mgr.save(s, program=main, scope=scope)
        assert mgr.steps() == [4, 8, 9, 10]  # newest 2 plus every 4th
    pol = RetentionPolicy(max_to_keep=3)
    assert pol.to_delete([1, 2, 3, 4, 5]) == [1, 2]
    assert pol.to_delete([1, 2, 3, 4, 5], protect=(1,)) == [2]
    assert RetentionPolicy(max_to_keep=None).to_delete(range(100)) == []


def _flip_last_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_bit_flip_detected_and_skipped(tmp_path):
    main, startup, loss, exe, scope, xb = _trained(2)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, program=main, scope=scope)
        _step(exe, main, loss, scope, xb, xb[:, :1])
        mgr.save(2, program=main, scope=scope)
    victim = next(e["file"] for e in load_manifest(
        str(tmp_path / "step_2")).values() if e.get("is_param"))
    _flip_last_byte(str(tmp_path / "step_2" / victim))
    problems = verify_snapshot(str(tmp_path / "step_2"))
    assert problems and "hash mismatch" in problems[0]
    scope2 = fluid.Scope()
    exe.run(startup, scope=scope2)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.latest_step() == 1
        assert mgr.restore(program=main, scope=scope2, executor=exe) == 1
        for pinned in (2, 99):  # a pinned corrupt or missing step raises
            with pytest.raises(ValueError, match="pinned step_%d" % pinned):
                mgr.restore(program=main, scope=scope2, step=pinned)


def test_corrupt_snapshot_json_is_skipped_not_crash(tmp_path):
    main, startup, _, exe, scope, _ = _trained(11)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, program=main, scope=scope)
    (tmp_path / "step_4" / "snapshot.json").write_text("{ torn json")
    assert "snapshot.json" in verify_snapshot(str(tmp_path / "step_4"))[0]
    spath = tmp_path / "step_3" / "snapshot.json"
    meta = json.loads(spath.read_text())
    meta["seed_cursor"] += 1  # still valid JSON: the self-hash catches it
    spath.write_text(json.dumps(meta, indent=1, sort_keys=True))
    assert "content hash" in verify_snapshot(str(tmp_path / "step_3"))[0]
    (tmp_path / "step_2" / "snapshot.json").unlink()
    assert "missing its snapshot.json" in verify_snapshot(
        str(tmp_path / "step_2"))[0]
    scope2 = fluid.Scope()
    exe.run(startup, scope=scope2)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.restore(program=main, scope=scope2, executor=exe) == 1


def test_failed_async_save_raises_at_next_save(tmp_path, monkeypatch):
    """An unobserved background failure surfaces at the NEXT save(), and
    finished handles are pruned so _pending stays bounded."""
    import time
    from paddle_tpu_torch.checkpoint import manager
    main, _, _, _, scope, _ = _trained(13)
    write = manager._snap.write_snapshot

    def failing_write(d, step, *a, **kw):
        if step == 6:
            raise OSError("disk full at step 6")
        return write(d, step, *a, **kw)
    with CheckpointManager(str(tmp_path)) as mgr:
        for s in (1, 2, 3):
            mgr.save(s, program=main, scope=scope)
        mgr.wait()
        assert mgr._pending == []
        mgr.save(4, program=main, scope=scope).result(60)
        mgr.save(5, program=main, scope=scope).result(60)
        assert len(mgr._pending) <= 1
        monkeypatch.setattr(manager._snap, "write_snapshot", failing_write)
        bad = mgr.save(6, program=main, scope=scope)
        for _ in range(200):
            if bad.done():
                break
            time.sleep(0.05)
        assert isinstance(bad.exception(), OSError)
        with pytest.raises(OSError, match="disk full at step 6"):
            mgr.save(7, program=main, scope=scope)
        assert mgr._pending == []  # the failed handle consumed, 7 not queued
    assert [s for s, _ in list_steps(str(tmp_path))] == [1, 2, 3, 4, 5]


def test_async_save_backpressure_and_capture_isolation(tmp_path):
    """What save() captured is what lands on disk although training goes
    on mutating the scope; with max_in_flight=1 a second save waits for
    the first."""
    main, _, loss, exe, scope, _ = _trained(6)
    xb = np.random.RandomState(6).rand(16, 6).astype("f")
    param = main.all_parameters()[0].name
    with CheckpointManager(str(tmp_path), max_in_flight=1) as mgr:
        at_save = scope.get(param).numpy().copy()
        h = mgr.save(1, program=main, scope=scope)
        for _ in range(5):
            _step(exe, main, loss, scope, xb, xb[:, :1])
        h2 = mgr.save(2, program=main, scope=scope)
        assert h.done()        # the budget of one made save(2) wait
        path = h.result(60)
        h2.result(60)
        assert h.write_seconds is not None and h.bytes_written > 0
        assert h.capture_seconds is not None
    entry = load_manifest(path)[param]
    np.testing.assert_array_equal(
        np.load(os.path.join(path, entry["file"])), at_save)
    assert not np.array_equal(scope.get(param).numpy(), at_save)


def test_manifest_tags_accumulator_owners(tmp_path):
    main, _, _, _, scope, _ = _trained(5, optimizer="adam")
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, program=main, scope=scope)
    manifest = load_manifest(str(tmp_path / "step_1"))
    params = [n for n, e in manifest.items() if e.get("is_param")]
    moments = {n: e for n, e in manifest.items()
               if n.startswith(("moment1_", "moment2_"))}
    assert len(moments) == 2 * len(params)
    assert all(e.get("owner") in params for e in moments.values())
    betas = {n: e for n, e in manifest.items()
             if n.startswith(("beta1_pow", "beta2_pow"))}
    assert betas and all(e.get("owner") == "" for e in betas.values())


# -------------------------------------------------------------- io shims --
def test_io_shims_on_old_layouts(tmp_path):
    """load_checkpoint on the pre-manager layout (save_persistables into
    step dirs, no snapshot.json, no LATEST) loads the newest complete
    snapshot; a stale LATEST does not mislead it; a torn old dir is
    skipped; save_checkpoint writes a snapshot load_checkpoint restores."""
    main, startup, loss, exe, scope, xb = _trained(3)
    fluid.io.save_persistables(exe, str(tmp_path / "step_3"), main,
                               scope=scope)
    _step(exe, main, loss, scope, xb, xb[:, :1])
    fluid.io.save_persistables(exe, str(tmp_path / "step_7"), main,
                               scope=scope)
    want = _persisted(scope)

    def load(d):
        s = fluid.Scope()
        exe.run(startup, scope=s)
        return fluid.io.load_checkpoint(exe, str(d), main, scope=s), s

    step, s2 = load(tmp_path)
    assert step == 7
    _assert_state_equal(want, {n: s2.get(n).numpy() for n in want})
    (tmp_path / "LATEST").write_text("99")
    assert load(tmp_path)[0] == 7
    m = load_manifest(str(tmp_path / "step_7"))
    os.remove(str(tmp_path / "step_7" / next(iter(m.values()))["file"]))
    assert load(tmp_path)[0] == 3

    ck = tmp_path / "shim"
    fluid.io.save_checkpoint(exe, str(ck), main, step=5, scope=scope,
                             max_to_keep=1)
    fluid.io.save_checkpoint(exe, str(ck), main, step=6, scope=scope,
                             max_to_keep=1)
    assert [s for s, _ in list_steps(str(ck))] == [6]
    step, s3 = load(ck)
    assert step == 6
    _assert_state_equal(want, {n: s3.get(n).numpy() for n in want})


def test_io_shims_on_empty_and_missing_dirs(tmp_path):
    main, startup, _, exe, scope, _ = _trained(4)
    assert fluid.io.load_checkpoint(exe, str(tmp_path), main,
                                    scope=scope) is None
    assert fluid.io.load_checkpoint(exe, str(tmp_path / "nope"), main,
                                    scope=scope) is None


def test_restore_places_values_and_refuses_missing_state(tmp_path):
    """Restored values are tensors on the executor's device in the declared
    dtypes, never numpy; a snapshot missing a persistable raises before
    anything lands, unless allow_missing."""
    main, startup, _, exe, scope, _ = _trained(8, optimizer="adam")
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, program=main, scope=scope)
    scope2 = fluid.Scope()
    exe.run(startup, scope=scope2)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.restore(program=main, scope=scope2, executor=exe)
    for v in main.list_vars():
        if v.persistable:
            t = scope2.get(v.name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.dtype == scope.get(v.name).dtype, v.name
    # a snapshot that verifies but lacks one of the program's vars
    sub = [v for v in main.list_vars() if v.persistable
           and v.name != "moment1_fc_0.w_0_0"]
    part = fluid.Program()
    for v in sub:
        part.global_block().create_var(
            name=v.name, shape=v.shape, dtype=v.dtype, persistable=True)
    with CheckpointManager(str(tmp_path / "part"), async_save=False) as mgr:
        mgr.save(1, program=part, scope=scope)
        before = scope2.get("fc_0.w_0").numpy().copy()
        with pytest.raises(RuntimeError, match="moment1_fc_0.w_0_0"):
            mgr.restore(program=main, scope=scope2)
        np.testing.assert_array_equal(scope2.get("fc_0.w_0").numpy(),
                                      before)
        assert mgr.restore(program=main, scope=scope2,
                           allow_missing=True) == 1


def test_layout_and_validate_raise_naming_their_slices(tmp_path,
                                                       monkeypatch):
    main, _, _, _, scope, _ = _trained(9)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        # layout= reshards: save records a DeviceLayout and refuses
        # anything else; restore takes a device count too
        with pytest.raises(TypeError, match="DeviceLayout"):
            mgr.save(1, program=main, scope=scope, layout=1)
        mgr.save(1, program=main, scope=scope,
                 layout=fluid.parallel.DeviceLayout(
                     local_device_count=1, devices=["cpu"]))
        assert mgr.restore(program=main, scope=scope, layout=1) == 1
        with pytest.raises(ValueError, match="local devices"):
            mgr.restore(program=main, scope=scope, layout=2)
        monkeypatch.setenv("FLAGS_validate_program", "1")
        with pytest.raises(NotImplementedError, match="A11"):
            mgr.save(2, program=main, scope=scope)
    with pytest.raises(NotImplementedError, match="A11"):
        CheckpointManager(str(tmp_path), validate=True)
    assert find_valid_snapshot(str(tmp_path))[0] == 1


def test_spans_and_registry_families(tmp_path):
    """A save records its checkpoint/capture and checkpoint/write spans
    and feeds ptpu_checkpoint_save_seconds / ptpu_checkpoint_saves_total;
    a failed write counts under status="error"."""
    from paddle_tpu_torch.checkpoint import manager
    from paddle_tpu_torch.observability import REGISTRY, trace
    main, _, _, _, scope, _ = _trained(14)
    saves = REGISTRY.counter("ptpu_checkpoint_saves_total")
    seconds = REGISTRY.histogram("ptpu_checkpoint_save_seconds")
    ok0, err0 = saves.value(status="ok"), saves.value(status="error")
    n0 = seconds.count()
    trace.clear()
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, program=main, scope=scope)
        write = manager._snap.write_snapshot
        try:
            manager._snap.write_snapshot = _raise_oserror
            with pytest.raises(OSError):
                mgr.save(2, program=main, scope=scope)
        finally:
            manager._snap.write_snapshot = write
    names = [ev["name"] for ev in trace.dump(include_open=False)["events"]]
    assert names.count("checkpoint/capture") == 2
    assert names.count("checkpoint/write") == 2
    assert saves.value(status="ok") == ok0 + 1
    assert saves.value(status="error") == err0 + 1
    assert seconds.count() == n0 + 1
    text = REGISTRY.render_prometheus()
    assert "ptpu_checkpoint_saves_total" in text
    assert "ptpu_checkpoint_save_seconds" in text


def _raise_oserror(*args, **kwargs):
    raise OSError("no space left on device")
