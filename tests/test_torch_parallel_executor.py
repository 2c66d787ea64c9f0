"""The port's ParallelExecutor on an 8-replica CPU mesh (["cpu"] * 8),
against the JAX package's on its 8 virtual devices and against the port's
own single-device Executor.

Cases of tests/unittests/test_parallel_executor.py, test_sharded_plan.py
and test_tp_plan.py. Both packages start from the JAX package's startup
state, carried over by name (io.scope_from_numpy), and train on the same
numpy batches. Tolerances are the JAX tests' own: the MLP's losses and
weights within rtol 1e-4 / atol 1e-5 of the other package (the partial
sums of a replicated gradient add in another order), the LoD GRU within
1e-5 / 1e-6, ZeRO and "gather" tensor parallelism within 1e-5 / 1e-6 of
the replicated run. Inside the port, a 1-replica mesh is bit-equal to the
Executor, steps=K to K steps=1 calls, and dropout's mask to the
1-replica run's (a random op draws the single-device bits).
"""
import time

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as rz
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from paddle_tpu_torch.core.lowering import GraphCaptureError
from paddle_tpu_torch.core.sharded import ShardedValue
from paddle_tpu_torch.parallel import ShardingPlan, make_mesh, P
from paddle_tpu_torch.parallel.parallel_executor import \
    ParallelPlacementError

MLP_TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT_TOL = dict(rtol=1e-5, atol=1e-6)
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(fluid, seed=33, opt="momentum", width=32, dropout=False,
         mesh_axes=None, dim=16):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[dim], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        attr = fluid.ParamAttr(name="tp.w", mesh_axes=mesh_axes) \
            if mesh_axes else None
        h = fluid.layers.fc(input=x, size=width, act="relu",
                            param_attr=attr)
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.2)
        h = fluid.layers.fc(input=h, size=width, act="tanh")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        if opt == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
        elif opt == "adam_decay":
            lr = fluid.layers.exponential_decay(0.01, 2, 0.9)
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        else:
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _data(n=64, dim=16, seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, dim).astype("float32")
    return {"x": xs, "y": (xs.sum(1, keepdims=True) * 0.1).astype("f")}


def _jax_init(build, **kw):
    """The JAX package's startup state of `build(jfluid)`."""
    main, startup, loss = build(jfluid, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.get(n)) for n in scope.names()
            if scope.get(n) is not None}


def _jax_pexe(build, init, feeds, steps, mesh_axes=None, **pkw):
    main, startup, loss = build(jfluid)
    scope = jfluid.Scope()
    for n, v in init.items():
        scope.set(n, v)
    with jfluid.scope_guard(scope):
        kw = dict(pkw)
        if mesh_axes:
            kw["mesh"] = jmake_mesh(mesh_axes, jax.devices()[:8])
        pexe = jfluid.ParallelExecutor(main_program=main,
                                       loss_name=loss.name, **kw)
        losses = [np.asarray(pexe.run(fetch_list=[loss], feed=f)[0])
                  for f in feeds[:steps]]
    return losses, {n: np.asarray(scope.get(n)) for n in scope.names()}


def _port_pexe(build, init, feeds, steps, mesh_axes=None, devices=CPU8,
               **pkw):
    main, startup, loss = build(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    with tfluid.scope_guard(scope):
        kw = dict(pkw)
        if mesh_axes:
            kw["mesh"] = make_mesh(mesh_axes, devices)
        else:
            kw["devices"] = devices
        pexe = tfluid.ParallelExecutor(main_program=main,
                                       loss_name=loss.name, **kw)
        losses = [pexe.run(fetch_list=[loss], feed=f)[0]
                  for f in feeds[:steps]]
    return losses, {n: to_numpy(scope.get(n)) for n in scope.names()}, \
        scope, pexe


def _port_exe(build, init, feeds, steps):
    main, startup, loss = build(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    exe = tfluid.Executor("cpu")
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in feeds[:steps]]
    return losses, {n: to_numpy(scope.get(n)) for n in scope.names()}


def _close(a, b, tol, names=None):
    for n in (names if names is not None else sorted(a)):
        np.testing.assert_allclose(np.asarray(b[n], np.float64).reshape(-1),
                                   np.asarray(a[n], np.float64).reshape(-1),
                                   err_msg=n, **tol)


def test_mlp_momentum_matches_jax_parallel_executor():
    init = _jax_init(_mlp)
    feeds = [_data(seed=s) for s in range(5)]
    jl, js = _jax_pexe(_mlp, init, feeds, 5)
    tl, ts, scope, pexe = _port_pexe(_mlp, init, feeds, 5)
    assert pexe.device_count == 8 and pexe.last_transport == "torch"
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), **MLP_TOL)
    _close(js, ts, MLP_TOL, names=[n for n in js if n in ts])
    # and the port's own single-device run: the same global batch
    el, es = _port_exe(_mlp, init, feeds, 5)
    np.testing.assert_allclose(np.ravel(tl), np.ravel(el), **MLP_TOL)
    _close(es, ts, MLP_TOL)


PLACEMENTS = {
    "zero": (dict(opt="adam"), None, {"sharded_weight_update": True}),
    "tp_gather": (dict(opt="adam"), {"dp": 2, "tp": 4}, {"tp_axis": "tp"}),
    "tp_annotation": (dict(opt="momentum", mesh_axes=(None, "mp")),
                      {"dp": 2, "mp": 4}, {}),
}


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_sharded_placements_match_jax_and_replicated(case):
    bkw, axes, pkw = PLACEMENTS[case]

    def build(f):
        return _mlp(f, **bkw)

    init = _jax_init(build)
    feeds = [_data(seed=s) for s in range(4)]
    jl, js = _jax_pexe(build, init, feeds, 4, mesh_axes=axes, **pkw)
    tl, ts, scope, pexe = _port_pexe(build, init, feeds, 4,
                                     mesh_axes=axes, **pkw)
    sharded = [e.name for e in pexe.plan if e.kind != "gradient"
               and e.sharded]
    assert sharded
    for n in sharded:
        assert isinstance(scope.get_raw(n), ShardedValue), n
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), **MLP_TOL)
    _close(js, ts, MLP_TOL, names=[n for n in js if n in ts])
    # against the port's replicated run on the same mesh
    rl, rs, _, _ = _port_pexe(build, init, feeds, 4, mesh_axes=axes)
    np.testing.assert_allclose(np.ravel(tl), np.ravel(rl), **TIGHT_TOL)
    _close(rs, ts, TIGHT_TOL)


def _gru(fluid, seed=5, d=6):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[d], dtype="float32",
                              lod_level=1)
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        fc1 = fluid.layers.fc(input=x, size=24, num_flatten_dims=2)
        h = fluid.layers.dynamic_gru(fc1, size=8)
        last = fluid.layers.sequence_pool(input=h, pool_type="last")
        logits = fluid.layers.fc(input=last, size=3)
        loss = fluid.layers.mean(x=fluid.layers.cross_entropy(
            input=fluid.layers.softmax(logits), label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_lod_gru_feeds_match_jax_parallel_executor():
    rng = np.random.RandomState(12)
    seqs = [rng.randn(n, 6).astype("f") * 0.5
            for n in (3, 5, 2, 4, 1, 5, 3, 2)]
    labels = rng.randint(0, 3, (8, 1)).astype("int64")
    init = _jax_init(_gru)
    jfeeds = [{"x": JLoD.from_sequences(seqs), "y": labels}] * 3
    tfeeds = [{"x": TLoD.from_sequences(seqs), "y": labels}] * 3
    jl, js = _jax_pexe(_gru, init, jfeeds, 3)
    tl, ts, _, _ = _port_pexe(_gru, init, tfeeds, 3)
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), **TIGHT_TOL)
    _close(js, ts, TIGHT_TOL, names=[n for n in js if n in ts])


def test_batch_not_divisible_and_fixed_leading_dim_feed():
    main, startup, loss = _mlp(tfluid, seed=7)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(main_program=main, devices=CPU8)
    with pytest.raises(ValueError, match="divide evenly"):
        pexe.run(fetch_list=[loss], feed={"x": np.ones((13, 16), "f"),
                                          "y": np.ones((13, 1), "f")})
    # a [10] side input on 8 replicas replicates instead of splitting
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        tab = tfluid.layers.data(name="tab", shape=[10],
                                 append_batch_size=False, dtype="float32")
        h = tfluid.layers.fc(input=x, size=10)
        out = tfluid.layers.mean(
            tfluid.layers.elementwise_mul(x=h, y=tab, axis=1))
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).rand(16, 16).astype("f"),
            "tab": np.arange(10, dtype="f")}
    with tfluid.scope_guard(scope):
        got, = tfluid.ParallelExecutor(main_program=main,
                                       devices=CPU8).run([out], feed=feed)
    ref, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, ref, **TIGHT_TOL)


def test_use_cuda_false_takes_the_cpu_once():
    init = _jax_init(_mlp)
    main, startup, loss = _mlp(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                       loss_name=loss.name)
        got, = pexe.run([loss], feed=_data())
    assert pexe.device_count == 1 and str(pexe.lead_device) == "cpu"
    ref, _ = _port_exe(_mlp, init, [_data()], 1)
    np.testing.assert_array_equal(got, ref[0])


def _conv_bn(fluid, seed=11):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 8, 8],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   padding=1, act="relu")
        bn = fluid.layers.batch_norm(input=conv)
        pred = fluid.layers.fc(input=bn, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        acc = fluid.layers.accuracy(input=pred, label=label)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss, acc


def test_batch_norm_global_statistics_and_global_accuracy():
    """batch_norm's training statistics and accuracy are the global
    batch's: the 8-replica run equals the single-device one."""
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(16, 1, 8, 8).astype("f"),
            "label": rng.randint(0, 10, (16, 1)).astype("int64")}
    main, startup, loss, acc = _conv_bn(tfluid)
    exe = tfluid.Executor("cpu")
    s1 = tfluid.Scope()
    exe.run(startup, scope=s1)
    s2 = tfluid.Scope()
    for n in s1.names():
        s2.set(n, s1.get(n).clone())
    ref = [exe.run(main, feed=feed, fetch_list=[loss, acc], scope=s1)
           for _ in range(3)]
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(main_program=main, devices=CPU8)
        got = [pexe.run([loss, acc], feed=feed) for _ in range(3)]
    for (rl, ra), (gl, ga) in zip(ref, got):
        np.testing.assert_allclose(gl, rl, **MLP_TOL)
        np.testing.assert_array_equal(ga, ra)
    stats = [n for n in s1.names() if "batch_norm" in n]
    assert stats
    for n in s1.names():
        np.testing.assert_allclose(to_numpy(s2.get(n)), to_numpy(s1.get(n)),
                                   err_msg=n, **MLP_TOL)


def test_dropout_mask_bit_equal_to_one_replica_run():
    init = _jax_init(_mlp, dropout=True)
    feed = _data()
    masks = []
    for devices in (CPU8, ["cpu"]):
        main, startup, loss = _mlp(tfluid, dropout=True)
        mask = next(op.outputs["Mask"][0]
                    for op in main.global_block().ops
                    if op.type == "dropout")
        scope = tio.scope_from_numpy(init, "cpu", program=main)
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(main_program=main,
                                           devices=devices)
            masks.append([pexe.run([loss, mask], feed=feed)[1]
                          for _ in range(2)])
    for a, b in zip(*masks):
        np.testing.assert_array_equal(a, b)
    assert 0.6 < masks[0][0].mean() < 0.95


@pytest.mark.parametrize("opt", ["momentum", "adam_decay"])
def test_one_replica_mesh_bit_exact_vs_executor(opt):
    """A mesh of one replica, ZeRO armed (every spec degenerates): bit for
    bit the Executor, at steps=1 and steps=3."""
    def build(f):
        return _mlp(f, opt=opt, dropout=True)

    init = _jax_init(build)
    feed = _data(n=16)
    main, startup, loss = build(tfluid)
    exe = tfluid.Executor("cpu")
    s1 = tio.scope_from_numpy(init, "cpu", program=main)
    ref = [exe.run(main, feed=feed, fetch_list=[loss], scope=s1)[0]
           for _ in range(6)]
    s2 = tio.scope_from_numpy(init, "cpu", program=main)
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(main_program=main, devices=["cpu"],
                                       sharded_weight_update=True)
        assert not any(e.sharded for e in pexe.plan)
        got = [pexe.run([loss], feed=feed)[0] for _ in range(3)]
        got += list(pexe.run([loss], feed=feed, steps=3)[0])
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.ravel(a), np.ravel(b))
    for n in s1.names():
        assert torch.equal(s1.get(n), s2.get(n)), n


def test_steps_k_matches_k_calls_with_fetch_reduce():
    init = _jax_init(_mlp, opt="adam")
    feed = _data()
    out = {}
    for mode in ("seq", "stack", "mean", "last"):
        main, startup, loss = _mlp(tfluid, opt="adam")
        scope = tio.scope_from_numpy(init, "cpu", program=main)
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(main_program=main, devices=CPU8,
                                           sharded_weight_update=True)
            if mode == "seq":
                v = np.stack([pexe.run([loss], feed=feed)[0]
                              for _ in range(4)])
            else:
                v = pexe.run([loss], feed=feed, steps=4,
                             fetch_reduce=mode)[0]
        out[mode] = (v, {n: to_numpy(scope.get(n)) for n in scope.names()})
    seq, seq_state = out["seq"]
    np.testing.assert_array_equal(out["stack"][0], seq)
    np.testing.assert_array_equal(out["last"][0], seq[-1])
    np.testing.assert_allclose(out["mean"][0], seq.mean(0), rtol=1e-6)
    for mode in ("stack", "mean", "last"):
        for n, v in seq_state.items():
            np.testing.assert_array_equal(out[mode][1][n], v, err_msg=n)


def test_reader_fed_prefetch_matches_executor(tmp_path):
    rng = np.random.RandomState(3)
    w = rng.rand(4, 1).astype("f")

    def reader():
        for _ in range(6):
            xs = rng.rand(8, 4).astype("f")
            yield xs, (xs @ w).astype("f")

    path = str(tmp_path / "d.recordio")
    tfluid.recordio_writer.convert_reader_to_recordio_file(path, reader)

    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 7
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            r = tfluid.layers.open_recordio_file(
                filename=path, shapes=[[-1, 4], [-1, 1]],
                lod_levels=[0, 0], dtypes=["float32", "float32"])
            x, y = tfluid.layers.read_file(r)
            p = tfluid.layers.fc(input=x, size=1)
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(input=p, label=y))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    exe = tfluid.Executor("cpu")
    main, startup, loss = build()
    s1 = tfluid.Scope()
    exe.run(startup, scope=s1)
    init = {n: s1.get(n).clone() for n in s1.names()
            if isinstance(s1.get(n), torch.Tensor)}
    ref = [exe.run(main, fetch_list=[loss], scope=s1)[0] for _ in range(4)]
    main2, startup2, loss2 = build()
    s2 = tfluid.Scope()
    exe.run(startup2, scope=s2)
    for n, v in init.items():
        s2.set(n, v.clone())
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(main_program=main2, devices=CPU8)
        got = [pexe.run([loss2], prefetch=True)[0] for _ in range(2)]
        got += list(pexe.run([loss2], steps=2)[0])
    np.testing.assert_allclose(np.ravel(got), np.ravel(ref), **MLP_TOL)


def test_check_nan_inf_and_timeout():
    init = _jax_init(_mlp)
    main, startup, loss = _mlp(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    bad = _data()
    bad["x"][3, 2] = np.inf
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(main_program=main, devices=CPU8,
                                       check_nan_inf=True)
        with pytest.raises(RuntimeError, match="contains (NaN|Inf)"):
            pexe.run([loss], feed=bad)
    # the state was written back before the raise, as Executor.run does:
    # the watchdog leg starts over from the startup state
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    with tfluid.scope_guard(scope):
        good = tfluid.ParallelExecutor(main_program=main, devices=CPU8)
        before = {n: to_numpy(scope.get(n)) for n in scope.names()}
        with rz.FaultPlan(["slow_step@1:0.6"]) as plan:
            plan.set_step(1)
            with pytest.raises(rz.DispatchTimeoutError):
                good.run([loss], feed=_data(), timeout=0.2)
            time.sleep(1.0)   # the abandoned worker wakes and unwinds
        for n, v in before.items():
            np.testing.assert_array_equal(to_numpy(scope.get(n)), v)
        v, = good.run([loss], feed=_data(), timeout=30)
        assert np.isfinite(v).all()


def test_refusals_name_what_is_missing():
    # a control-flow op reading the batch-sharded feed: refused at
    # construction, naming the op
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        cond = tfluid.layers.less_than(
            x=tfluid.layers.reduce_sum(x),
            y=tfluid.layers.fill_constant([1], "float32", 1.0))
        ie = tfluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(tfluid.layers.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(tfluid.layers.scale(ie.input(x), scale=3.0))
        out, = ie()
    with pytest.raises(ParallelPlacementError, match="cannot place op"):
        tfluid.ParallelExecutor(main_program=main, devices=CPU8)
    # on a 1-way batch axis the same program runs
    tfluid.ParallelExecutor(main_program=main, devices=["cpu"])
    # Megatron partial sums: they run on replicas that share a device
    # (tests/test_torch_program_parallelism.py); over distinct cards the
    # construction raises, naming the placement
    main, startup, loss = _mlp(tfluid)
    mesh = make_mesh({"dp": 2, "tp": 4}, CPU8)
    plan = ShardingPlan.build(main, mesh, tp_axis="tp",
                              tp_placement="compute")
    tfluid.ParallelExecutor(main_program=main, plan=plan)
    apart = ShardingPlan.build(main, make_mesh({"dp": 1, "tp": 2},
                                               ["cpu", "cuda:0"]),
                               tp_axis="tp", tp_placement="compute")
    with pytest.raises(NotImplementedError, match="compute"):
        tfluid.ParallelExecutor(main_program=main, plan=apart)
    with pytest.raises(ValueError, match="pass one or the other"):
        tfluid.ParallelExecutor(main_program=main, plan=plan,
                                mesh=make_mesh({"dp": 8}, CPU8))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available: skip the check")
        tfluid.ParallelExecutor(main_program=main)


def test_steps_k_over_distinct_devices_is_refused(monkeypatch):
    """A mesh of distinct devices cannot capture its step yet: steps=K
    raises GraphCaptureError naming the open item (two distinct CPU
    devices stand in through a device-name shim)."""
    from paddle_tpu_torch.parallel import parallel_executor as pe
    main, startup, loss = _mlp(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        pexe = tfluid.ParallelExecutor(main_program=main, devices=["cpu"])
    st = next(iter(pexe._steps.values()))
    monkeypatch.setattr(st, "single_device", False)
    with pytest.raises(GraphCaptureError, match="distinct cards"):
        pexe.run([loss], feed=_data(), steps=2)
    assert isinstance(P("dp"), tuple) and pe.UPDATE_OPS
