"""Programs with `pipeline` and `moe` ops (layers.pipelined_stack,
layers.switch_moe) and "compute" tensor parallelism in the port, against
the JAX package (tests/unittests/test_program_parallelism.py).

Both packages build the same program bytes and start from the JAX
package's startup state, carried over by name (io.scope_from_numpy). The
port runs Executor and ParallelExecutor on ["cpu"] * 8, the JAX package
its ParallelExecutor on its 8 virtual devices. Tolerances: 5 steps'
losses within rtol 2e-4 / atol 1e-5, the JAX test's own; "compute"
against "gather" within 1e-5 / 1e-6 (the same products over split
weights: only the order of their sums differs).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.plan import ShardingPlan as JPlan

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.core.sharded import ShardedValue
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import ShardingPlan, make_mesh
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.parallel import parallel_executor as tpe
from paddle_tpu_torch.serving import InferenceEngine

LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
TP_TOL = dict(rtol=1e-5, atol=1e-6)
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(fluid, seed=11, stages=4, width=16, micro=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[width], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.pipelined_stack(
            x, num_stages=stages, num_microbatches=micro,
            build_stage=lambda xin: fluid.layers.fc(input=xin, size=width,
                                                    act="relu"))
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def _moe(fluid, seed=13, width=16, experts=4, capacity=1.25):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[width], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h, aux = fluid.layers.switch_moe(x, num_experts=experts,
                                         d_hidden=32,
                                         capacity_factor=capacity)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y)) \
            + 0.01 * aux
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _encoder(fluid, transformer, seed=5, T=8, d=16, heads=2, vocab=32,
             stages=2, micro=2):
    """A 2-stage pipelined Transformer encoder LM: embeddings, the stages
    (each an encoder_layer over fused attention, no mask), an fc to the
    vocabulary and softmax_with_cross_entropy, Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.layers.data("src_word", [T], dtype="int64")
        pos = fluid.layers.data("src_pos", [T], dtype="int64")
        lbl = fluid.layers.data("lbl_word", [T, 1], dtype="int64")
        x = transformer.prepare_encoder(src, pos, vocab, d, T)
        h = fluid.layers.pipelined_stack(
            x, stages, lambda xin: transformer.encoder_layer(
                xin, None, heads, d // heads, d // heads, d, 2 * d,
                use_fused=True), num_microbatches=micro)
        logits = fluid.layers.fc(input=h, size=vocab, num_flatten_dims=2)
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=fluid.layers.reshape(logits, shape=[-1, vocab]),
            label=fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _mlp(fluid, seed=33, width=32, dim=16):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[dim], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=width, act="relu")
        h = fluid.layers.fc(input=h, size=width, act="tanh")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _pipe_feed():
    rng = np.random.RandomState(4)
    xs = rng.rand(32, 16).astype("f")
    return {"x": xs, "y": (xs.sum(1, keepdims=True) * 0.1).astype("f")}


def _moe_feed():
    rng = np.random.RandomState(8)
    xs = rng.rand(32, 16).astype("f")
    return {"x": xs, "y": (xs[:, :1] * 0.5 + xs[:, 1:2]).astype("f")}


def _enc_feed():
    rng = np.random.RandomState(9)
    src = rng.randint(1, 32, (8, 8)).astype("int64")
    return {"src_word": src,
            "src_pos": np.tile(np.arange(8, dtype="int64"), (8, 1)),
            "lbl_word": np.roll(src, -1, axis=1)[..., None]}


def _loss(v):
    return float(np.ravel(v)[0])


def _jax_init(build):
    main, startup, loss = build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.get(n)) for n in scope.names()
            if scope.get(n) is not None}


def _jax_losses(build, init, feed, steps, mesh_axes=None, **pkw):
    main, startup, loss = build(jfluid)
    scope = jfluid.Scope()
    for n, v in init.items():
        scope.set(n, v)
    with jfluid.scope_guard(scope):
        if mesh_axes is None:
            exe = jfluid.Executor(jfluid.CPUPlace())
            return [_loss(exe.run(main, feed=feed, fetch_list=[loss])[0])
                    for _ in range(steps)]
        mesh = jmake_mesh(mesh_axes, jax.devices()[:8])
        if "tp_placement" in pkw:
            pkw = {"plan": JPlan.build(main, mesh, tp_axis="tp",
                                       tp_placement=pkw["tp_placement"])}
        else:
            pkw["mesh"] = mesh
        pexe = jfluid.ParallelExecutor(main_program=main,
                                       loss_name=loss.name, **pkw)
        return [_loss(pexe.run(fetch_list=[loss], feed=feed)[0])
                for _ in range(steps)]


def _port_run(build, init, feed, steps, mesh_axes=None, k=1, **pkw):
    """(losses, the scope, the executor): `steps` calls of steps=k."""
    main, startup, loss = build(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    if mesh_axes is None:
        exe = tfluid.Executor("cpu")
        out = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       steps=k)[0] for _ in range(steps)]
    else:
        mesh = make_mesh(mesh_axes, CPU8[:int(np.prod(
            list(mesh_axes.values())))])
        if "tp_placement" in pkw:
            pkw = {"plan": ShardingPlan.build(
                main, mesh, tp_axis="tp", tp_placement=pkw["tp_placement"])}
        else:
            pkw["mesh"] = mesh
        with tfluid.scope_guard(scope):
            exe = tfluid.ParallelExecutor(main_program=main,
                                          loss_name=loss.name, **pkw)
            out = [exe.run(fetch_list=[loss], feed=feed, steps=k)[0]
                   for _ in range(steps)]
    return [float(v) for o in out for v in np.ravel(o)], scope, exe


def _kinds(pexe, op_type):
    """How the newest run ran each `op_type` op (parallel_executor's
    placement kinds)."""
    step = next(iter(pexe._steps.values()))
    return [step.last_ran.get(op.uid)
            for op in step.program.global_block().ops if op.type == op_type]


@pytest.mark.parametrize("case", ["pipeline", "moe"])
def test_parallel_program_matches_jax(case):
    build, feed, axes = {
        "pipeline": (_pipeline, _pipe_feed(), {"dp": 2, "pp": 4}),
        "moe": (_moe, _moe_feed(), {"dp": 2, "ep": 4})}[case]
    init = _jax_init(build)
    j_single = _jax_losses(build, init, feed, 5)
    j_par = _jax_losses(build, init, feed, 5, mesh_axes=axes)
    t_single, _, _ = _port_run(build, init, feed, 5)
    t_par, _, pexe = _port_run(build, init, feed, 5, mesh_axes=axes)
    np.testing.assert_allclose(t_single, j_single, **LOSS_TOL)
    np.testing.assert_allclose(t_par, j_par, **LOSS_TOL)
    np.testing.assert_allclose(t_par, t_single, **LOSS_TOL)
    assert t_par[-1] < t_par[0]
    # the pipeline op runs once a batch shard (its stage is batch-local);
    # moe runs on the gathered batch
    assert _kinds(pexe, case) == ["local" if case == "pipeline"
                                  else "global"]


@pytest.mark.parametrize("case", ["pipeline", "moe"])
def test_parallel_program_steps_k_equals_single_steps(case):
    build, feed, axes = {
        "pipeline": (_pipeline, _pipe_feed(), {"dp": 2, "pp": 4}),
        "moe": (_moe, _moe_feed(), {"dp": 2, "ep": 4})}[case]
    init = _jax_init(build)
    eager, se, _ = _port_run(build, init, feed, 4, mesh_axes=axes)
    multi, sm, _ = _port_run(build, init, feed, 2, mesh_axes=axes, k=2)
    assert eager == multi
    for n in se.names():
        np.testing.assert_array_equal(to_numpy(se.get(n)),
                                      to_numpy(sm.get(n)), err_msg=n)


def test_pipelined_fused_attention_encoder_matches_jax():
    """A 2-stage pipelined encoder (fused attention, d 16, 2 heads, T 8):
    Executor (stages one after the other) and {"dp": 2, "pp": 2} (two
    microbatches a batch shard) in both packages, 3 Adam steps."""
    def build(fluid):
        return _encoder(fluid, jtransformer if fluid is jfluid
                        else ttransformer)
    feed = _enc_feed()
    init = _jax_init(build)
    j_single = _jax_losses(build, init, feed, 3)
    j_par = _jax_losses(build, init, feed, 3, mesh_axes={"dp": 2, "pp": 2})
    t_single, _, _ = _port_run(build, init, feed, 3)
    t_par, _, pexe = _port_run(build, init, feed, 3,
                               mesh_axes={"dp": 2, "pp": 2})
    np.testing.assert_allclose(t_single, j_single, **LOSS_TOL)
    np.testing.assert_allclose(t_par, j_par, **LOSS_TOL)
    assert t_single[-1] < t_single[0]
    assert _kinds(pexe, "pipeline") == ["local"]


def test_pipeline_stage_with_dropout_runs_on_the_gathered_batch():
    """A random op inside a stage makes the pipeline op global on a dp
    axis (its draw is the single-device one), and each stage draws its
    own mask: the steps equal the 1-replica run's bit for bit."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.pipelined_stack(
                x, 2, lambda xin: fluid.layers.dropout(
                    fluid.layers.fc(input=xin, size=16, act="relu"),
                    dropout_prob=0.5))
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                input=fluid.layers.fc(input=h, size=1), label=y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss
    init = _jax_init(build)
    feed = _pipe_feed()
    one, _, _ = _port_run(build, init, feed, 3, mesh_axes={"dp": 1,
                                                           "pp": 2})
    two, _, pexe = _port_run(build, init, feed, 3, mesh_axes={"dp": 2,
                                                              "pp": 2})
    assert _kinds(pexe, "pipeline") == ["global"]
    assert one == two
    # per-stage masks: stage 1 does not redraw stage 0's mask
    main, startup, loss = build(tfluid)
    scope = tio.scope_from_numpy(init, "cpu", program=main)
    exe = tfluid.Executor("cpu")
    drops = [op.outputs["Mask"][0] for blk in main.blocks for op in blk.ops
             if op.type == "dropout"]
    assert len(drops) == 2
    from paddle_tpu_torch.core import lowering
    ctx = lowering.LowerCtx(main, torch.device("cpu"), run_seed=7)
    masks = []
    for s in (0, 1):
        ctx._rng_extra.append(s)
        ctx.begin_op(1)
        masks.append(torch.rand(64, generator=ctx.rng()))
        ctx._rng_extra.pop()
    assert not torch.equal(masks[0], masks[1])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def _raises_like_jax(fn):
    """fn(fluid) raises the same ValueError message in both packages."""
    msgs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            with pytest.raises(ValueError) as e:
                fn(fluid)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_pipelined_stack_refusals_match_jax():
    def not_shape_preserving(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        fluid.layers.pipelined_stack(
            x, 2, lambda xin: fluid.layers.fc(input=xin, size=8))

    def reads_outside(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        outer = fluid.layers.fc(input=x, size=16)
        fluid.layers.pipelined_stack(
            x, 2, lambda xin: fluid.layers.elementwise_add(x=xin, y=outer))

    def attrs_differ(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        acts = iter(["relu", "tanh"])
        fluid.layers.pipelined_stack(
            x, 2, lambda xin: fluid.layers.fc(input=xin, size=16,
                                              act=next(acts)))

    def wiring_differs(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        n = iter([0, 1])

        def stage(xin):
            a = fluid.layers.fc(input=xin, size=16)
            return fluid.layers.fc(input=a if next(n) == 0 else xin,
                                   size=16)
        fluid.layers.pipelined_stack(x, 2, stage)

    def no_params(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        fluid.layers.pipelined_stack(x, 2, lambda xin: fluid.layers.relu(xin))

    def zero_stages(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        fluid.layers.pipelined_stack(x, 0, lambda xin: xin)

    assert "shape-preserving" in _raises_like_jax(not_shape_preserving)
    assert "outside the stage" in _raises_like_jax(reads_outside)
    assert "homogeneous" in _raises_like_jax(attrs_differ)
    assert "homogeneous" in _raises_like_jax(wiring_differs)
    assert "creates no parameters" in _raises_like_jax(no_params)
    assert "num_stages >= 1" in _raises_like_jax(zero_stages)


def test_pipeline_program_bytes_equal_jax():
    from paddle_tpu.core import program_desc as jpd
    from paddle_tpu_torch.core import program_desc as tpd
    jmain = _pipeline(jfluid)[0]
    tmain = _pipeline(tfluid)[0]
    assert tpd.program_to_bytes(tmain) == jpd.program_to_bytes(jmain)
    jmain = _moe(jfluid)[0]
    tmain = _moe(tfluid)[0]
    assert tpd.program_to_bytes(tmain) == jpd.program_to_bytes(jmain)


def test_pipeline_stage_count_must_match_pp_axis():
    init = _jax_init(_pipeline)
    with pytest.raises(ValueError) as e:
        _port_run(_pipeline, init, _pipe_feed(), 1,
                  mesh_axes={"dp": 1, "pp": 2})
    assert "pipeline op has 4 stages but the mesh 'pp' axis is 2" in \
        str(e.value)


@pytest.mark.parametrize("axes", [{"dp": 1, "pp": 2}, {"dp": 1, "ep": 2}])
def test_pp_and_ep_over_distinct_cards_raise(axes):
    build = _pipeline if "pp" in axes else _moe
    main, startup, loss = build(tfluid)
    mesh = make_mesh(axes, ["cpu", "cuda:0"])
    with pytest.raises(NotImplementedError, match="item 5"):
        tfluid.ParallelExecutor(main_program=main, loss_name=loss.name,
                                mesh=mesh)


def test_moe_per_shard_routing_differs_from_the_global_rule():
    """At capacity 1.25 the capacity drops tokens, so routing each dp
    shard apart keeps and drops other tokens: each half routed alone
    gives other outputs than the batch routed whole. The executor runs
    the op on the gathered batch (GLOBAL_OPS) and matches the
    single-device losses."""
    init = _jax_init(_moe)
    feed = _moe_feed()
    gate = next(v for n, v in sorted(init.items()) if v.shape == (16, 4))
    params = {"gate": torch.from_numpy(gate)}
    for slot, shape in (("w1", (4, 16, 32)), ("b1", (4, 32)),
                        ("w2", (4, 32, 16)), ("b2", (4, 16))):
        params[slot] = torch.from_numpy(next(
            v for n, v in sorted(init.items())
            if v.shape == shape and n.startswith("moe")))
    x = torch.from_numpy(feed["x"])
    keep = tmoe.route(torch.softmax(x @ params["gate"], -1),
                      int(np.ceil(32 / 4 * 1.25)))[3]
    assert int((~keep).sum()) > 0
    whole = tmoe.moe_layer(params, x, capacity_factor=1.25)[0]
    halves = torch.cat([tmoe.moe_layer(params, part,
                                       capacity_factor=1.25)[0]
                        for part in x.chunk(2)])
    assert float((whole - halves).abs().max()) > 1e-3
    assert "moe" in tpe.GLOBAL_OPS
    single, _, _ = _port_run(_moe, init, feed, 3)
    glob, _, pexe = _port_run(_moe, init, feed, 3, mesh_axes={"dp": 2,
                                                             "ep": 4})
    assert _kinds(pexe, "moe") == ["global"]
    np.testing.assert_allclose(glob, single, **LOSS_TOL)


def test_tp_compute_matches_gather_and_jax():
    """{"dp": 2, "tp": 4}: "compute" keeps the weights and their Adam
    moments on their pieces, runs the column-parallel products a piece at
    a time (fc 16->32, 32->32) and the row-parallel one (32->1: 1 does not
    split 4 ways) as partial products summed over tp."""
    feeds = []
    rng = np.random.RandomState(3)
    for _ in range(4):
        xs = rng.rand(64, 16).astype("f")
        feeds.append({"x": xs, "y": (xs.sum(1, keepdims=True) * 0.1)
                      .astype("f")})
    init = _jax_init(_mlp)

    def run(place, feeds, k=1):
        main, startup, loss = _mlp(tfluid)
        scope = tio.scope_from_numpy(init, "cpu", program=main)
        plan = ShardingPlan.build(main, make_mesh({"dp": 2, "tp": 4}, CPU8),
                                  tp_axis="tp", tp_placement=place)
        with tfluid.scope_guard(scope):
            pexe = tfluid.ParallelExecutor(main_program=main,
                                           loss_name=loss.name, plan=plan)
            out = [pexe.run(fetch_list=[loss], feed=f, steps=k)[0]
                   for f in feeds]
        return [float(v) for o in out for v in np.ravel(o)], scope, pexe

    gather, sg, _ = run("gather", feeds)
    compute, sc, pexe = run("compute", feeds)
    np.testing.assert_allclose(compute, gather, **TP_TOL)
    for n in sg.names():
        np.testing.assert_allclose(to_numpy(sc.get(n)), to_numpy(sg.get(n)),
                                   err_msg=n, **TP_TOL)
    assert sorted(_kinds(pexe, "mul")) == ["tp_local"] * 3
    split = sorted(n for n in sc.names()
                   if isinstance(sc.get_raw(n), ShardedValue))
    assert split == sorted(
        ["fc_0.w_0", "fc_1.w_0", "fc_2.w_0"]
        + ["moment%d_fc_%d.w_0_0" % (m, i) for m in (1, 2) for i in range(3)])
    assert not pexe._steps[next(iter(pexe._steps))].entry_gather & set(split)
    # steps=2 over each feed: two eager calls over it, bit for bit
    multi, sm, _ = run("compute", feeds[:2], k=2)
    eager, se, _ = run("compute", [feeds[0]] * 2 + [feeds[1]] * 2)
    assert multi == eager
    for n in se.names():
        np.testing.assert_array_equal(to_numpy(sm.get(n)),
                                      to_numpy(se.get(n)), err_msg=n)
    main, startup, loss = _mlp(jfluid)
    scope = jfluid.Scope()
    for n, v in init.items():
        scope.set(n, v)
    with jfluid.scope_guard(scope):
        mesh = jmake_mesh({"dp": 2, "tp": 4}, jax.devices()[:8])
        pexe = jfluid.ParallelExecutor(
            main_program=main, loss_name=loss.name,
            plan=JPlan.build(main, mesh, tp_axis="tp",
                             tp_placement="compute"))
        jax_compute = [_loss(pexe.run(fetch_list=[loss], feed=f)[0])
                       for f in feeds]
    np.testing.assert_allclose(compute, jax_compute, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["pipeline", "moe"])
def test_scoring_program_bytes_serve_in_both_packages(case, tmp_path):
    """A pipelined / MoE scoring program saved by either package's
    save_inference_model serves in the other with the same outputs (a
    batch of 8 rows, the engine's only bucket: a padded row would take
    an expert's capacity)."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 17
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            if case == "pipeline":
                h = fluid.layers.pipelined_stack(
                    x, 3, lambda xin: fluid.layers.fc(input=xin, size=16,
                                                      act="tanh"))
            else:
                h, _ = fluid.layers.switch_moe(x, num_experts=4,
                                               d_hidden=24,
                                               capacity_factor=1.0)
            pred = fluid.layers.fc(input=h, size=3, act="softmax")
        return main, startup, pred

    req = {"x": np.random.RandomState(6).rand(8, 16).astype("f")}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    main, startup, pred = build(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(startup)
        jfluid.io.save_inference_model(jdir, ["x"], [pred], jexe, main)
        want, = jexe.run(main, feed=req, fetch_list=[pred])
    engine = InferenceEngine(jdir, device="cpu", batch_buckets=[8])
    try:
        got = engine.infer(req)[pred.name]
    finally:
        engine.close()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)

    tmain, tstartup, tpred = build(tfluid)
    texe = tfluid.Executor("cpu")
    tscope = tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    tio.save_inference_model(tdir, ["x"], [tpred], texe, tmain,
                             scope=tscope)
    engine = InferenceEngine(tdir, device="cpu", batch_buckets=[8])
    try:
        mine = engine.infer(req)[tpred.name]
    finally:
        engine.close()
    with jfluid.scope_guard(jfluid.Scope()):
        program, feeds, fetches = jfluid.io.load_inference_model(tdir, jexe)
        assert feeds == ["x"]
        theirs, = jexe.run(program, feed=req, fetch_list=fetches)
    assert any(op.type == ("pipeline" if case == "pipeline" else "moe")
               for op in program.global_block().ops)
    np.testing.assert_allclose(mine, np.asarray(theirs), rtol=1e-5,
                               atol=1e-6)


def test_stage_overflow_is_swept_like_jax():
    """A tensor array overflowing inside a stage reaches the run's
    assertions with the JAX package's message (its _stage_runner sweep)."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")

            def stage(xin):
                h = fluid.layers.fc(input=xin, size=4)
                arr = fluid.layers.create_array("float32", capacity=1)
                for i in (0, 1):
                    fluid.layers.array_write(
                        h, fluid.layers.fill_constant([1], "int64", i),
                        array=arr)
                return fluid.layers.array_read(
                    arr, fluid.layers.fill_constant([1], "int64", 0))
            y = fluid.layers.pipelined_stack(x, 2, stage)
        return main, startup, y

    feed = {"x": np.ones((2, 4), "f")}
    msgs = []
    main, startup, y = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        with pytest.raises(RuntimeError) as e:
            exe.run(main, feed=feed, fetch_list=[y])
        msgs.append(str(e.value))
    main, startup, y = build(tfluid)
    texe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    texe.run(startup, scope=scope)
    with pytest.raises(RuntimeError) as e:
        texe.run(main, feed=feed, fetch_list=[y], scope=scope)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "overflowed its capacity" in msgs[1]
