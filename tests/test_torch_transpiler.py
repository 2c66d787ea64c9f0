"""The port's DistributeTranspiler, SimpleDistributeTranspiler and the
parameter-server layers (ListenAndServ, Send, Recv) against the JAX
package's.

Transpiled trainer, pserver and pserver-startup programs serialize to the
JAX transpiler's bytes (core/program_desc, FORMAT_VERSION 1), as do the
programs the layers build. The pserver simulation (trainer program, then
each endpoint's pserver program on its 1-D blocks) equals the monolithic
program within rtol 1e-5 / atol 1e-6, and parameter_shardings under the
port's 8-replica ParallelExecutor within rtol 1e-4 / atol 1e-5 (the JAX
tests' own tolerances).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.transpiler import DistributeTranspiler as JDT
from paddle_tpu.transpiler import SimpleDistributeTranspiler as JSDT
from paddle_tpu.transpiler import distributed_spliter as jspliter

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                         SimpleDistributeTranspiler,
                                         distributed_spliter,
                                         same_or_split_var,
                                         split_dense_variable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, opt="momentum", seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=64, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        if opt == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(loss)
        else:
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _data(n=32, seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 64).astype("float32")
    return {"x": xs, "y": (xs.sum(1, keepdims=True) * 0.05).astype("f")}


def test_split_dense_variable_geometry_and_policies():
    class V(object):
        def __init__(self, name, shape):
            self.name, self.shape = name, shape
    blocks = split_dense_variable([V("w", (64, 64))], 2, min_block_size=1024)
    assert len(blocks) == 2 and sum(b.size for b in blocks) == 64 * 64
    assert all(b.offset % 64 == 0 for b in blocks)
    assert len(split_dense_variable([V("b", (8,))], 4)) == 1
    eps, names = ["ps0", "ps1", "ps2"], ["a", "b", "c", "d", "fc_0.w_0"]
    assert distributed_spliter.round_robin(names, eps) == \
        jspliter.round_robin(names, eps)
    assert distributed_spliter.hash_name(names, eps) == \
        jspliter.hash_name(names, eps)
    assert same_or_split_var("w.block0", "w")
    assert not same_or_split_var("w2", "w")


@pytest.mark.parametrize("opt", ["momentum", "adam"])
@pytest.mark.parametrize("split", ["round_robin", "hash_name"])
def test_transpiled_programs_serialize_to_the_jax_bytes(opt, split):
    out = {}
    for fluid, DT, mod in ((jfluid, JDT, jspliter),
                           (tfluid, DistributeTranspiler,
                            distributed_spliter)):
        main, startup, loss = _build(fluid, opt)
        t = DT().transpile(0, program=main, pservers="ps0,ps1",
                           trainers=2, split_method=getattr(mod, split))
        desc = jdesc if fluid is jfluid else tdesc
        progs = [t.get_trainer_program()]
        for ep in t.pserver_endpoints:
            ps = t.get_pserver_program(ep)
            progs += [ps, t.get_startup_program(ep, ps)]
        out[fluid.__name__] = [desc.program_to_bytes(p) for p in progs]
    assert out["paddle_tpu_torch"] == out["paddle_tpu"]


def test_simple_transpiler_and_layers_serialize_to_the_jax_bytes():
    out = {}
    for fluid, SDT in ((jfluid, JSDT), (tfluid, SimpleDistributeTranspiler)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            p = fluid.layers.fc(input=x, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(input=p, label=y))
            opt_ops, pgs = fluid.optimizer.SGD(
                learning_rate=0.1).minimize(loss)
        t = SDT().transpile(opt_ops, pgs, program=main,
                            pservers="ps0,ps1", trainers=2)
        desc = jdesc if fluid is jfluid else tdesc
        progs = [t.get_trainer_program()] + [
            t.get_pserver_program(ep, opt_ops) for ep in ("ps0", "ps1")]
        srv = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(srv,
                                                            fluid.Program()):
            w = fluid.layers.data(name="w", shape=[4], dtype="float32")
            fluid.layers.Send("ps0,ps1", [w])
            fluid.layers.Recv("ps0", [w])
            serv = fluid.layers.ListenAndServ("ps0", inputs=[w], fan_in=2)
            with serv.do():
                fluid.layers.scale(w, scale=2.0)
        progs.append(srv)
        out[fluid.__name__] = [desc.program_to_bytes(q) for q in progs]
    assert out["paddle_tpu_torch"] == out["paddle_tpu"]


def _simulate(opt, steps):
    feed = _data()
    exe = tfluid.Executor("cpu")
    main, startup, loss = _build(tfluid, opt)
    base = tfluid.Scope()
    exe.run(startup, scope=base)
    init = {n: base.get(n).clone() for n in base.names()}
    base_losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=base)[0][0]) for _ in range(steps)]
    main2, startup2, loss2 = _build(tfluid, opt)
    t = DistributeTranspiler().transpile(0, program=main2,
                                         pservers="ps0,ps1", trainers=1)
    trainer = t.get_trainer_program()
    assert any(op.type == "send" for op in trainer.global_block().ops)
    pservers = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    tscope = tfluid.Scope()
    for n, v in init.items():
        tscope.set(n, v.clone())
    pscopes = {ep: tfluid.Scope() for ep in t.pserver_endpoints}
    for ep in t.pserver_endpoints:
        t.scatter_scope(tscope, pscopes[ep], ep, pservers[ep])
    grads = sorted(set(t.param_grad_map.values()))
    losses = []
    for _ in range(steps):
        outs = exe.run(trainer, feed=feed, fetch_list=[loss2.name] + grads,
                       scope=tscope)
        losses.append(float(outs[0][0]))
        g = dict(zip(grads, outs[1:]))
        for ep, prog in pservers.items():
            pfeed = {}
            for blk, e, bid in t._numbered_blocks():
                if e == ep:
                    gn = t.param_grad_map[blk.varname]
                    pfeed["%s.block%d" % (gn, bid)] = \
                        g[gn].reshape(-1)[blk.offset:blk.offset + blk.size]
            exe.run(prog, feed=pfeed, scope=pscopes[ep])
        t.gather_scope(pscopes, tscope)
    return base_losses, losses, t, pservers


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_pserver_simulation_matches_monolithic(opt):
    base, dist, t, pservers = _simulate(opt, 4)
    assert len(t.param_blocks) >= 3
    for prog in pservers.values():
        assert prog.global_block().ops[-1].type == "listen_and_serv"
        for name in prog.global_block().vars:
            assert not (("beta1_pow" in name or "learning_rate" in name)
                        and ".block" in name), name
    np.testing.assert_allclose(dist, base, rtol=1e-5, atol=1e-6)
    assert dist[-1] < dist[0]


def test_parameter_shardings_under_the_port_parallel_executor():
    feed = _data()
    exe = tfluid.Executor("cpu")
    main, startup, loss = _build(tfluid)
    s1 = tfluid.Scope()
    exe.run(startup, scope=s1)
    init = {n: s1.get(n).clone() for n in s1.names()}
    base = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=s1)[0][0]) for _ in range(3)]
    main2, startup2, loss2 = _build(tfluid)
    t = DistributeTranspiler().transpile(
        0, program=main2, pservers="ps0,ps1,ps2,ps3", trainers=1,
        split_method=distributed_spliter.hash_name)
    mesh = make_mesh({"dp": 8}, ["cpu"] * 8)
    shardings = t.parameter_shardings(mesh, axis="dp")
    w = [p for p in t.param_grad_map if len(t.blocks_of[p]) > 1][0]
    assert t.param_update_op[w].input("Velocity")[0] in shardings
    s2 = tfluid.Scope()
    for n, v in init.items():
        s2.set(n, v.clone())
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(main_program=main2,
                                       loss_name=loss2.name, mesh=mesh,
                                       param_shardings=shardings)
        par = [float(pexe.run([loss2], feed=feed)[0][0]) for _ in range(3)]
    np.testing.assert_allclose(par, base, rtol=1e-4, atol=1e-5)
    for n in s1.names():
        np.testing.assert_allclose(to_numpy(s2.get(n)), to_numpy(s1.get(n)),
                                   err_msg=n, rtol=1e-4, atol=1e-5)
