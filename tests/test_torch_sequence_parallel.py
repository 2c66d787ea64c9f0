"""Sequence parallelism in the port: ring and Ulysses attention
(parallel/ring_attention.py, parallel/ulysses.py) against the JAX
package's on its 8 virtual devices, and fused_attention under a
ParallelExecutor mesh with an 'sp' axis.

The same numpy q, k, v [B, T, H, D] go through both packages' sharded
functions on a dp x sp mesh, causal and with key lengths: outputs within
rtol 2e-5 / atol 2e-5 (the JAX ring test's tolerance; fp32 online softmax
in both), gradients of sum(out ** 2) within 5e-4 (its gradient
tolerance). Program level: the JAX package's dp2 x sp2 x mp2
fused-attention + FFN trainer (tests/unittests/test_program_parallelism.
py:203) and a 2-layer Transformer, under both exchanges, against the
single-device Executor within rtol 2e-4 / atol 1e-5 (that test's own);
the Transformer's state after 3 Adam steps within rtol 1e-3 / atol 1e-5
(each dp shard's products sum in another order, and Adam divides by a
gradient's root mean square).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.parallel import ring_attention_sharded as jring
from paddle_tpu.parallel import ulysses_attention_sharded as julysses
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import (P, make_mesh, ring_attention_sharded,
                                       ulysses_attention_sharded)

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
PROG_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype("f") * 0.5 for _ in range(3)]


FNS = {"ring": (ring_attention_sharded, jring),
       "ulysses": (ulysses_attention_sharded, julysses)}


@pytest.mark.parametrize("impl", sorted(FNS))
@pytest.mark.parametrize("causal,lens", [(False, None), (True, None),
                                         (False, (32, 11)), (True, (7, 32))])
def test_sharded_attention_matches_jax(impl, causal, lens):
    tfn, jfn = FNS[impl]
    q, k, v = _qkv()
    kv = None if lens is None else np.asarray(lens, "int32")
    jmesh = jmake_mesh({"dp": 2, "sp": 4}, jax.devices()[:8])
    tmesh = make_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)

    def jattend(q, k, v):
        return jfn(q, k, v, jmesh, causal=causal,
                   kv_len=None if kv is None else jnp.asarray(kv))

    @jax.jit
    def jboth(q, k, v):
        out, vjp = jax.vjp(jattend, q, k, v)
        return out, vjp(2.0 * out)   # the gradient of sum(out ** 2)

    with jmesh:
        jout, jgrads = jboth(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tout = tfn(*ts, tmesh, causal=causal,
               kv_len=None if kv is None else torch.tensor(kv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **OUT_TOL)
    (tout ** 2).sum().backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL)


def test_sp_only_mesh_and_indivisible_heads():
    q, k, v = _qkv(h=8)
    tmesh = make_mesh({"sp": 8}, ["cpu"] * 8)
    jmesh = jmake_mesh({"sp": 8}, jax.devices()[:8])
    for tfn, jfn in FNS.values():
        with jmesh:
            want = np.asarray(jfn(q, k, v, jmesh, causal=True))
        got = tfn(*map(torch.tensor, (q, k, v)), tmesh, causal=True)
        np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    q3, k3, v3 = _qkv(h=3)
    with pytest.raises(ValueError, match="heads % sp == 0"):
        ulysses_attention_sharded(*map(torch.tensor, (q3, k3, v3)),
                                  tmesh)


T, H, D = 8, 2, 8


def _sp_mp_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 31
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        q = fluid.layers.data(name="q", shape=[T, H, D], dtype="float32")
        y = fluid.layers.data(name="y", shape=[T, 4], dtype="float32")
        att = fluid.layers.fused_attention(q, q, q, causal=True)
        flat = fluid.layers.reshape(att, shape=[0, T, H * D])
        wide = fluid.layers.fc(input=flat, size=32, act="relu",
                               num_flatten_dims=2)
        pred = fluid.layers.fc(input=wide, size=4, num_flatten_dims=2)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def test_sp_x_mp_program_matches_single_device_and_jax():
    rng = np.random.RandomState(4)
    feed = {"q": rng.randn(8, T, H, D).astype("f") * 0.5,
            "y": rng.randn(8, T, 4).astype("f")}
    jmain, jstartup, jloss = _sp_mp_program(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
        init = {n: np.asarray(jscope.get(n)) for n in jscope.names()}
        sh = {v.name: jfluid.parallel.P(None, "mp")
              for v in jmain.global_block().all_parameters()
              if v.shape is not None and len(v.shape) == 2
              and v.shape[-1] == 32}
        for acc, owner in jmain._accumulator_owner.items():
            if owner in sh:
                sh[acc] = sh[owner]
        jpexe = jfluid.ParallelExecutor(
            main_program=jmain, loss_name=jloss.name,
            mesh=jmake_mesh({"dp": 2, "sp": 2, "mp": 2}, jax.devices()[:8]),
            param_shardings=sh)
        jl = [float(np.ravel(jpexe.run([jloss], feed=feed)[0])[0])
              for _ in range(4)]
    main, startup, loss = _sp_mp_program(tfluid)
    exe = tfluid.Executor("cpu")
    s1 = tio.scope_from_numpy(init, "cpu", program=main)
    single = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=s1)[0][0]) for _ in range(4)]
    s2 = tio.scope_from_numpy(init, "cpu", program=main)
    tsh = {n: P(*s) for n, s in sh.items()}
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(
            main_program=main, loss_name=loss.name,
            mesh=make_mesh({"dp": 2, "sp": 2, "mp": 2}, ["cpu"] * 8),
            param_shardings=tsh)
        multi = [float(pexe.run([loss], feed=feed)[0][0])
                 for _ in range(4)]
    np.testing.assert_allclose(multi, single, **PROG_TOL)
    np.testing.assert_allclose(multi, jl, **PROG_TOL)
    assert multi[-1] < multi[0]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_two_layer_transformer_under_sp_matches_single_device(impl):
    """A 2-layer fused-attention Transformer (T=8) trained on {dp: 2,
    sp: 2}: each replica's attention exchanges blocks; the rest of the
    step runs on its dp shard."""
    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 3
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            _, avg_cost, _ = ttransformer.build_train(
                32, 32, 8, d_model=16, n_layer=2, n_head=2, d_key=8,
                d_value=8, d_inner_hid=32, use_fused_attention=True,
                label_smooth_eps=0.1)
        for op in main.global_block().ops:
            if op.type == "fused_attention":
                op.attrs["sp_impl"] = impl
        return main, startup, avg_cost

    rng = np.random.RandomState(0)
    srcs = [rng.randint(3, 32, 8).tolist() for _ in range(4)]
    feed = ttransformer.prepare_batch(srcs, srcs, 8, labels=True)
    main, startup, loss = build()
    exe = tfluid.Executor("cpu")
    s1 = tfluid.Scope()
    exe.run(startup, scope=s1)
    init = {n: s1.get(n).clone() for n in s1.names()}
    single = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=s1)[0][0]) for _ in range(3)]
    s2 = tfluid.Scope()
    for n, v in init.items():
        s2.set(n, v.clone())
    with tfluid.scope_guard(s2):
        pexe = tfluid.ParallelExecutor(
            main_program=main,
            mesh=make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4))
        multi = [float(pexe.run([loss], feed=feed)[0][0])
                 for _ in range(3)]
    np.testing.assert_allclose(multi, single, **PROG_TOL)
    for n in s1.names():
        np.testing.assert_allclose(s2.get(n).float().numpy(),
                                   s1.get(n).float().numpy(), err_msg=n,
                                   rtol=1e-3, atol=1e-5)


def _tiny_sp_program(impl):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, avg_cost, _ = ttransformer.build_train(
            32, 32, 8, d_model=16, n_layer=1, n_head=2, d_key=8,
            d_value=8, d_inner_hid=32, use_fused_attention=True,
            label_smooth_eps=0.1)
    for op in main.global_block().ops:
        if op.type == "fused_attention":
            op.attrs["sp_impl"] = impl
    return main, startup, avg_cost


def test_sp_over_distinct_devices_is_refused():
    """An 'sp' axis over distinct devices raises at construction, naming
    the open item: nothing would be split between the cards (two CPU
    device names stand in for two cards)."""
    main, startup, loss = _tiny_sp_program("ring")
    scope = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        with pytest.raises(NotImplementedError,
                           match="sequence parallelism over distinct"):
            tfluid.ParallelExecutor(
                main_program=main, loss_name=loss.name,
                mesh=make_mesh({"dp": 1, "sp": 2}, ["cpu:0", "cpu:1"]))
        # the same mesh on one device runs
        tfluid.ParallelExecutor(main_program=main, loss_name=loss.name,
                                mesh=make_mesh({"dp": 1, "sp": 2},
                                               ["cpu"] * 2))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_steps_k_matches_steps_1(impl):
    """run(steps=3) on {dp: 1, sp: 2} gives the losses and state of three
    steps=1 calls from the same scope, bit for bit (the multi-step runner
    replays the same step)."""
    rng = np.random.RandomState(1)
    srcs = [rng.randint(3, 32, 8).tolist() for _ in range(2)]
    feed = ttransformer.prepare_batch(srcs, srcs, 8, labels=True)
    main, startup, loss = _tiny_sp_program(impl)
    s0 = tfluid.Scope()
    tfluid.Executor("cpu").run(startup, scope=s0)
    init = {n: s0.get(n).clone() for n in s0.names()}
    out = {}
    for steps in (1, 3):
        sc = tfluid.Scope()
        for n, v in init.items():
            sc.set(n, v.clone())
        with tfluid.scope_guard(sc):
            pexe = tfluid.ParallelExecutor(
                main_program=main, loss_name=loss.name,
                mesh=make_mesh({"dp": 1, "sp": 2}, ["cpu"] * 2))
            if steps == 1:
                losses = [float(np.ravel(pexe.run([loss], feed=feed)[0])[0])
                          for _ in range(3)]
            else:
                losses = [float(v) for v in np.ravel(
                    pexe.run([loss], feed=feed, steps=3)[0])]
        out[steps] = (losses, {n: sc.get(n).clone() for n in sc.names()})
    assert out[3][0] == out[1][0]
    for n, v in out[1][1].items():
        assert torch.equal(out[3][1][n], v), n
