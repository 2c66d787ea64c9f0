"""The port's ShardingPlan (paddle_tpu_torch/parallel/plan.py) against the
JAX package's, and the port's meshes and DeviceLayout.

The plan is pure bookkeeping, so the contract is exact: for the same
program (built by both packages, or the JAX package's program bytes loaded
by the port) and the same mesh axes, `to_json()` and `digest()` are equal
— dp; dp x zero; dp x tp; explicit overrides; ParamAttr(mesh_axes=);
accumulator attribution by the exact owner map and by the name-pattern
fallback. Declared dtypes are not in the JSON form (§C "Declared dtypes
differ" never reaches it); memory_report() prices them, and both
packages' programs declare float32 for every var it prices here.
"""
import os

import numpy as np
import pytest

import jax

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.parallel import ShardingPlan as JPlan
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh, P as JP

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.parallel import (DeviceLayout, ShardingPlan as TPlan,
                                       make_mesh, P)
from paddle_tpu_torch.parallel import plan as tplan_mod


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(axes, jax.devices()[:n])


def _tmesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, ["cpu"] * n)


def _mlp(fluid, opt="adam", dim=12, width=16, mesh_axes=None, names=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[dim], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        attr = fluid.ParamAttr(name="tp.w", mesh_axes=mesh_axes) \
            if mesh_axes else (fluid.ParamAttr(name="fc.w") if names
                               else None)
        h = fluid.layers.fc(input=x, size=width, act="tanh",
                            param_attr=attr)
        if names:
            h = fluid.layers.fc(input=h, size=width,
                                param_attr=fluid.ParamAttr(name="my_fc.w"))
        h = fluid.layers.fc(input=h, size=width, act="tanh")
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=p, label=y))
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
    return main


def _families(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[32, 8])
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        cv = fluid.layers.conv2d(input=img, num_filters=8, filter_size=3,
                                 act="relu")
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        h = fluid.layers.fc(input=x, size=16)
        h = fluid.layers.fc(input=h, size=1)
        tiny = fluid.layers.fc(input=fluid.layers.fc(input=x, size=5),
                               size=3)
        loss = fluid.layers.mean(h) + fluid.layers.mean(emb) \
            + fluid.layers.mean(cv) + fluid.layers.mean(tiny)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main


CASES = {
    "dp": (lambda f: _mlp(f), {"dp": 8}, {}),
    "dp_zero": (lambda f: _mlp(f), {"dp": 8},
                {"shard_update": True}),
    "dp_x_zero": (lambda f: _mlp(f), {"dp": 2, "zero": 4},
                  {"shard_update": True, "shard_axis": "zero"}),
    "dp_x_tp": (_families, {"dp": 2, "tp": 4}, {"tp_axis": "tp"}),
    "dp_x_tp_zero": (lambda f: _mlp(f, width=16), {"dp": 2, "tp": 4},
                     {"tp_axis": "tp", "shard_update": True}),
    "annotation": (lambda f: _mlp(f, opt="momentum",
                                  mesh_axes=(None, "mp")),
                   {"dp": 2, "mp": 4}, {"shard_update": True}),
    "accumulators": (lambda f: _mlp(f, opt="momentum", names=True),
                     {"dp": 8}, {"shard_update": True}),
    "non_dividing": (lambda f: _mlp(f, width=13), {"dp": 8},
                     {"shard_update": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_json_and_digest_equal_the_jax_plan(case):
    build, axes, kw = CASES[case]
    jplan = JPlan.build(build(jfluid), _jmesh(axes), **kw)
    tplan = TPlan.build(build(tfluid), _tmesh(axes), **kw)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.digest() == jplan.digest()
    assert tplan.memory_report() == jplan.memory_report()


@pytest.mark.parametrize("case", ["dp_zero", "dp_x_tp", "annotation"])
def test_plan_digest_equal_for_the_jax_program_bytes(case):
    """The port loads the JAX package's program bytes and plans them to
    the JAX plan's digest (accumulator owners and mesh_axes ride the
    bytes)."""
    build, axes, kw = CASES[case]
    jmain = build(jfluid)
    tmain = tdesc.program_from_bytes(jdesc.program_to_bytes(jmain))
    assert tmain._accumulator_owner == jmain._accumulator_owner
    jplan = JPlan.build(jmain, _jmesh(axes), **kw)
    tplan = TPlan.build(tmain, _tmesh(axes), **kw)
    assert tplan.digest() == jplan.digest()


def test_overrides_win_and_grad_constraints():
    tmain = _mlp(tfluid)
    jmain = _mlp(jfluid)
    base = TPlan.build(tmain, _tmesh({"dp": 8}), shard_update=True)
    pinned = next(e.name for e in base if e.kind == "param" and e.sharded)
    t = TPlan.build(tmain, _tmesh({"dp": 8}), shard_update=True,
                    overrides={pinned: P()})
    j = JPlan.build(jmain, _jmesh({"dp": 8}), shard_update=True,
                    overrides={pinned: JP()})
    assert t.digest() == j.digest() != base.digest()
    assert t.entries[pinned].override and t.spec_for(pinned) == P()
    assert sorted(base.grad_constraints()) == sorted(
        e.name + "@GRAD" for e in base if e.kind == "param" and e.sharded)


def test_accumulators_follow_owner_and_fallback_attribution():
    tmain = _mlp(tfluid, opt="momentum", names=True)
    plan = TPlan.build(tmain, _tmesh({"dp": 8}), shard_update=True)
    specs = plan.spec_map()
    for acc, p in tmain._accumulator_owner.items():
        if p in specs:
            assert specs.get(acc) == specs[p], (acc, p)
    match = tplan_mod._match_accumulator_param
    params = sorted(["fc.w", "my_fc.w", "w"], key=len, reverse=True)
    assert match("velocity_my_fc.w_0", params) == "my_fc.w"
    assert match("velocity_fc.w_0", params) == "fc.w"
    assert match("velocity_w_0", params) == "w"
    assert match("velocity_fc.war_0", ["fc.w"]) is None
    assert match("learning_rate_0", params) is None
    # the metadata-less fallback reaches the JAX plan's attribution too
    jmain = _mlp(jfluid, opt="momentum", names=True)
    tmain._accumulator_owner = {}
    jmain._accumulator_owner = {}
    assert TPlan.build(tmain, _tmesh({"dp": 8}), shard_update=True) \
        .digest() == JPlan.build(jmain, _jmesh({"dp": 8}),
                                 shard_update=True).digest()


def test_memory_report_zero_ratio_and_describe():
    main = _mlp(tfluid, dim=16, width=32)
    plan = TPlan.build(main, _tmesh({"dp": 8}), shard_update=True)
    m = plan.memory_report()
    ratio = m["update_state"]["per_chip_bytes"] / \
        m["update_state"]["replicated_per_chip_bytes"]
    assert ratio <= 1.0 / 8 + 0.05, ratio
    assert m["params"]["per_chip_bytes"] < \
        m["params"]["replicated_per_chip_bytes"]
    assert "update state/chip" in plan.describe()


def test_plan_and_mesh_error_texts():
    main = _mlp(tfluid)
    mesh = _tmesh({"dp": 8})
    with pytest.raises(ValueError, match="shard_axis 'zero' is not an axis"):
        TPlan.build(main, mesh, shard_axis="zero")
    with pytest.raises(ValueError, match="tp_axis 'tp' is not an axis"):
        TPlan.build(main, mesh, tp_axis="tp")
    with pytest.raises(ValueError, match="tp_placement must be one of"):
        TPlan(mesh, tp_placement="megatron")
    with pytest.raises(TypeError, match="make_mesh expects"):
        make_mesh(["dp"], ["cpu"])
    with pytest.raises(ValueError, match="at most one -1 wildcard"):
        make_mesh({"dp": -1, "tp": -1}, ["cpu"] * 4)
    with pytest.raises(ValueError, match="need 8 devices but only 4"):
        make_mesh({"dp": 8}, ["cpu"] * 4)
    m = make_mesh({"dp": -1, "tp": 2}, ["cpu"] * 8)
    assert dict(m.shape) == {"dp": 4, "tp": 2} and m.size == 8
    assert m.distinct_devices() == [m.devices.flat[0]]


def test_device_layout_json_round_trip_and_local_mesh():
    lay = DeviceLayout(local_device_count=4, mesh_axes={"dp": 2, "zero": 2},
                       shard_axis="zero", devices=["cpu"] * 8)
    back = DeviceLayout.from_json(lay.to_json(), devices=["cpu"] * 8)
    assert back == lay and back.resolved_shard_axis() == "zero"
    assert lay.to_json() == jfluid.parallel.DeviceLayout(
        local_device_count=4, mesh_axes={"dp": 2, "zero": 2},
        shard_axis="zero").to_json()
    mesh = lay.local_mesh()
    assert dict(mesh.shape) == {"dp": 2, "zero": 2}
    with pytest.raises(ValueError, match="local devices"):
        DeviceLayout(local_device_count=9, devices=["cpu"] * 8).local_mesh()
    with pytest.raises(ValueError, match="shard_axis"):
        DeviceLayout(mesh_axes={"dp": 2}, shard_axis="tp")


def test_init_distributed_is_a_noop_for_a_world_of_one(monkeypatch):
    from paddle_tpu_torch.parallel import distributed as dist_mod
    for k in ("TRAINERS", "WORLD_SIZE", "TRAINER_ID", "RANK",
              "PADDLE_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    try:
        assert dist_mod.init_distributed() is False
        assert dist_mod.is_initialized()
        assert dist_mod.process_count() == 1
        assert dist_mod.process_index() == 0
        with pytest.raises(ValueError, match="needs a coordinator"):
            dist_mod.init_distributed(num_processes=2)
    finally:
        dist_mod.shutdown_distributed()
    assert not dist_mod.is_initialized()
    assert dist_mod.active_layout() is None


_WORKER = r"""
import os, sys
import torch
import torch.distributed as dist
from paddle_tpu_torch.parallel.distributed import (
    init_distributed, process_count, shutdown_distributed)
assert init_distributed(backend="gloo")
assert process_count() == 2
t = torch.arange(4, dtype=torch.float32) * (dist.get_rank() + 1)
dist.all_reduce(t)
assert t.tolist() == [0.0, 3.0, 6.0, 9.0], t
print("RANK_%s_OK" % os.environ["TRAINER_ID"])
shutdown_distributed()
"""


@pytest.mark.skipif(
    os.environ.get("PTPU_REAL_MULTIHOST", "") in ("", "0"),
    reason="needs a real two-process rendezvous on localhost (set "
           "PTPU_REAL_MULTIHOST=1 where two local processes can form a "
           "process group), as the JAX package's "
           "tests/unittests/test_multihost_real.py")
def test_two_process_rendezvous_over_the_env_contract(tmp_path):
    import socket
    import subprocess
    import sys
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, TRAINERS="2", TRAINER_ID=str(rank),
                   PADDLE_COORDINATOR="localhost:%d" % port,
                   PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for rank, p in enumerate(procs):
        out, _ = p.communicate(timeout=150)
        assert p.returncode == 0 and "RANK_%d_OK" % rank in out, out
