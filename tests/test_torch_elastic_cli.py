"""The port's elastic launcher (`python -m paddle_tpu_torch.tools.ptpu_elastic`)
and the cluster with real worker processes, on the CPU.

- Tier-1, multi-process: two port worker processes (the launcher's
  `worker` subcommand, the demo model, 4 local devices each through
  PTPU_HOST_DEVICES under a budget of 4, paced 0.25 s a step) under the
  port's coordinator; `host_death@6` SIGKILLs w1 at exactly step 6 (rc
  -9, steps 0-5 recorded). w0 is fenced, restores the newest valid snapshot and
  reshards onto `{"dp": 4}`; its stream after the rescale is bit-equal to
  a from-scratch reference process restored from the same snapshot on the
  same mesh shape. No replacement joins, and only w0 finishes.
- The counterparts of the JAX package's two `multiproc` legs, marked as
  they are (multiproc, slow): kill a host, rescale bit-exact and grow back
  with a replacement; and `launch` with a heartbeat stall, where the
  stalled worker is fenced out on missed beats alone.
- `status --json`: the port's rows and plan equal the JAX tool's for one
  directory (both read with a 600 s monitor timeout, so no beat written
  before a tool started reads stale), `beat_age_s` aside.
- The launcher's surface: each subcommand's flags are the JAX tool's,
  and a spawned worker's environment carries the same contract
  (PTPU_CLUSTER_DIR, PTPU_WORKER_ID, PTPU_ELASTIC_STEPS, PTPU_METRICS_PORT,
  PTPU_FAULT_PLAN for the fault worker alone), with PTPU_HOST_DEVICES
  where the JAX tool sets XLA_FLAGS.

Every child process is killed in a `finally`. Host deaths are seen by the
vanished pid (each child is reaped at once), so the coordinator's
heartbeat timeout is long: no live worker reads stale while others start.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.resilience import heartbeat as jhb

from paddle_tpu_torch.parallel import distributed as tdist
from paddle_tpu_torch.resilience import cluster as tcl
from paddle_tpu_torch.resilience import heartbeat as thb
from paddle_tpu_torch.tools import ptpu_elastic as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "ptpu_elastic.py")
MODULE = "paddle_tpu_torch.tools.ptpu_elastic"
MONITOR_TIMEOUT = 600.0


def _jax_tool():
    spec = importlib.util.spec_from_file_location("_jax_ptpu_elastic",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("PTPU_FAULT_PLAN", tdist.HOST_DEVICES_ENV):
        env.pop(k, None)
    env.update(extra)
    return env


def _spawn_worker(wid, d, steps, log, fault=None, step_delay=0.1,
                  host_devices=4):
    extra = {tdist.HOST_DEVICES_ENV: str(host_devices)}
    if fault:
        extra["PTPU_FAULT_PLAN"] = fault
    out = open(log, "w")
    p = subprocess.Popen(
        [sys.executable, "-m", MODULE, "worker", "--cluster-dir", d,
         "--worker-id", wid, "--steps", str(steps),
         "--checkpoint-every", "3", "--sharded-weight-update",
         "--step-delay", str(step_delay)],
        env=_env(**extra), stdout=out, stderr=subprocess.STDOUT, cwd=REPO)
    out.close()
    # reaped at once: a SIGKILLed worker leaves no zombie pid the
    # heartbeat monitor would read as alive
    threading.Thread(target=p.wait, daemon=True).start()
    return p


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _coord_thread(coord, deadline):
    box = {}

    def run():
        try:
            box["summary"] = coord.run(deadline=deadline)
        except Exception as e:  # noqa: BLE001 — surfaced by the test
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _wait_event(coord, name, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = [e for e in coord.events if e["event"] == name]
        if ev:
            return ev[-1]
        time.sleep(0.05)
    raise AssertionError("no %r event; got %r"
                         % (name, [e["event"] for e in coord.events]))


def _rows(d, wid):
    with open(os.path.join(d, "results_%s.jsonl" % wid)) as f:
        return [json.loads(line) for line in f]


# The from-scratch reference: the demo program restored from the pinned
# snapshot onto {"dp": 4} over the one device four times, in a process of
# its own (as the workers are), then stepped to `upto`.
_REF_SCRIPT = """
import json, os, sys
os.environ["PTPU_HOST_DEVICES"] = "4"
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.parallel import DeviceLayout
from paddle_tpu_torch.tools.ptpu_elastic import demo_build
ckpt, restore, upto = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
layout = DeviceLayout(local_device_count=4)
mesh = layout.local_mesh()
built = demo_build(layout)
scope = fluid.Scope()
with fluid.scope_guard(scope):
    fluid.Executor(mesh.devices.flat[0]).run(built["startup"])
    mgr = CheckpointManager(ckpt, async_save=False)
    got = mgr.restore(program=built["main"], scope=scope, step=restore,
                      layout=layout)
    assert got == restore, (got, restore)
    mgr.close()
    pexe = fluid.ParallelExecutor(main_program=built["main"], mesh=mesh,
                                  sharded_weight_update=True)
    for i in range(restore, upto):
        v, = pexe.run([built["loss"].name], feed=built["feed_fn"](i))
        print("ROW " + json.dumps(
            {"step": i, "value": float(np.asarray(v).reshape(-1)[0])}))
"""


def _reference_stream(tmp_path, ckpt_dir, restore, upto):
    script = tmp_path / "reference.py"
    script.write_text(_REF_SCRIPT)
    cp = subprocess.run(
        [sys.executable, str(script), ckpt_dir, str(restore), str(upto)],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    return {r["step"]: r["value"] for r in (
        json.loads(line.split("ROW ", 1)[1])
        for line in cp.stdout.splitlines() if line.startswith("ROW "))}


def _post_rescale(rows, gen):
    post = {}
    for r in rows:
        if r["gen"] >= gen:
            assert r["step"] not in post, \
                "step %d recorded twice after the rescale" % r["step"]
            post[r["step"]] = r["value"]
    return post


def test_host_death_rescale_bit_exact(tmp_path):
    """Two port worker processes, w1 SIGKILLed at step 6: the survivor's
    stream after the rescale onto {"dp": 4} equals a from-scratch
    reference process bit for bit."""
    d = str(tmp_path / "cluster")
    # the workers train apart (no rendezvous), so w0 may run ahead of w1:
    # paced, w0 is still training when w1 dies at its step 6
    steps, delay = 16, 0.25
    coord = tcl.ClusterCoordinator(
        d, num_workers=2, heartbeat_timeout=MONITOR_TIMEOUT,
        poll_interval=0.05, fence_timeout=120.0, total_device_count=4,
        allow_grow=False)
    t, box = _coord_thread(coord, deadline=240)
    procs = []
    try:
        procs.append(_spawn_worker("w0", d, steps, str(tmp_path / "w0.log"),
                                   step_delay=delay))
        procs.append(_spawn_worker("w1", d, steps, str(tmp_path / "w1.log"),
                                   fault="host_death@6", step_delay=delay))
        formed = _wait_event(coord, "formed", timeout=120)
        assert formed["members"] == ["w0", "w1"]
        assert coord._plans[0]["world"] == {
            "w0": {"rank": 0, "local_device_count": 2},
            "w1": {"rank": 1, "local_device_count": 2}}
        resc = _wait_event(coord, "rescale", timeout=120)
        assert resc["survivors"] == ["w0"], resc
        restore = resc["restore_step"]
        # rank 0's newest valid snapshot (every 3 steps), short of the end
        assert restore is not None and restore % 3 == 0 \
            and 0 <= restore < steps
        assert procs[1].wait(timeout=60) == -9
        t.join(120)
        assert "summary" in box, (box, coord.events)
        assert box["summary"]["world"] == {
            "w0": {"rank": 0, "local_device_count": 4}}
        assert box["summary"]["steps"] == {"w0": steps}
        assert procs[0].wait(timeout=60) == 0
    finally:
        _kill(procs)
    rows0 = _rows(d, "w0")
    rows1 = {r["step"]: r["value"] for r in _rows(d, "w1")}
    assert sorted(rows1) == list(range(6))  # killed AT step 6 exactly
    pre = {r["step"]: r["value"] for r in rows0 if r["gen"] < resc["gen"]}
    assert rows1 == {s: v for s, v in pre.items() if s in rows1}
    post = _post_rescale(rows0, resc["gen"])
    assert sorted(post) == list(range(restore, steps))
    ref = _reference_stream(tmp_path, tcl.default_checkpoint_dir(d),
                            restore, steps)
    assert post == ref, "the stream after the rescale is not the " \
        "from-scratch {'dp': 4} resume's"


@pytest.mark.multiproc
@pytest.mark.slow  # as the JAX package's leg: a subprocess cohort
def test_kill_a_host_rescale_bit_exact_and_grow(tmp_path):
    """The JAX acceptance leg on the port: 2 workers x 2 devices under a
    budget of 4, w1 SIGKILLed at step 6, the survivor resharded onto 4
    and bit-exact against the reference, then a replacement joins and
    the mesh grows back at a step barrier with no aborted step."""
    d = str(tmp_path / "cluster")
    steps = 60
    coord = tcl.ClusterCoordinator(
        d, num_workers=2, heartbeat_timeout=MONITOR_TIMEOUT,
        poll_interval=0.05, fence_timeout=120.0, total_device_count=4)
    t, box = _coord_thread(coord, deadline=420)
    procs = []
    try:
        procs.append(_spawn_worker("w0", d, steps, str(tmp_path / "w0.log"),
                                   step_delay=0.3))
        procs.append(_spawn_worker("w1", d, steps, str(tmp_path / "w1.log"),
                                   fault="host_death@6", step_delay=0.3))
        resc = _wait_event(coord, "rescale", timeout=120)
        assert resc["survivors"] == ["w0"], resc
        restore = resc["restore_step"]
        assert procs[1].wait(timeout=60) == -9
        procs.append(_spawn_worker("w2", d, steps, str(tmp_path / "w2.log"),
                                   step_delay=0.3))
        grow = _wait_event(coord, "grow", timeout=120)
        assert grow["joiners"] == ["w2"]
        t.join(240)
        assert "summary" in box, (box, coord.events)
        assert sorted(box["summary"]["world"]) == ["w0", "w2"]
        assert box["summary"]["steps"] == {"w0": steps, "w2": steps}
        assert procs[0].wait(timeout=60) == 0
        assert procs[2].wait(timeout=60) == 0
    finally:
        _kill(procs)
    rows0 = _rows(d, "w0")
    post = _post_rescale(rows0, resc["gen"])
    assert sorted(post) == list(range(restore, steps))
    G = grow["restore_step"]
    assert restore < G <= steps
    ref = _reference_stream(tmp_path, tcl.default_checkpoint_dir(d),
                            restore, G)
    assert {s: v for s, v in post.items() if s < G} == ref
    pre_grow = [r["step"] for r in rows0
                if resc["gen"] <= r["gen"] < grow["gen"]]
    post_grow = [r["step"] for r in rows0 if r["gen"] >= grow["gen"]]
    assert max(pre_grow) + 1 == min(post_grow) == G
    rows2 = {r["step"]: r["value"] for r in _rows(d, "w2")
             if r["gen"] >= grow["gen"]}
    assert rows2 == {s: post[s] for s in rows2}


@pytest.mark.multiproc
@pytest.mark.slow  # as the JAX package's leg: a subprocess cohort
def test_ptpu_elastic_cli_heartbeat_stall_leg(tmp_path):
    """`launch` as an operator runs it: a worker whose heartbeats stall
    at step 4 (training goes on) is declared dead on missed beats alone,
    fenced out, and the cohort finishes without it."""
    d = str(tmp_path / "cluster")
    cp = subprocess.run(
        [sys.executable, "-m", MODULE, "launch", "--cluster-dir", d,
         "--workers", "2", "--steps", "24", "--host-devices", "2",
         "--local-devices", "2", "--step-delay", "0.15",
         "--heartbeat-timeout", "1.2",
         "--fault-worker", "1", "--fault-plan", "heartbeat_stall@4",
         "--deadline", "240"],
        env=_env(), capture_output=True, text=True, timeout=420, cwd=REPO)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert '"rescale"' in cp.stdout
    summary = json.loads(cp.stdout.strip().splitlines()[-1]
                         .split("done: ", 1)[1])
    assert summary["steps"]["w0"] == 24
    assert summary["rescales"] >= 1


def _status_cohort(hb, d):
    writers = []
    for wid, step, status in (("w0", 12, "ok"), ("w1", 9, "fault")):
        w = hb.HeartbeatWriter(d, wid, interval=60.0)
        extra = {"fault": "SilentCorruptionError('m')", "sdc_device": 1} \
            if status == "fault" else {}
        w.update(status=status, step=step, gen=3, gen_acked=3,
                 sentinel={"z": 1.5, "grad_z": None, "spikes": 2,
                           "samples": 40}, **extra)
        writers.append(w)
    return writers


def test_status_json_equals_jax_tool(tmp_path, capsys):
    d = str(tmp_path / "el")
    writers = _status_cohort(thb, d)
    try:
        tcl.write_plan(d, {"gen": 3, "phase": "run", "num_workers": 2,
                           "restore_step": 6,
                           "world": {"w0": {"rank": 0}, "w1": {"rank": 1}},
                           "quarantine": {"w1": [1]}})
        cp = subprocess.run(
            [sys.executable, "-m", MODULE, "status", "--cluster-dir", d,
             "--json", "--heartbeat-timeout", str(MONITOR_TIMEOUT)],
            env=_env(), capture_output=True, text=True, timeout=300,
            cwd=REPO)
        assert cp.returncode == 0, cp.stdout + cp.stderr
        port = json.loads(cp.stdout)
        assert _jax_tool().main(
            ["status", "--cluster-dir", d, "--json",
             "--heartbeat-timeout", str(MONITOR_TIMEOUT)]) == 0
        jax = json.loads(capsys.readouterr().out)
        assert tool.main(["status", "--cluster-dir", d]) == 0
        table = capsys.readouterr().out
    finally:
        for w in writers:
            w.close(status=None)
    for doc in (port, jax):
        for r in doc["workers"]:
            r.pop("beat_age_s")
    assert port == jax
    assert port["plan"]["quarantine"] == {"w1": [1]}
    assert [r["steps_behind"] for r in port["workers"]] == [0, 3]
    assert "quarantine={\"w1\": [1]}" in table
    assert "[sdc_device=1]" in table


def _flags(parser):
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = sorted(
                    s for a in sub._actions for s in a.option_strings)
    return out


def _parser(mod):
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            mod.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


def test_launcher_surface_matches_jax_tool(tmp_path):
    jtool = _jax_tool()
    assert _flags(_parser(tool)) == _flags(_parser(jtool))
    assert tool.main([]) == 2
    args = argparse.Namespace(
        cluster_dir=str(tmp_path), steps=7, host_devices=2,
        fault_plan="host_death@3", worker_cmd=None, metrics_port_base=None)
    for mod, pool in (("port", tool._WorkerPool(args)),
                      ("jax", jtool._WorkerPool(args))):
        faulty = pool._worker_env("w1", True, metrics_port=9100)
        clean = pool._worker_env("w0", False)
        assert faulty["PTPU_CLUSTER_DIR"] == str(tmp_path)
        assert (faulty["PTPU_WORKER_ID"], clean["PTPU_WORKER_ID"]) == \
            ("w1", "w0")
        assert faulty["PTPU_ELASTIC_STEPS"] == "7"
        assert faulty["PTPU_METRICS_PORT"] == "9100"
        assert "PTPU_METRICS_PORT" not in clean
        assert faulty["PTPU_FAULT_PLAN"] == "host_death@3"
        assert "PTPU_FAULT_PLAN" not in clean
        assert faulty["PYTHONPATH"].split(os.pathsep)[0] == REPO
        if mod == "port":
            assert faulty[tdist.HOST_DEVICES_ENV] == "2"
        else:
            assert "device_count=2" in faulty["XLA_FLAGS"]
    assert tool.REPO == REPO
    assert jhb.HB_PREFIX == thb.HB_PREFIX
