"""The port's heartbeats (resilience/heartbeat.py), the plan file's helpers
(resilience/cluster.py) and watch_cluster / unwatch_cluster
(observability/registry.py) against the JAX package's, on the CPU.

- atomic_write_json writes the JAX package's bytes for the same document;
- a cluster directory written by either package's HeartbeatWriters reads
  in the other's HeartbeatMonitor: the same workers, and `fleet_view()`
  rows equal but for each beat's age; the same for `dead_workers` and
  for the plan written by either `write_plan`;
- `steps_behind` is the lag behind the furthest live worker, and a
  worker that never reported a step has none;
- an armed `heartbeat_stall` (keyed on the executor's step cursor)
  stops the port's writer beating, as in the JAX package;
- watch_cluster's samples (every `ptpu_cluster_*` family but the beat
  age, whose values are clock readings) are the JAX registry's for the
  same directory, the quarantine list read from the plan; two watchers
  of one directory share one collector until the last unwatch, and two
  directories of one basename get distinct `cluster` labels.

Every monitor here has a timeout of 600 s: no beat turns stale while a
test runs, whatever the load (a reader started seconds after the beats
must still see the writers alive).
"""
import os
import re
import subprocess
import sys

import pytest

from paddle_tpu.core.utils import atomic_write_json as jatomic
from paddle_tpu.observability import registry as jreg
from paddle_tpu.resilience import cluster as jcluster
from paddle_tpu.resilience import heartbeat as jhb

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.utils import atomic_write_json
from paddle_tpu_torch.observability import registry as treg
from paddle_tpu_torch.resilience import cluster as tcluster
from paddle_tpu_torch.resilience import heartbeat as thb
from paddle_tpu_torch.resilience.faults import FaultPlan

TIMEOUT = 600.0


def _write_cohort(hb, d, steps=(12, 9), status="running", extra=None):
    """Two writers of package `hb` beat once into `d` (w0 at steps[0],
    w1 at steps[1]) and a third never reports a step; all stay open."""
    writers = []
    for i, step in enumerate(steps):
        w = hb.HeartbeatWriter(str(d), "w%d" % i, interval=60.0)
        w.update(status=status, step=step, gen=2, gen_acked=2,
                 **(extra or {}))
        writers.append(w)
    w = hb.HeartbeatWriter(str(d), "w9", interval=60.0)
    w.update(status="joining")
    writers.append(w)
    return writers


def _rows(monitor):
    return [{k: v for k, v in r.items() if k != "beat_age_s"}
            for r in monitor.fleet_view()]


def test_atomic_json_bytes_match(tmp_path):
    doc = {"worker_id": "w0", "step": 3, "nested": {"z": [1, 2.5]},
           "status": "running"}
    for kw in ({}, {"indent": 1, "sort_keys": True}):
        atomic_write_json(str(tmp_path / "port.json"), doc, **kw)
        jatomic(str(tmp_path / "jax.json"), doc, **kw)
        assert (tmp_path / "port.json").read_bytes() == \
            (tmp_path / "jax.json").read_bytes()
    atomic_write_json(str(tmp_path / "durable.json"), doc, fsync=True)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_view_reads_across_packages(tmp_path, writer):
    hb = thb if writer == "port" else jhb
    writers = _write_cohort(hb, tmp_path, extra={"metrics_port": 9100})
    try:
        assert thb.heartbeat_path(str(tmp_path), "w0") == \
            jhb.heartbeat_path(str(tmp_path), "w0")
        beats = thb.read_heartbeats(str(tmp_path))
        jbeats = jhb.read_heartbeats(str(tmp_path))
        assert beats == jbeats and sorted(beats) == ["w0", "w1", "w9"]
        rows = _rows(thb.HeartbeatMonitor(str(tmp_path), timeout=TIMEOUT))
        assert rows == _rows(jhb.HeartbeatMonitor(str(tmp_path),
                                                  timeout=TIMEOUT))
        by = {r["worker"]: r for r in rows}
        assert (by["w0"]["steps_behind"], by["w1"]["steps_behind"],
                by["w9"]["steps_behind"]) == (0, 3, None)
        assert all(r["alive"] for r in rows)
        assert by["w0"]["metrics_port"] == 9100
        mon = thb.HeartbeatMonitor(str(tmp_path), timeout=TIMEOUT)
        jmon = jhb.HeartbeatMonitor(str(tmp_path), timeout=TIMEOUT)
        assert mon.dead_workers(expected=["w0", "w5"]) == \
            jmon.dead_workers(expected=["w0", "w5"]) == ["w5"]
    finally:
        for w in writers:
            w.close()
    # an orderly departure is terminal, not a death
    rows = _rows(thb.HeartbeatMonitor(str(tmp_path), timeout=TIMEOUT))
    assert [r["status"] for r in rows] == ["left"] * 3
    assert rows == _rows(jhb.HeartbeatMonitor(str(tmp_path),
                                              timeout=TIMEOUT))


def test_a_dead_pid_is_dead_in_both(tmp_path):
    proc = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    w = thb.HeartbeatWriter(str(tmp_path), "gone", interval=60.0)
    w._payload["pid"] = int(proc.stdout)   # a process that has exited
    w.update(status="running", step=4)
    assert thb.HeartbeatMonitor(str(tmp_path),
                                timeout=TIMEOUT).dead_workers() == ["gone"]
    assert jhb.HeartbeatMonitor(str(tmp_path),
                                timeout=TIMEOUT).dead_workers() == ["gone"]


def test_plan_files_read_across_packages(tmp_path):
    assert tcluster.default_checkpoint_dir(str(tmp_path)) == \
        jcluster.default_checkpoint_dir(str(tmp_path))
    assert tcluster.read_plan(str(tmp_path / "none")) is None
    plan = {"gen": 3, "phase": "run", "members": ["w0", "w1"],
            "quarantine": {"w1": [2, 5]}}
    written = tcluster.write_plan(str(tmp_path / "a"), plan)
    assert jcluster.read_plan(str(tmp_path / "a")) == written
    jwritten = jcluster.write_plan(str(tmp_path / "b"), plan)
    assert tcluster.read_plan(str(tmp_path / "b")) == jwritten
    assert tcluster.PLAN_FILE == jcluster.PLAN_FILE
    with open(os.path.join(str(tmp_path / "a"), "plan.json"), "w") as f:
        f.write("{torn")
    assert tcluster.read_plan(str(tmp_path / "a")) is None


def test_heartbeat_stall_stops_the_beats(tmp_path):
    """heartbeat_stall@0 fires at the executor's step 0 (the fault plan's
    dispatch seam); from then the writer publishes nothing."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                         value=1.0)
    exe = fluid.Executor("cpu")
    w = thb.HeartbeatWriter(str(tmp_path), "w0", interval=60.0)
    assert w.update(status="running", step=0)
    with FaultPlan(["heartbeat_stall@0"]) as plan:
        exe.run(main, fetch_list=[out], scope=fluid.Scope())
        assert plan.heartbeat_stalled()
        seq = thb.read_heartbeats(str(tmp_path))["w0"]["seq"]
        assert w.update(step=1) is False
        assert thb.read_heartbeats(str(tmp_path))["w0"]["seq"] == seq
    assert w.update(step=2)


def _cluster_samples(text):
    """{(family, labels): value} of the ptpu_cluster_* samples, and the
    families with HELP lines."""
    samples, helped = {}, []
    for line in text.splitlines():
        if line.startswith("# HELP ptpu_cluster_"):
            helped.append(line.split()[2])
        m = re.match(r"(ptpu_cluster_\w+)(\{[^}]*\})? (\S+)$", line)
        if m and not m.group(1).endswith("beat_age_seconds"):
            samples[(m.group(1), m.group(2))] = float(m.group(3))
    return samples, helped


def test_watch_cluster_samples_match_the_jax_registry(tmp_path):
    d = tmp_path / "el"
    writers = _write_cohort(thb, d, extra={
        "sentinel": {"z": 1.5, "spikes": 2},
        "sdc": {"checks": 7, "mismatches": 1}})
    tcluster.write_plan(str(d), {"gen": 2, "quarantine": {"w1": [3]}})
    reg, jr = treg.MetricsRegistry(), jreg.MetricsRegistry()
    try:
        fn = treg.watch_cluster(str(d), heartbeat_timeout=TIMEOUT,
                                registry=reg)
        jreg.watch_cluster(str(d), heartbeat_timeout=TIMEOUT, registry=jr)
        samples, helped = _cluster_samples(reg.render_prometheus())
        jsamples, jhelped = _cluster_samples(jr.render_prometheus())
        assert samples == jsamples
        assert helped == jhelped and len(helped) == len(set(helped)) == 10
        assert samples[("ptpu_cluster_worker_steps_behind",
                        '{cluster="el",worker="w1"}')] == 3
        assert ("ptpu_cluster_worker_steps_behind",
                '{cluster="el",worker="w9"}') not in samples
        assert samples[("ptpu_cluster_quarantined_devices",
                        '{cluster="el",worker="w1"}')] == 1
        # a second watcher shares the collector; the first unwatch keeps it
        assert treg.watch_cluster(str(d), heartbeat_timeout=TIMEOUT,
                                  registry=reg) is fn
        treg.unwatch_cluster(str(d), registry=reg)
        assert _cluster_samples(reg.render_prometheus())[0] == samples
        treg.unwatch_cluster(str(d), registry=reg)
        assert _cluster_samples(reg.render_prometheus())[0] == {}
        treg.unwatch_cluster(str(d), registry=reg)   # unwatched: no-op
        # two directories of one basename: distinct cluster labels
        other = tmp_path / "job2" / "el"
        ow = thb.HeartbeatWriter(str(other), "w0", interval=60.0)
        ow.update(status="running", step=1)
        writers.append(ow)
        for r in (reg, jr):
            mod = treg if r is reg else jreg
            mod.watch_cluster(str(d), heartbeat_timeout=TIMEOUT, registry=r)
            mod.watch_cluster(str(other), heartbeat_timeout=TIMEOUT,
                              registry=r)
        labels = {lab for (fam, lab) in
                  _cluster_samples(reg.render_prometheus())[0]
                  if fam == "ptpu_cluster_worker_step"}
        jlabels = {lab for (fam, lab) in
                   _cluster_samples(jr.render_prometheus())[0]
                   if fam == "ptpu_cluster_worker_step"}
        assert labels == jlabels and len(labels) == 4
        assert len({lab.split(",")[0] for lab in labels}) == 2
    finally:
        for w in writers:
            w.close()
    assert {"watch_cluster", "unwatch_cluster"} <= set(treg.__all__)
