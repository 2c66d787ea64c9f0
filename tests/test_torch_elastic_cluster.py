"""The port's elastic cluster (resilience/cluster.py: ClusterCoordinator,
ElasticWorker, ClusterFenced, ClusterAborted) against the JAX package's,
on the CPU.

- Coordinator scripts: fake workers (threads of this test speaking the
  heartbeat and plan protocol, no training) drive both packages'
  coordinators through the same script, each in a directory of its own:
  a death with a reshard to the full device budget, a worker fault with
  a same-size rollback, a grow at the barrier, repeated deaths ending in
  ClusterAborted with a merged bundle, a member that left, the grow save
  at the acting rank 0, a fence restarted mid-fence, an `sdc_device`
  quarantine. The event logs and the published plans must be equal,
  `wall_time` aside and each run's directory written as `<dir>`. The
  fakes driving one package beat through the other package's
  HeartbeatWriter, so each coordinator reads the other's heartbeats.
- A stale plan is cleared at construction in both packages.
- Workers in-process: the port's ElasticWorker under the port's
  coordinator and the JAX ElasticWorker under the JAX coordinator train
  the same tiny program (weights from NumpyArrayInitializer, SGD, no
  dropout, a 2-replica mesh: the port's over ["cpu"] * 2 through
  PTPU_HOST_DEVICES=2, the JAX one over 2 of its virtual devices). The
  per-step values in results_w0.jsonl agree within VALUE_RTOL, and the
  generations, steps and coordinator events are equal: the end-to-end
  single case, the hang escalated to a same-size rollback with a bundle
  on disk, and a canary conviction of local device 1 quarantined, the
  next mesh built around it.

The fakes beat every 0.05 s against heartbeat timeouts of 30 s, so no live
fake turns stale on a loaded machine; a fake's death is seen at once by
the pid of its last beat, one that has exited. Each script waits until
the fakes have answered a plan before it acts again.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import resilience as jrz
from paddle_tpu.checkpoint.snapshot import write_snapshot as jwrite_snapshot
from paddle_tpu.resilience import cluster as jcl
from paddle_tpu.resilience import heartbeat as jhb

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import resilience as trz
from paddle_tpu_torch.checkpoint.snapshot import write_snapshot
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.parallel import distributed as tdist
from paddle_tpu_torch.resilience import cluster as tcl
from paddle_tpu_torch.resilience import heartbeat as thb

# per-step loss of the port's worker against the JAX worker's: the same
# fp32 program on the CPU, summed over two replicas in either order
VALUE_RTOL = 1e-5
VALUE_ATOL = 1e-7
PACKAGES = {"jax": jcl, "port": tcl}
# the fakes driving one package's coordinator beat through the other's
WRITERS = {"jax": thb.HeartbeatWriter, "port": jhb.HeartbeatWriter}


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    monkeypatch.delenv("PTPU_FAULT_PLAN", raising=False)
    hook = texec._barrier_hook
    yield
    assert texec._barrier_hook is hook
    assert jrz.active_plan() is None and trz.active_plan() is None
    tdist.shutdown_distributed()


# ------------------------------------------------------------ the fakes --
_DEAD = []


def _dead_pid():
    """The pid of a child that has exited and been reaped."""
    if not _DEAD:
        p = subprocess.Popen([sys.executable, "-c", ""])
        p.wait()
        _DEAD.append(p.pid)
    return _DEAD[0]


class FakeWorker(object):
    """Speaks the heartbeat/plan protocol without training: joins, acks
    fences (optionally with a saved_step at the fence world's acting
    rank 0), reports ok/done on run plans. `die()` stops beating with no
    terminal word (a crash); `leave()` departs with status "left".

    Every write of its heartbeat goes through one lock (the fake's loop
    beats every 0.05 s itself; the writer's own thread is not started):
    the JAX writer's atomic write uses one tmp name for a process, so two
    threads writing one worker's beat at once can leave it unreadable."""

    BEAT = 0.05

    def __init__(self, writer_cls, cluster_dir, wid, ack_fences=True,
                 saved_step=None):
        self.cluster_dir = str(cluster_dir)
        self.w = writer_cls(cluster_dir, wid, interval=self.BEAT)
        self.ack_fences = ack_fences
        self.saved_step = saved_step
        self.status_on_run = "ok"
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._seen = 0
        self.handled = 0   # the last plan gen answered on the heartbeat
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _update(self, **fields):
        with self._lock:
            self.w.update(**fields)

    def start(self):
        self._update()
        self._thread.start()
        return self

    def _loop(self):
        last = time.monotonic()
        while not self._stop.wait(0.02):
            if time.monotonic() - last >= self.BEAT:
                self._update()
                last = time.monotonic()
            p = tcl.read_plan(self.cluster_dir)
            if not p or p["gen"] == self._seen:
                continue
            self._seen = p["gen"]
            if p["phase"] == "fence" \
                    and self.w.worker_id in p.get("world", {}):
                if self.ack_fences:
                    fields = {"status": "fenced", "gen_acked": p["gen"],
                              "saved_step": None}
                    me = p["world"][self.w.worker_id]
                    ranks = [int(v.get("rank", 1 << 30))
                             for v in p["world"].values()]
                    if p.get("save_step") \
                            and self.saved_step is not None \
                            and me.get("rank") == min(ranks):
                        fields["saved_step"] = self.saved_step
                    self._update(**fields)
            elif p["phase"] == "run" \
                    and self.w.worker_id in p.get("world", {}):
                self._update(status=self.status_on_run, gen=p["gen"],
                             step=p.get("restore_step") or 0)
            self.handled = p["gen"]

    def finish(self):
        self.status_on_run = "done"
        self._update(status="done")

    def fault(self, gen, **extra):
        self._update(status="fault", gen=gen, **dict(
            {"fault": "DispatchTimeout"}, **extra))

    def _halt(self):
        self._stop.set()
        self._thread.join(1.0)

    def die(self):
        """A crash: no terminal word, and the beat's pid is one that has
        exited, so the monitor sees the death at once (as it sees a
        SIGKILLed worker's), not a heartbeat timeout later."""
        self._halt()
        self._update(pid=_dead_pid())

    def leave(self):
        self._halt()
        self._update(status="left")

    def close(self):
        if not self._stop.is_set():
            self.leave()


class Harness(object):
    """One package's coordinator in a thread of its own over `d`."""

    def __init__(self, pkg, d, **kw):
        self.cl = PACKAGES[pkg]
        self.writer = WRITERS[pkg]
        self.d = str(d)
        self.coord = self.cl.ClusterCoordinator(self.d, **kw)
        self.box = {}
        self.fakes = []
        self.thread = None

    def fake(self, wid, **kw):
        f = FakeWorker(self.writer, self.d, wid, **kw).start()
        self.fakes.append(f)
        return f

    def start(self, deadline=60):
        def run():
            try:
                self.box["summary"] = self.coord.run(deadline=deadline)
            except self.cl.ClusterAborted as e:
                self.box["abort"] = e
            except Exception as e:  # noqa: BLE001 — surfaced by the test
                self.box["error"] = e
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        return self

    def wait_event(self, name, timeout=30):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ev = [e for e in self.coord.events if e["event"] == name]
            if ev:
                return ev[-1]
            time.sleep(0.02)
        raise AssertionError("no %r event; got %r"
                             % (name, [e["event"] for e in
                                       self.coord.events]))

    def settle(self, timeout=30):
        """Wait until every live fake named in the current plan has
        answered it on its heartbeat: what a script does next (a death, a
        fault, a finish) then meets the same heartbeats in both
        packages, not a race with the fakes' loops."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            p = self.cl.read_plan(self.d) or {}
            if all(f.handled >= p.get("gen", 0) for f in self.fakes
                   if not f._stop.is_set()
                   and f.w.worker_id in p.get("world", {})):
                return p
            time.sleep(0.02)
        raise AssertionError("the fakes did not answer plan %s" % p)

    def join(self, timeout=30):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), self.coord.events

    def close(self):
        for f in self.fakes:
            f.close()
        if self.thread is not None:
            self.thread.join(30)

    def record(self):
        """The run as the comparison reads it: events and plans with
        `wall_time` dropped and the directory written as <dir>, and how
        the run ended."""
        def norm(doc):
            text = json.dumps(doc, sort_keys=True).replace(self.d, "<dir>")
            out = json.loads(text)
            for item in out:
                item.pop("wall_time", None)
            return out
        ended = {k: v for k, v in self.box.items()}
        if "summary" in ended:
            s = ended["summary"]
            ended = {"summary": {"world": s["world"], "gen": s["gen"],
                                 "steps": s["steps"]}}
        elif "abort" in ended:
            ended = {"abort": str(ended["abort"]).replace(self.d, "<dir>")}
        else:
            ended = {"error": repr(ended.get("error"))}
        return {"events": norm(self.coord.events),
                "plans": norm(self.coord._plans), "ended": ended}


def _snapshot(pkg, d, step):
    writer = jwrite_snapshot if pkg == "jax" else write_snapshot
    writer(PACKAGES[pkg].default_checkpoint_dir(str(d)), step,
           [("a", {}, np.zeros(2, "f"))], {"seed_cursor": 0})


# ---------------------------------------------------- the scripts --------
def script_death(h):
    _snapshot(h.pkg, h.d, 7)
    a, b = h.fake("wa"), h.fake("wb")
    h.start()
    h.wait_event("formed")
    h.settle()
    b.die()
    ev = h.wait_event("rescale")
    h.settle()
    assert ev["survivors"] == ["wa"] and ev["restore_step"] == 7
    assert tcl.read_plan(h.d)["world"] == {
        "wa": {"rank": 0, "local_device_count": 4}}
    a.finish()
    h.join()


def script_fault(h):
    _snapshot(h.pkg, h.d, 4)
    a, b = h.fake("wa"), h.fake("wb")
    h.start()
    h.wait_event("formed")
    h.settle()
    b.fault(tcl.read_plan(h.d)["gen"])
    ev = h.wait_event("rescale")
    h.settle()
    assert sorted(ev["survivors"]) == ["wa", "wb"]
    assert ev["restore_step"] == 4
    a.finish()
    b.finish()
    h.join()


def script_grow(h):
    a = h.fake("wa", saved_step=9)
    h.start()
    h.wait_event("formed")
    h.settle()
    c = h.fake("wc")
    ev = h.wait_event("grow")
    h.settle()
    assert ev["restore_step"] == 9
    assert tcl.read_plan(h.d)["world"]["wa"]["local_device_count"] == 2
    a.finish()
    c.finish()
    h.join()


def script_abort(h):
    wdir = os.path.join(h.d, "bundles", "wb", "bundle_step3")
    os.makedirs(wdir)
    with open(os.path.join(wdir, "bundle.json"), "w") as f:
        json.dump({"reason": "hang watchdog tripped"}, f)
    h.fake("wa", ack_fences=False)
    b = h.fake("wb")
    h.start()
    h.wait_event("formed")
    h.settle()
    b.die()
    h.join()
    e = h.box["abort"]
    assert e.bundle and os.path.exists(os.path.join(
        e.bundle, "workers", "wb", "bundle_step3", "bundle.json"))
    with open(os.path.join(e.bundle, "bundle.json")) as f:
        meta = json.load(f)
    assert meta["events"] and meta["heartbeats"]
    assert any(p["phase"] == "fence" for p in meta["plans"])
    assert tcl.read_plan(h.d)["phase"] == "abort"


def script_left(h):
    a, b = h.fake("wa"), h.fake("wb")
    h.start()
    h.wait_event("formed")
    h.settle()
    b.leave()
    assert h.wait_event("rescale")["survivors"] == ["wa"]
    h.settle()
    a.finish()
    h.join()


def script_acting_rank0(h):
    a = h.fake("wa", ack_fences=False, saved_step=7)
    b = h.fake("wb", saved_step=5)
    h.start()
    h.wait_event("formed")
    h.settle()
    c = h.fake("wc")
    h.wait_event("fence")
    a.die()
    assert h.wait_event("grow")["restore_step"] == 5
    h.settle()
    assert sorted(tcl.read_plan(h.d)["world"]) == ["wb", "wc"]
    b.finish()
    c.finish()
    h.join()


def script_refence(h):
    a = h.fake("wa")
    b = h.fake("wb", ack_fences=False)
    c = h.fake("wc")
    h.start()
    h.wait_event("formed")
    h.settle()
    c.die()
    h.wait_event("fence")
    b.die()
    assert h.wait_event("rescale")["survivors"] == ["wa"]
    h.settle()
    a.finish()
    h.join()


def script_quarantine(h):
    _snapshot(h.pkg, h.d, 5)
    a, b = h.fake("wa"), h.fake("wb")
    h.start()
    h.wait_event("formed")
    h.settle()
    b.fault(tcl.read_plan(h.d)["gen"],
            fault="SilentCorruptionError('canary mismatch')", sdc_device=1)
    q = h.wait_event("quarantine")
    assert q["worker"] == "wb" and q["device"] == 1
    assert h.wait_event("rescale")["quarantine"] == {"wb": [1]}
    h.settle()
    plan = tcl.read_plan(h.d)
    assert plan["quarantine"] == {"wb": [1]}
    assert plan["world"]["wb"]["local_device_count"] == 1
    assert plan["world"]["wa"]["local_device_count"] == 2
    a.finish()
    b.finish()
    h.join()


SCRIPTS = {
    "death": (script_death, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=20.0,
        total_device_count=4, allow_grow=False)),
    "fault": (script_fault, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=20.0,
        allow_grow=False)),
    "grow": (script_grow, dict(
        num_workers=1, heartbeat_timeout=30.0, fence_timeout=20.0,
        total_device_count=4)),
    "abort": (script_abort, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=1.0,
        max_rescales=1, allow_grow=False)),
    "left": (script_left, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=20.0,
        allow_grow=False)),
    "acting_rank0": (script_acting_rank0, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=20.0,
        total_device_count=4)),
    "refence": (script_refence, dict(
        num_workers=3, heartbeat_timeout=30.0, fence_timeout=20.0,
        max_rescales=4, allow_grow=False)),
    "quarantine": (script_quarantine, dict(
        num_workers=2, heartbeat_timeout=30.0, fence_timeout=20.0,
        total_device_count=4, allow_grow=False)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_coordinators_agree_on_script(tmp_path, name):
    """The same script through both coordinators at once (a thread each):
    equal events and plans, and each run's own assertions."""
    script, kw = SCRIPTS[name]
    harnesses, errors = {}, {}

    def drive(pkg):
        h = Harness(pkg, tmp_path / pkg, poll_interval=0.02, **kw)
        h.pkg = pkg
        harnesses[pkg] = h
        try:
            script(h)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[pkg] = e
        finally:
            h.close()

    threads = [threading.Thread(target=drive, args=(pkg,))
               for pkg in PACKAGES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    got = {pkg: h.record() for pkg, h in harnesses.items()}
    assert got["port"]["ended"] == got["jax"]["ended"]
    assert [e["event"] for e in got["port"]["events"]] == \
        [e["event"] for e in got["jax"]["events"]]
    assert got["port"]["events"] == got["jax"]["events"]
    assert got["port"]["plans"] == got["jax"]["plans"]


def test_stale_plan_cleared_and_shard_axis_checked(tmp_path):
    for pkg, cl in PACKAGES.items():
        d = str(tmp_path / pkg)
        cl.write_plan(d, {"gen": 9, "phase": "done", "world": {}})
        cl.ClusterCoordinator(d, num_workers=1)
        assert tcl.read_plan(d) is None and jcl.read_plan(d) is None
        with pytest.raises(ValueError) as ei:
            cl.ClusterCoordinator(d, num_workers=1, shard_axis="tp")
        assert "not one of the cluster's mesh axes" in str(ei.value)


def test_exceptions_and_exports():
    for name in ("ClusterCoordinator", "ElasticWorker", "ClusterFenced",
                 "ClusterAborted", "read_plan", "write_plan", "PLAN_FILE",
                 "default_checkpoint_dir"):
        assert name in tcl.__all__ and hasattr(tcl, name)
    for name in ("ClusterCoordinator", "ElasticWorker", "ClusterFenced",
                 "ClusterAborted"):
        assert getattr(trz, name) is getattr(tcl, name)
    fenced = tcl.ClusterFenced("moved", gen=4)
    assert fenced.gen == 4 and fenced._cluster_fence
    aborted = tcl.ClusterAborted("gone", bundle="b", cause=KeyError())
    assert aborted.bundle == "b" and isinstance(aborted.cause, KeyError)


# ------------------------------------------------- workers in-process ----
_RNG = np.random.RandomState(2)
_W = _RNG.uniform(-0.5, 0.5, (4, 1)).astype("f")
_DATA = [_RNG.rand(4, 4).astype("f") for _ in range(8)]


def _tiny_build(fluid):
    def build(layout):
        del layout
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 13
        startup.random_seed = 13
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            p = fluid.layers.fc(
                input=x, size=1, param_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.NumpyArrayInitializer(_W)))
            loss = fluid.layers.mean(
                x=fluid.layers.square_error_cost(input=p, label=y))
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)

        def feed_fn(i):
            xb = _DATA[i % len(_DATA)]
            return {"x": xb, "y": xb[:, :1].copy()}

        return {"main": main, "startup": startup, "loss": loss,
                "feed_fn": feed_fn}
    return build


def _rows(d):
    with open(os.path.join(d, "results_w0.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_worker(pkg, d, steps, fault=None, worker_kw=None):
    """One worker of `pkg` under its own coordinator (local devices 2)
    in this process; returns (worker result, coordinator summary, event
    names, result rows)."""
    cl, rz, fluid = ((jcl, jrz, jfluid) if pkg == "jax"
                     else (tcl, trz, tfluid))
    coord = cl.ClusterCoordinator(d, num_workers=1, heartbeat_timeout=60.0,
                                  poll_interval=0.02, local_device_count=2)
    box = {}

    def run():
        try:
            box["summary"] = coord.run(deadline=120)
        except Exception as e:  # noqa: BLE001 — surfaced below
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    worker = cl.ElasticWorker(d, "w0", _tiny_build(fluid),
                              checkpoint_every=2, **(worker_kw or {}))
    plan = rz.FaultPlan(fault).arm() if fault else None
    try:
        out = worker.run(steps)
    finally:
        if plan is not None:
            plan.disarm()
        t.join(60)
    assert "summary" in box, (box, coord.events)
    return out, box["summary"], coord, _rows(d)


def _agree(port_rows, jax_rows):
    assert [(r["gen"], r["step"]) for r in port_rows] == \
        [(r["gen"], r["step"]) for r in jax_rows]
    np.testing.assert_allclose([r["value"] for r in port_rows],
                               [r["value"] for r in jax_rows],
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)


CASES = {
    # the end-to-end single case: forms, trains, publishes the final
    # snapshot, the coordinator reports done
    "single": dict(steps=5),
    # a wedged dispatch: local abort with a bundle, escalated through the
    # heartbeat, a same-size rollback to the newest snapshot
    "hang": dict(steps=6, fault=["slow_step@3:30.0"],
                 worker_kw=dict(watchdog_timeout=1.0)),
    # the canary convicts local device 1: quarantined, the next mesh is
    # built around it
    "quarantine": dict(steps=8, fault=["bitflip@1:1"],
                       worker_kw=dict(sdc=True, sdc_every=2)),
}


_JAX_BEAT = jhb.HeartbeatWriter.beat


def _one_jax_beat_at_a_time(self):
    """The JAX writer's beat with its writes serialized, as the port's
    are: its beat thread and its worker's update() share one tmp file,
    and a torn beat reads as a dead worker (a spurious rescale)."""
    lock = self.__dict__.setdefault("_test_write_lock", threading.Lock())
    with lock:
        return _JAX_BEAT(self)


@pytest.mark.parametrize("case", sorted(CASES))
def test_elastic_worker_matches_jax(tmp_path, monkeypatch, case):
    monkeypatch.setenv(tdist.HOST_DEVICES_ENV, "2")
    monkeypatch.setattr(jhb.HeartbeatWriter, "beat", _one_jax_beat_at_a_time)
    kw = CASES[case]
    got = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        got[pkg] = _run_worker(pkg, d, **kw)
        out, summary, coord, rows = got[pkg]
        steps = kw["steps"]
        assert summary["steps"] == {"w0": steps}
        assert out["steps"] == steps
        final_gen = max(r["gen"] for r in rows)
        assert sorted({r["step"] for r in rows}) == list(range(steps))
        found = PACKAGES[pkg].find_valid_snapshot(
            PACKAGES[pkg].default_checkpoint_dir(d))
        assert found is not None and found[0] == steps
        if case == "single":
            assert out["generations"] == 1
            assert [r["step"] for r in rows] == list(range(steps))
        else:
            assert out["generations"] == 2
            ev = next(e for e in coord.events if e["event"] == "rescale")
            assert ev["survivors"] == ["w0"]
            det = next(e for e in coord.events if e["event"] == "detected")
            assert det["faulted"] == ["w0"] and det["dead"] == []
            # every step completed exactly once in the final history
            assert sorted(r["step"] for r in rows if r["gen"] == final_gen) \
                == list(range(ev["restore_step"], steps))
        if case == "hang":
            assert ev["restore_step"] == 2
            broot = os.path.join(d, "bundles", "w0")
            assert os.path.isdir(broot) and os.listdir(broot)
        if case == "quarantine":
            q = next(e for e in coord.events if e["event"] == "quarantine")
            assert q["worker"] == "w0" and q["device"] == 1
            plan = PACKAGES[pkg].read_plan(d)
            assert plan["quarantine"] == {"w0": [1]}
            assert plan["world"]["w0"]["local_device_count"] == 1
    assert [e["event"] for e in got["port"][2].events] == \
        [e["event"] for e in got["jax"][2].events]
    assert got["port"][0] == got["jax"][0]
    _agree(got["port"][3], got["jax"][3])


def test_quarantined_layout_over_host_devices(monkeypatch):
    """PTPU_HOST_DEVICES=N: N entries of the one device where a
    DeviceLayout takes its default devices, and a quarantined index is
    left out of the mesh; without it the CPU is listed once."""
    monkeypatch.delenv(tdist.HOST_DEVICES_ENV, raising=False)
    assert len(tdist.DeviceLayout()._all_devices()) == 1
    monkeypatch.setenv(tdist.HOST_DEVICES_ENV, "4")
    lay = tdist.DeviceLayout(local_device_count=3, skip_local_devices=[1])
    assert [str(d) for d in lay._all_devices()] == ["cpu"] * 4
    mesh = lay.local_mesh()
    assert dict(mesh.shape) == {"dp": 3}
    assert tdist.local_device_count() == 4
    monkeypatch.setenv(tdist.HOST_DEVICES_ENV, "0")
    with pytest.raises(ValueError):
        tdist.DeviceLayout()._all_devices()
