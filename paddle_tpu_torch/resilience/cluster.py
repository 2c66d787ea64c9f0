"""Elastic multi-process training: the cluster Supervisor.

Parity: the JAX package's resilience/cluster.py, whole: the plan file,
`ClusterCoordinator`, `ElasticWorker`, `ClusterFenced` and
`ClusterAborted`. The plans and heartbeats are the same JSON documents,
published by the same atomic writes, so a cluster directory written by
either package reads in the other. The port's operator front end is
`python -m paddle_tpu_torch.tools.ptpu_elastic` (launch / worker /
status).

The Supervisor recovers ONE process; this module extends the same
detection -> policy -> recovery shape across a cohort of worker
processes (the runtime-level cluster fault tolerance of the TensorFlow
system paper, arXiv:1605.08695).

Roles and protocol (everything rides the shared cluster directory, the
same shared-filesystem trust the checkpoint root already carries):

  ClusterCoordinator   one process (the launcher) that owns the PLAN: an
                       atomically published, generation-numbered JSON
                       document naming the cohort: who is a member, each
                       member's rank and local device count, what
                       snapshot to restore, and the phase
                       (run / fence / abort / done).
  ElasticWorker        each worker runs the guarded loop (an inner
                       Supervisor: guards, watchdog, skip/retry) plus a
                       heartbeat thread (step cursor, status, acked
                       generation, reader positions). Local faults stay
                       local; a hang (DispatchTimeoutError) escalates as
                       a CLUSTER fault through the heartbeat.

Failure flow (shrink): the coordinator detects a dead host (missed
heartbeats, a vanished pid, or a worker-reported cluster fault) and
(1) FENCES the cohort: publishes a fence-phase plan; every survivor
stops at its next step boundary (`core.executor._barrier_hook` fires
before the io pre-pass and the seed draw, so the fenced attempt consumes
nothing) and acks; a survivor that dies DURING the fence restarts the
fence with the remaining cohort. (2) ROLLS BACK: picks the newest valid
snapshot and publishes a run-phase plan pinning it. (3) RESHARDS: every
survivor drops its old layout (`shutdown_distributed`), builds the new
cohort's `DeviceLayout`, and restores the pinned snapshot with
`CheckpointManager.restore(layout=)`: arrays recorded under N devices
re-split onto the new M-device mesh. Training resumes bit-exact with a
from-scratch run on the new mesh resumed from the same snapshot.

Silent data corruption follows the same flow at DEVICE granularity: a
worker whose canary (resilience/sdc.py) convicts a device escalates with
`sdc_device` in its heartbeat; the coordinator QUARANTINES that device
(records it, publishes the list in every plan, subtracts it from the
member's device budget) and runs the ordinary fence/rollback/reshard.
The member's next DeviceLayout builds its mesh around the device
(`skip_local_devices`); a member with no devices left drops out of the
world. `ptpu_elastic status` shows the list.

Growth (a replacement worker joins) is the same fence minus the
rollback: the coordinator fences AT a step barrier with `save_step` set,
the acting rank 0 snapshots its current step, and the new run-phase plan
pins exactly that step, so no completed step is aborted.

Exhausted budgets (max_rescales) or a memberless cohort end in a
coordinator-side abort: one MERGED diagnostic bundle (coordinator
events, every worker's last heartbeat, the plan history, each worker's
own Supervisor bundles) and a typed ClusterAborted.

Data plane: each worker trains the same program over its local mesh.
Replicas that share a device are listed once each (`DeviceLayout`'s
devices; a launcher's `--host-devices N` sets `PTPU_HOST_DEVICES`, which
makes a process see its one device N times, as the JAX launcher's
XLA_FLAGS makes it see N virtual CPU devices). Without a multi-process
rendezvous the cohort trains replicated, which the coordination layer
cannot tell apart: the fence/rollback/reshard protocol is data-plane
agnostic.
"""
import json
import os
import shutil
import time

import numpy as np

from ..core import executor as _exe_mod
from ..core.executor import DispatchTimeoutError, Scope, scope_guard
from ..core.readers import EOFException
from ..core.utils import atomic_write_json
from ..checkpoint import CheckpointManager, find_valid_snapshot
from ..observability import registry as _obsreg
from ..observability import trace as _otrace
from ..parallel import distributed as _dist
from ..parallel.distributed import DeviceLayout
from . import faults as _faults
from . import heartbeat as _hb
from .sdc import CanaryChecker, SilentCorruptionError
from .sentinel import TrainingSentinel
from .supervisor import Supervisor, TrainingAborted, abort as _abort_action

__all__ = ["ClusterCoordinator", "ElasticWorker", "ClusterFenced",
           "ClusterAborted", "read_plan", "write_plan", "PLAN_FILE",
           "default_checkpoint_dir"]

PLAN_FILE = "plan.json"


class ClusterFenced(RuntimeError):
    """The coordinator published a newer plan generation: this process
    must stop training and reconfigure. Raised by the step-barrier hook
    BEFORE anything of the attempt is consumed; the Supervisor passes it
    through untouched (it is coordination, not a fault)."""

    _cluster_fence = True

    def __init__(self, message, gen=None):
        super(ClusterFenced, self).__init__(message)
        self.gen = gen


class ClusterAborted(RuntimeError):
    """Terminal cluster-level escalation. `bundle` is the merged
    diagnostic bundle directory when one was written."""

    def __init__(self, message, bundle=None, cause=None):
        super(ClusterAborted, self).__init__(message)
        self.bundle = bundle
        self.cause = cause


def default_checkpoint_dir(cluster_dir):
    """Coordinator and workers must agree on the snapshot root; this is
    the shared default under the cluster directory."""
    return os.path.join(str(cluster_dir), "ckpt")


# ------------------------------------------------------------- the plan --
def write_plan(cluster_dir, plan):
    """Atomically publish `plan` (tmp + fsync + os.replace: readers never
    see a torn document, and the plan survives power loss). Returns the
    plan with wall_time stamped."""
    plan = dict(plan, wall_time=time.time())
    os.makedirs(str(cluster_dir), exist_ok=True)
    atomic_write_json(os.path.join(str(cluster_dir), PLAN_FILE), plan,
                      fsync=True, indent=1, sort_keys=True)
    return plan


def read_plan(cluster_dir):
    """The current plan, or None before the coordinator publishes one. A
    transiently unreadable file reads as None (an atomic replace makes
    that a race, not a corruption)."""
    try:
        with open(os.path.join(str(cluster_dir), PLAN_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------- coordinator --
class ClusterCoordinator(object):
    def __init__(self, cluster_dir, num_workers, checkpoint_dir=None,
                 heartbeat_timeout=3.0, poll_interval=0.05,
                 fence_timeout=60.0, join_timeout=180.0, max_rescales=8,
                 total_device_count=None, local_device_count=None,
                 mesh_axes=None, batch_axis="dp", shard_axis=None,
                 bundle_dir=None, allow_grow=True, on_event=None):
        """`num_workers` is the INITIAL cohort size (formation waits for
        that many registrations); later joiners grow the cohort when
        `allow_grow`. Device assignment per member: with
        `total_device_count` set, the cluster's chip budget is fixed
        and each member gets total // world_size (a shrinking cohort
        GROWS each survivor's local mesh — the in-process reshard);
        otherwise `local_device_count` (or each worker's own default)
        applies uniformly. `max_rescales` budgets reconfigurations
        (shrink + grow combined); past it the coordinator aborts with a
        merged bundle. `on_event(event_dict)` observes the event log
        live (the launcher's replace-a-dead-worker trigger)."""
        self.cluster_dir = str(cluster_dir)
        self.num_workers = int(num_workers)
        self.checkpoint_dir = checkpoint_dir or default_checkpoint_dir(
            cluster_dir)
        self.monitor = _hb.HeartbeatMonitor(cluster_dir,
                                            timeout=heartbeat_timeout)
        self.poll_interval = float(poll_interval)
        self.fence_timeout = float(fence_timeout)
        self.join_timeout = float(join_timeout)
        self.max_rescales = int(max_rescales)
        self.total_device_count = total_device_count
        self.local_device_count = local_device_count
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.batch_axis = batch_axis
        # the update-state shard axis (parallel/plan.py): published in
        # every generation's plan so resharded cohorts keep the
        # sharded-weight-update layout across rescales. Validated HERE
        # (same rule as DeviceLayout) — deferring it would make every
        # worker's layout constructor raise instead, read as a cohort
        # of worker deaths burning fence/rollback cycles to abort.
        if shard_axis is not None and shard_axis not in (
                self.mesh_axes or {batch_axis: -1}):
            raise ValueError(
                "shard_axis %r is not one of the cluster's mesh axes %r"
                % (shard_axis, sorted(self.mesh_axes or {batch_axis: -1})))
        self.shard_axis = shard_axis
        self.bundle_dir = bundle_dir
        self.allow_grow = bool(allow_grow)
        self.on_event = on_event
        self.events = []
        self.gen = 0
        self.world = {}       # worker_id -> {"rank", "local_device_count"}
        # worker_id -> sorted list of local device indices the SDC
        # canary convicted (resilience/sdc.py). Published in every
        # plan; _assign_world subtracts them from the member's device
        # budget and the member's DeviceLayout builds its mesh around
        # them. A member with no devices left is dropped entirely.
        self.quarantine = {}
        self.rescales = 0
        self._plans = []      # published plan history (merged bundle)
        # a restarted cluster reuses its directory (that is how it finds
        # its checkpoints) — but a PREVIOUS run's plan must not leak
        # into the new one: fresh workers reading a stale done/abort
        # plan would exit before formation, and a stale high generation
        # would outrun the new coordinator's numbering. Construct the
        # coordinator before spawning workers (the launcher does).
        try:
            os.remove(os.path.join(self.cluster_dir, PLAN_FILE))
        except OSError:
            pass

    # ---------------------------------------------------------- events --
    def _log(self, event, **detail):
        ev = dict(detail, event=event, gen=self.gen,
                  wall_time=time.time())
        self.events.append(ev)
        # flight-recorder instants: fence/rescale/grow/abort land in the
        # same timeline as the dispatch spans
        _otrace.instant("cluster/%s" % event, cat="cluster",
                        gen=int(self.gen))
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:  # noqa: BLE001 — observers must not kill
                pass           # the control loop
        return ev

    def _publish(self, phase, world, **extra):
        self.gen += 1
        plan = dict(extra, gen=self.gen, phase=phase, world=world,
                    num_workers=len(world),
                    checkpoint_dir=self.checkpoint_dir,
                    batch_axis=self.batch_axis,
                    quarantine={w: sorted(d)
                                for w, d in self.quarantine.items() if d})
        if self.mesh_axes:
            plan["mesh_axes"] = self.mesh_axes
        if self.shard_axis is not None:
            plan["shard_axis"] = self.shard_axis
        plan = write_plan(self.cluster_dir, plan)
        self._plans.append(plan)
        return plan

    # ----------------------------------------------------- world shapes --
    def _assign_world(self, worker_ids):
        """Deterministic rank + device assignment for a cohort: ranks in
        sorted worker_id order; local device counts per the configured
        policy (fixed total budget re-split, or uniform), MINUS each
        member's quarantined devices. A member whose quarantine covers
        its whole device budget is dropped from the world (and the
        budget re-split over the rest — which can re-trip the check, so
        iterate to a fixed point); with an unconfigured device count the
        member's own DeviceLayout subtracts, worker-side."""
        ids = sorted(set(worker_ids))
        while True:
            n = max(1, len(ids))
            dropped = []
            world = {}
            for rank, wid in enumerate(ids):
                if self.total_device_count is not None:
                    local = max(1, int(self.total_device_count) // n)
                else:
                    local = self.local_device_count
                lost = len(self.quarantine.get(wid, ()))
                if local is not None and lost:
                    local -= lost
                    if local < 1:
                        dropped.append(wid)
                        continue
                world[wid] = {"rank": rank, "local_device_count": local}
            if not dropped:
                return world
            self._log("member_out_of_devices", dropped=sorted(dropped),
                      quarantine={w: sorted(self.quarantine.get(w, ()))
                                  for w in dropped})
            ids = [w for w in ids if w not in dropped]
            if not ids:
                return {}

    def _newest_snapshot_step(self):
        found = find_valid_snapshot(self.checkpoint_dir)
        return None if found is None else int(found[0])

    def _note_quarantine(self, faulted, beats):
        """A faulted member whose heartbeat names an `sdc_device` (the
        canary convicted a chip, resilience/sdc.py) gets that device
        QUARANTINED: recorded here, subtracted from the member's budget
        by _assign_world, published in every later plan so the member's
        DeviceLayout builds its mesh around it. The rescale that follows
        is the ordinary fence/rollback/reshard — a bad chip is handled
        exactly like a dead host, but at device granularity."""
        for w in faulted:
            dev = beats.get(w, {}).get("sdc_device")
            if dev is None:
                continue
            devs = self.quarantine.setdefault(w, [])
            if int(dev) not in devs:
                devs.append(int(dev))
                self._log("quarantine", worker=w, device=int(dev),
                          fault=beats[w].get("fault"))

    # -------------------------------------------------------- main loop --
    def run(self, deadline=None):
        """Form the cohort, supervise it to completion. Returns a
        summary dict; raises ClusterAborted on terminal escalation (the
        merged bundle path rides the exception). `deadline` (seconds)
        bounds the whole run — expiry is an abort, not a hang."""
        t_end = None if deadline is None else time.monotonic() + deadline
        members = self._wait_for_formation(t_end)
        self.world = self._assign_world(members)
        restore = self._newest_snapshot_step()
        self._publish("run", self.world, restore_step=restore,
                      reason="initial formation")
        self._log("formed", members=sorted(members),
                  restore_step=restore)
        while True:
            if t_end is not None and time.monotonic() > t_end:
                self._abort("coordinator deadline exceeded")
            time.sleep(self.poll_interval)
            beats = self.monitor.poll()
            # a member whose last word was "left" departed WITHOUT
            # finishing (worker-side failure, orderly exit): it is not
            # coming back — rescale it out like a death, or the cohort
            # would wait on its "done" forever
            dead = [w for w in self.world
                    if w not in beats or not beats[w]["alive"]
                    or beats[w].get("status") == "left"]
            faulted = [w for w in self.world if w not in dead
                       and beats[w].get("status") == "fault"
                       and beats[w].get("gen") == self.gen]
            if dead or faulted:
                self._note_quarantine(faulted, beats)
                self._rescale(dead, faulted, beats)
                continue
            joiners = [w for w, hb in beats.items()
                       if w not in self.world
                       and hb.get("status") == "joining"]
            if joiners and self.allow_grow:
                self._grow(joiners, beats)
                continue
            if self.world and all(
                    beats.get(w, {}).get("status") == "done"
                    for w in self.world):
                self._publish("done", self.world,
                              reason="all members reported done")
                self._log("done", members=sorted(self.world))
                return {"events": self.events, "world": self.world,
                        "gen": self.gen,
                        "steps": {w: beats[w].get("step")
                                  for w in self.world}}

    def _wait_for_formation(self, t_end):
        t0 = time.monotonic()
        while True:
            beats = self.monitor.poll()
            members = [w for w, hb in beats.items()
                       if hb.get("status") == "joining" and hb["alive"]]
            if len(members) >= self.num_workers:
                return members[:self.num_workers] \
                    if len(members) > self.num_workers else members
            if time.monotonic() - t0 > self.join_timeout or (
                    t_end is not None and time.monotonic() > t_end):
                self._abort("formation timeout: %d/%d workers joined"
                            % (len(members), self.num_workers))
            time.sleep(self.poll_interval)

    # ---------------------------------------------------------- shrink --
    def _budget_or_abort(self, reason, cause=None):
        self.rescales += 1
        if self.rescales > self.max_rescales:
            self._abort("rescale budget exhausted (%d) at: %s"
                        % (self.max_rescales, reason), cause=cause)

    def _rescale(self, dead, faulted, beats):
        """Shrink (dead workers dropped) and/or cohort-wide rollback
        (faulted workers kept): fence, pick the newest valid snapshot,
        publish the new world. A member death DURING the fence restarts
        the fence with the remaining cohort."""
        reason = "dead=%s faulted=%s" % (sorted(dead), sorted(faulted))
        self._budget_or_abort(reason)
        survivors = [w for w in self.world if w not in dead]
        self._log("detected", dead=sorted(dead), faulted=sorted(faulted),
                  detail={w: beats.get(w, {}).get("status")
                          for w in self.world})
        survivors = self._fence(survivors, reason=reason)
        if not survivors:
            self._abort("no survivors after: %s" % reason)
        restore = self._newest_snapshot_step()
        self.world = self._assign_world(survivors)
        if not self.world:
            self._abort("quarantine left no usable devices after: %s"
                        % reason)
        self._publish("run", self.world, restore_step=restore,
                      reason="rescale: " + reason)
        self._log("rescale", survivors=sorted(survivors),
                  restore_step=restore, reason=reason,
                  quarantine={w: sorted(d)
                              for w, d in self.quarantine.items() if d})

    def _fence(self, members, reason, save_step=False):
        """Publish a fence-phase plan and wait for every member's ack
        (gen_acked == fence gen). Members that die while fencing are
        dropped and the fence RESTARTS for the rest — the
        death-during-recovery path. Returns the members that acked."""
        members = list(members)
        while members:
            plan = self._publish("fence", {w: self.world.get(w, {})
                                           for w in members},
                                 save_step=bool(save_step), reason=reason)
            self._log("fence", members=sorted(members),
                      save_step=bool(save_step))
            t0 = time.monotonic()
            while True:
                beats = self.monitor.poll()
                acked = [w for w in members
                         if beats.get(w, {}).get("gen_acked")
                         == plan["gen"]]
                if len(acked) == len(members):
                    self._log("fenced", members=sorted(members))
                    return members
                newly_dead = [w for w in members
                              if w not in beats
                              or not beats[w]["alive"]
                              or beats[w].get("status") == "left"]
                if newly_dead or time.monotonic() - t0 \
                        > self.fence_timeout:
                    stragglers = newly_dead or [
                        w for w in members if w not in acked]
                    self._budget_or_abort(
                        "death during recovery: %s" % sorted(stragglers))
                    self._log("refence", dropped=sorted(stragglers))
                    members = [w for w in members
                               if w not in stragglers]
                    break  # restart the fence for the remainder
                time.sleep(self.poll_interval)
        return members

    # ------------------------------------------------------------ grow --
    def _grow(self, joiners, beats):
        """Replacement-worker join: fence the running members AT a step
        barrier with save_step (rank 0 snapshots its current step), then
        publish the grown world pinning exactly that snapshot — nobody
        rolls back, no completed step is aborted."""
        del beats
        self._budget_or_abort("grow: %s" % sorted(joiners))
        members = list(self.world)
        self._log("join_detected", joiners=sorted(joiners))
        survivors = self._fence(members, save_step=True,
                                reason="grow: %s" % sorted(joiners))
        if not survivors:
            self._abort("cohort died while growing")
        # rank 0's ack carries the step it snapshotted; a member that
        # had already finished (no live state) acks without one, and the
        # newest valid snapshot (its final save) stands in
        rank0 = min(survivors,
                    key=lambda w: self.world.get(w, {}).get("rank", 1 << 30))
        saved = self.monitor.poll().get(rank0, {}).get("saved_step")
        restore = int(saved) if saved is not None \
            else self._newest_snapshot_step()
        self.world = self._assign_world(survivors + list(joiners))
        self._publish("run", self.world, restore_step=restore,
                      reason="grow: %s" % sorted(joiners))
        self._log("grow", joiners=sorted(joiners),
                  world=sorted(self.world), restore_step=restore)

    # ----------------------------------------------------------- abort --
    def _abort(self, reason, cause=None):
        bundle = self._write_merged_bundle(reason)
        self._publish("abort", self.world, reason=reason)
        self._log("abort", reason=reason, bundle=bundle)
        raise ClusterAborted(
            "cluster aborted: %s%s" % (
                reason, " (bundle: %s)" % bundle if bundle else ""),
            bundle=bundle, cause=cause)

    def _write_merged_bundle(self, reason):
        """One self-contained post-mortem: coordinator events + plan
        history + every worker's last heartbeat, plus each worker's own
        Supervisor bundles (written under <cluster_dir>/bundles/<worker_id>)
        copied alongside. Never raises — the bundle exists to explain a
        failure, not to cause another."""
        try:
            base = self.bundle_dir or os.path.join(self.cluster_dir,
                                                   "bundle")
            os.makedirs(base, exist_ok=True)
            path = os.path.join(base, "cluster_bundle")
            n = 0
            while os.path.exists(path):
                n += 1
                path = os.path.join(base, "cluster_bundle.%d" % n)
            os.makedirs(path)
            meta = {"reason": str(reason),
                    "wall_time": time.time(),
                    "gen": self.gen,
                    "rescales": self.rescales,
                    "world": self.world,
                    "events": self.events,
                    "plans": self._plans,
                    "heartbeats": _hb.read_heartbeats(self.cluster_dir)}
            try:
                # the coordinator's own flight-recorder ring (fence/
                # rescale/abort instants); each worker's span timeline
                # rides along inside its copied Supervisor bundles below
                meta["trace"] = _otrace.dump_jsonable()
            except Exception:  # noqa: BLE001
                pass
            with open(os.path.join(path, "bundle.json"), "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            wroot = os.path.join(self.cluster_dir, "bundles")
            if os.path.isdir(wroot):
                shutil.copytree(wroot, os.path.join(path, "workers"))
            return path
        except Exception:  # noqa: BLE001 — best-effort post-mortem
            return None


# --------------------------------------------------------------- worker --
# local policy of an elastic worker: hangs are CLUSTER faults (the
# cohort must fence and roll back together — a lone local rollback would
# desync the replicas), so the local chain aborts immediately and the
# worker escalates the TrainingAborted through its heartbeat. Everything
# else keeps the Supervisor's local defaults.
def _elastic_policies(overrides=None):
    pol = {"hang": (_abort_action(),)}
    pol.update(overrides or {})
    return pol


class ElasticWorker(object):
    def __init__(self, cluster_dir, worker_id, build_fn,
                 checkpoint_dir=None, checkpoint_every=None,
                 policies=None, watchdog_timeout=None,
                 heartbeat_interval=0.2, poll_interval=0.02,
                 plan_timeout=180.0, record_results=True,
                 async_save=False, sharded_weight_update=False,
                 step_delay=0.0, metrics_port=None,
                 metrics_host="127.0.0.1", sentinel=None, sdc=None,
                 sdc_every=64):
        """One cohort member. `build_fn(layout)` -> dict with keys
        `main`, `startup`, `loss` (Variable or name) and optionally
        `feed_fn(step_index)` (deterministic feeds; omit for reader-fed
        programs) and `fetch_list`. It is called once per GENERATION —
        after every rescale — under a fresh Scope, so programs are
        rebuilt against the new mesh shape deterministically (set
        Program.random_seed inside it).

        Per generation the worker: drops all distributed state
        (`shutdown_distributed`), installs the new `DeviceLayout`,
        builds a ParallelExecutor over `layout.local_mesh()`, restores
        the plan's pinned snapshot WITH resharding
        (`restore(layout=)`), and trains under an inner Supervisor
        whose rollbacks also reshard (`restore_layout`). Rank 0 is the
        cohort's checkpoint writer (`checkpoint_every`); results
        (per-step first-fetch scalars) append to
        results_<worker_id>.jsonl for the bit-exactness legs."""
        self.cluster_dir = str(cluster_dir)
        self.worker_id = str(worker_id)
        self.build_fn = build_fn
        self.checkpoint_dir = checkpoint_dir or default_checkpoint_dir(
            cluster_dir)
        self.checkpoint_every = checkpoint_every
        self.policies = _elastic_policies(policies)
        self.watchdog_timeout = watchdog_timeout
        self.poll_interval = float(poll_interval)
        self.plan_timeout = float(plan_timeout)
        self.record_results = bool(record_results)
        self.async_save = bool(async_save)
        self.sharded_weight_update = bool(sharded_weight_update)
        # test/demo pacing: sleep this long after every completed step
        # (a cohort of tiny models otherwise finishes before a
        # replacement worker can even import torch and join)
        self.step_delay = float(step_delay)
        # trainer-side scrape endpoint: serve the
        # observability registry's Prometheus rendering — including the
        # heartbeat-derived fleet gauges for this cluster dir — on this
        # port (0 = pick a free one, published in the heartbeat so
        # `ptpu_elastic status` can point scrapers at it; None = off).
        # metrics_host defaults loopback; a multi-host fleet whose
        # scraper lives elsewhere passes "0.0.0.0" (the heartbeat's
        # `host` field names the machine)
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self._metrics_server = None
        # training-health layer. `sentinel` /
        # `sdc`: True for defaults, or a kwargs dict for the
        # TrainingSentinel / CanaryChecker constructors. Both are
        # rebuilt per generation (the sentinel's window restarts with
        # the restored stream; the canary's device rotation follows the
        # resharded, quarantine-filtered mesh) but the canary's
        # REFERENCE digest persists across generations — it must, or a
        # degraded chip joining a new generation would record its own
        # wrong answer as truth.
        self.sentinel_opts = sentinel
        self.sdc_opts = sdc
        self.sdc_every = sdc_every
        self._sdc_state = None
        self._sdc_device_map = None
        self._hb_writer = _hb.HeartbeatWriter(
            cluster_dir, worker_id, interval=heartbeat_interval)
        self._plan_path = os.path.join(self.cluster_dir, PLAN_FILE)
        self._plan_mtime = None
        self._plan_cache = None
        self._processed_gen = 0
        self._acked_gen = 0
        self._armed_gen = None
        self._done = False

    # ------------------------------------------------------------ plans --
    def _current_plan(self):
        """The published plan, re-read only when the file changed."""
        try:
            mtime = os.stat(self._plan_path).st_mtime_ns
        except OSError:
            return self._plan_cache
        if mtime != self._plan_mtime:
            plan = read_plan(self.cluster_dir)
            if plan is not None:
                self._plan_cache = plan
                self._plan_mtime = mtime
        return self._plan_cache

    def _wait_for_plan(self, past_gen):
        """Block until a plan with gen > past_gen exists."""
        t0 = time.monotonic()
        while True:
            plan = self._current_plan()
            if plan is not None and plan.get("gen", 0) > past_gen:
                return plan
            if time.monotonic() - t0 > self.plan_timeout:
                raise ClusterAborted(
                    "worker %s: no plan past gen %d within %.0fs — "
                    "coordinator lost?" % (self.worker_id, past_gen,
                                           self.plan_timeout))
            time.sleep(self.poll_interval)

    def _barrier_check(self, point, program=None, steps=1):
        """The core.executor step-barrier hook: one os.stat per
        dispatch; raises ClusterFenced the moment the plan moves past
        the generation this process is training under."""
        del point, program, steps
        plan = self._current_plan()
        if plan is not None and self._armed_gen is not None \
                and plan.get("gen", 0) != self._armed_gen:
            raise ClusterFenced(
                "cluster plan moved to gen %s (phase %r) past this "
                "worker's gen %d" % (plan.get("gen"), plan.get("phase"),
                                     self._armed_gen),
                gen=plan.get("gen"))

    # ------------------------------------------------------------- run --
    def run(self, num_steps):
        """Train `num_steps` total cluster steps, surviving rescales.
        Returns {"steps": final step, "generations": n} on success;
        raises ClusterAborted when the coordinator aborts the job."""
        num_steps = int(num_steps)
        if self.metrics_port is not None and self._metrics_server is None:
            # best-effort like the teardown: a metrics bind failure
            # (port taken) is an observability problem — it must not
            # kill the worker and read to the coordinator as a host
            # death burning a fence/rollback cycle
            try:
                # liveness window scaled to THIS fleet's beat cadence:
                # the 3s default reads a healthy slow-beating worker
                # (heartbeat_interval > 1s) as dead between beats
                _obsreg.watch_cluster(
                    self.cluster_dir,
                    heartbeat_timeout=max(
                        3.0, 3.0 * self._hb_writer.interval))
                self._metrics_server = _obsreg.serve_metrics(
                    port=int(self.metrics_port), host=self.metrics_host)
                self._hb_writer.update(
                    metrics_port=self._metrics_server.port)
            except Exception as e:  # noqa: BLE001 — train anyway
                _obsreg.unwatch_cluster(self.cluster_dir)
                if self._metrics_server is not None:
                    try:  # a bound server must not leak its port when
                        # a later setup step (heartbeat publish) raises
                        self._metrics_server.close()
                    except Exception:  # noqa: BLE001
                        pass
                self._metrics_server = None
                import logging
                logging.getLogger(__name__).warning(
                    "worker %s: metrics endpoint unavailable (%s); "
                    "training continues without /metrics",
                    self.worker_id, e)
        self._hb_writer.start()
        fault_plan = _faults.FaultPlan.from_env()
        if fault_plan is not None and _faults.active_plan() is None:
            fault_plan.arm()
        else:
            fault_plan = None
        generations = 0
        try:
            while True:
                plan = self._wait_for_plan(self._processed_gen)
                self._processed_gen = plan["gen"]
                phase = plan.get("phase")
                if phase == "done":
                    break
                if phase == "abort":
                    raise ClusterAborted(
                        "coordinator aborted the job: %s"
                        % plan.get("reason"))
                if phase == "fence":
                    # between generations there is no live state to
                    # snapshot; ack so the cohort can move on. A fence
                    # already acked from inside the generation (where a
                    # barrier save may have stamped saved_step) is NOT
                    # re-acked — re-writing here could clear or
                    # resurrect a stale saved_step under the
                    # coordinator's read.
                    if self.worker_id in plan.get("world", {}) \
                            and plan["gen"] != self._acked_gen:
                        self._acked_gen = plan["gen"]
                        self._hb_writer.update(status="fenced",
                                               gen_acked=plan["gen"],
                                               saved_step=None)
                    continue
                if self.worker_id not in plan.get("world", {}):
                    if generations > 0:
                        # fenced OUT of the cohort (a stalled-heartbeat
                        # worker the coordinator declared dead): leave
                        # in an orderly way instead of training as a
                        # zombie against a world that moved on
                        break
                    continue  # not yet a member: wait for inclusion
                generations += 1
                self._run_generation(plan, num_steps)
        finally:
            if fault_plan is not None:
                fault_plan.disarm()
            self._hb_writer.close("done" if self._done else "left")
            if self._metrics_server is not None:
                try:
                    self._metrics_server.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                self._metrics_server = None
                # drop the heartbeat collector with the endpoint: a
                # process cycling through cluster dirs must not keep
                # reading dead directories on every later render
                _obsreg.unwatch_cluster(self.cluster_dir)
        return {"steps": num_steps if self._done else None,
                "generations": generations}

    # -------------------------------------------------- one generation --
    def _layout_for(self, plan):
        me = plan["world"][self.worker_id]
        return DeviceLayout(
            num_processes=len(plan["world"]),
            process_index=int(me["rank"]),
            local_device_count=me.get("local_device_count"),
            mesh_axes=plan.get("mesh_axes"),
            batch_axis=plan.get("batch_axis", "dp"),
            # the cohort's update-state shard axis (parallel/plan.py)
            # rides the cluster plan so a resharded generation keeps
            # the sharded-update layout the snapshot recorded
            shard_axis=plan.get("shard_axis"),
            # devices the coordinator quarantined on THIS worker (SDC
            # canary convictions): the local mesh is built around them
            skip_local_devices=plan.get("quarantine", {}).get(
                self.worker_id))

    def _run_generation(self, plan, num_steps):
        from ..parallel.parallel_executor import ParallelExecutor
        from ..core.executor import Executor
        gen = plan["gen"]
        layout = self._layout_for(plan)
        rank = layout.process_index
        # tear down the previous world's cached state, install this one
        _dist.shutdown_distributed()
        _dist.init_distributed()  # real rendezvous when env-configured
        _dist.set_active_layout(layout)
        self._hb_writer.update(status="init", gen=gen, rank=rank,
                               layout=layout.to_json())
        scope = Scope()
        mgr = CheckpointManager(self.checkpoint_dir,
                                async_save=self.async_save)
        sup = None
        prev_hook = _exe_mod._barrier_hook
        self._armed_gen = gen
        try:
            with scope_guard(scope):
                built = self.build_fn(layout)
                main, startup = built["main"], built["startup"]
                loss = built["loss"]
                feed_fn = built.get("feed_fn")
                fetch_list = built.get("fetch_list") or [loss]
                # the startup runs on the mesh's first device (the card,
                # or the CPU where the layout lists it)
                mesh = layout.local_mesh()
                exe = Executor(mesh.devices.flat[0])
                exe.run(startup)
                pexe = ParallelExecutor(
                    main_program=main, mesh=mesh,
                    batch_axis=layout.batch_axis,
                    shard_axis=layout.shard_axis,
                    sharded_weight_update=self.sharded_weight_update)
                step = self._restore_or_init(plan, mgr, main, scope,
                                             layout, rank, exe)
                sup = Supervisor(
                    pexe, main, scope=scope, checkpoint_manager=mgr,
                    policies=self.policies,
                    watchdog_timeout=self.watchdog_timeout,
                    bundle_dir=os.path.join(self.cluster_dir, "bundles",
                                            self.worker_id),
                    restore_layout=layout,
                    sentinel=self._make_sentinel(),
                    sdc=self._make_sdc(layout),
                    sdc_every=self.sdc_every)
                sup.step = step
                self._hb_writer.update(status="ok", step=step)
                _exe_mod._barrier_hook = self._barrier_check
                self._train_loop(sup, mgr, plan, main, scope, layout,
                                 rank, feed_fn, fetch_list, num_steps)
        finally:
            _exe_mod._barrier_hook = prev_hook
            self._armed_gen = None
            if sup is not None:
                if sup.sdc is not None:
                    # the reference digest survives the generation; the
                    # next generation's canary compares against it
                    self._sdc_state = sup.sdc.state_dict()
                sup.close()
            try:
                mgr.close()
            except Exception:  # noqa: BLE001 — a failed final save must
                pass           # not mask the loop's own outcome

    def _make_sentinel(self):
        if not self.sentinel_opts:
            return None
        opts = (dict(self.sentinel_opts)
                if isinstance(self.sentinel_opts, dict) else {})
        return TrainingSentinel(**opts)

    def _make_sdc(self, layout):
        """This generation's canary checker: rotation over exactly the
        devices the generation's mesh uses (quarantined chips excluded
        — a convicted device is neither trained on nor re-canaried),
        reference digest carried over from the previous generation."""
        if not self.sdc_opts:
            self._sdc_device_map = None
            return None
        opts = dict(self.sdc_opts) if isinstance(self.sdc_opts, dict) \
            else {}
        # the layout's own device list (its local devices before the
        # quarantine), where the JAX package counts jax.devices()
        skip = set(layout.skip_local_devices)
        usable = [i for i in range(len(layout._all_devices()))
                  if i not in skip]
        mesh_n = layout.resolved_local_device_count()
        # rotation index -> GLOBAL local-device index: the quarantine
        # list the coordinator keeps is in global indices, so an SDC
        # escalation must translate before stamping sdc_device
        self._sdc_device_map = usable[:mesh_n]
        canary = CanaryChecker(
            devices=layout.local_devices()[:mesh_n], **opts)
        if self._sdc_state:
            canary.load_state_dict(self._sdc_state)
        return canary

    def _restore_or_init(self, plan, mgr, main, scope, layout, rank, exe):
        """Land the generation's starting state: the plan's pinned
        snapshot resharded onto this layout — or, on a fresh cluster
        (no snapshot yet), rank 0 publishes the post-startup state as
        step 0 and everyone else restores it, so every member starts
        from IDENTICAL bits no matter how its local init behaved."""
        del exe
        restore_step = plan.get("restore_step")
        if restore_step is not None:
            mgr.restore(program=main, scope=scope,
                        step=int(restore_step), layout=layout)
            return int(restore_step)
        if rank == 0:
            mgr.save(0, program=main, scope=scope, layout=layout,
                     wait=True)
            mgr.restore(program=main, scope=scope, step=0, layout=layout)
            return 0
        t0 = time.monotonic()
        while find_valid_snapshot(self.checkpoint_dir, step=0) is None:
            if time.monotonic() - t0 > self.plan_timeout:
                raise ClusterAborted(
                    "worker %s: rank 0 never published the step-0 "
                    "snapshot" % self.worker_id)
            time.sleep(self.poll_interval)
        mgr.restore(program=main, scope=scope, step=0, layout=layout)
        return 0

    def _train_loop(self, sup, mgr, plan, main, scope, layout, rank,
                    feed_fn, fetch_list, num_steps):
        gen = plan["gen"]
        while sup.step < num_steps:
            newp = self._current_plan()
            if newp is not None and newp["gen"] != gen:
                self._on_generation_change(newp, sup, mgr, main, scope,
                                           layout, rank)
                return
            idx = sup.step
            feed = feed_fn(idx) if feed_fn is not None else None
            try:
                out = sup.run_step(feed=feed, fetch_list=fetch_list)
            except ClusterFenced:
                continue  # loop top re-reads the plan and handles it
            except EOFException:
                break
            except (TrainingAborted, DispatchTimeoutError) as e:
                self._escalate_cluster_fault(e, gen)
                return
            if out is not None and sup.step > idx \
                    and self.record_results:
                self._record(gen, idx, out)
            hb_extra = {}
            if sup.sentinel is not None:
                # last z-scores / spike count ride the heartbeat so
                # `ptpu_elastic status` shows WHY a worker fenced
                hb_extra["sentinel"] = sup.sentinel.status()
            if sup.sdc is not None:
                hb_extra["sdc"] = sup.sdc.status()
            self._hb_writer.update(
                status="ok", step=sup.step, gen=gen,
                watchdog=self.watchdog_timeout,
                reader_positions=self._reader_positions(main, scope),
                **hb_extra)
            if rank == 0 and self.checkpoint_every \
                    and sup.step % int(self.checkpoint_every) == 0:
                # re-check the fence right before writing: a fenced-out
                # zombie (stalled heartbeat, still training) must not
                # keep publishing snapshots over the new cohort's
                cur = self._current_plan()
                if cur is not None and cur["gen"] == gen:
                    mgr.save(sup.step, program=main, scope=scope,
                             layout=layout)
            if self.step_delay > 0:
                time.sleep(self.step_delay)
        # reached num_steps (or clean EOF): publish the final state so
        # a later joiner (or a restarted cluster) resumes from it
        if rank == 0:
            mgr.save(sup.step, program=main, scope=scope, layout=layout,
                     wait=True)
        self._done = True
        self._hb_writer.update(status="done", step=sup.step, gen=gen)

    def _on_generation_change(self, newp, sup, mgr, main, scope, layout,
                              rank):
        """A newer plan landed mid-generation. For a fence: snapshot if
        asked (rank 0, save_step — the grow barrier) and ack; the outer
        loop then waits for the run-phase plan. Any other phase is
        simply left for the outer loop to process."""
        if newp.get("phase") == "fence" \
                and self.worker_id in newp.get("world", {}):
            fields = {"status": "fenced", "gen_acked": newp["gen"],
                      "step": sup.step, "saved_step": None}
            # the barrier save falls to the ACTING rank 0 — the lowest
            # rank in the FENCE's world, not literal rank==0: when the
            # old rank 0 died mid-fence, the restarted fence's world no
            # longer contains it, and without this the grow would find
            # no saved_step and silently degrade into a rollback to the
            # newest (possibly ancient) snapshot
            del rank
            me = newp["world"].get(self.worker_id) or {}
            ranks = [int(v.get("rank", 1 << 30))
                     for v in newp["world"].values()]
            if newp.get("save_step") and ranks \
                    and me.get("rank") == min(ranks):
                mgr.save(sup.step, program=main, scope=scope,
                         layout=layout, wait=True)
                fields["saved_step"] = sup.step
            self._acked_gen = newp["gen"]
            self._hb_writer.update(**fields)

    def _escalate_cluster_fault(self, exc, gen):
        """A fault the local chain could not (or must not) absorb — the
        wedged-dispatch case, and SDC convictions (a bad chip cannot be
        fixed in-process). Report it cluster-level and wait for the
        coordinator's fence; the cohort rolls back together. An SDC
        fault additionally stamps `sdc_device` (the GLOBAL local-device
        index of the convicted chip) so the coordinator quarantines the
        device rather than treating this as a whole-host problem."""
        fields = {"status": "fault", "gen": gen, "fault": repr(exc)}
        for e in (exc, getattr(exc, "cause", None),
                  getattr(exc, "__cause__", None)):
            if isinstance(e, SilentCorruptionError) \
                    and e.device_index is not None:
                dev = int(e.device_index)
                if self._sdc_device_map \
                        and dev < len(self._sdc_device_map):
                    dev = int(self._sdc_device_map[dev])
                fields["sdc_device"] = dev
                break
        self._hb_writer.update(**fields)
        t0 = time.monotonic()
        while True:
            plan = self._current_plan()
            if plan is not None and plan["gen"] != gen:
                return  # outer loop processes the new plan
            if time.monotonic() - t0 > self.plan_timeout:
                raise exc
            time.sleep(self.poll_interval)

    # --------------------------------------------------------- helpers --
    def _reader_positions(self, program, scope):
        out = {}
        for op in program.global_block().ops:
            if op.type != "read":
                continue
            name = op.inputs["Reader"][0]
            state = scope.get(name)
            consumed = getattr(state, "_consumed", None)
            if consumed is not None:
                out[name] = int(consumed)
        return out

    def _record(self, gen, step, fetches):
        val = float(np.asarray(fetches[0]).reshape(-1)[0])
        path = os.path.join(self.cluster_dir,
                            "results_%s.jsonl" % self.worker_id)
        with open(path, "a") as f:
            f.write(json.dumps({"gen": gen, "step": int(step),
                                "value": val}) + "\n")
