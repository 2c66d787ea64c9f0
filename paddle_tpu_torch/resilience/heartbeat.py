"""Worker heartbeats: the cluster Supervisor's liveness channel.

Parity: the JAX package's resilience/heartbeat.py, copied (pure Python):
the same file names and JSON payloads written by the same
`core/utils.atomic_write_json`, so a cluster directory written by either
package reads in the other. `resilience.cluster.ClusterCoordinator`
consumes them, an `ElasticWorker` writes them, and
`observability.registry.watch_cluster` renders them.

Each elastic worker runs ONE `HeartbeatWriter` thread that periodically
publishes a small JSON payload — step cursor, lifecycle status, the
plan generation it has acknowledged, watchdog state, reader positions —
to `hb_<worker_id>.json` under the cluster directory (a shared
filesystem, the same trust the checkpoint root already carries). Writes
are atomic (tmp + os.replace), so a reader never sees a torn payload;
each carries a monotonically increasing `seq` and the writer's
wall-clock time.

The coordinator side (`HeartbeatMonitor`) reads every heartbeat file
and classifies each worker:

  alive    — fresh payload (age <= timeout) with a live status
  dead     — payload older than the timeout, or (same host) the
             recorded pid no longer exists: SIGKILL'd, OOM'd, wedged
             hard enough that even the beat thread stopped. A worker
             whose last word was "done"/"left" is finished, not dead.
  fault    — the worker itself reported a cluster-level fault (e.g. a
             DispatchTimeoutError it chose to escalate instead of
             handling locally); it is still responsive.

Fault injection: an armed FaultPlan with a `heartbeat_stall@N` entry
makes `beat()` skip writes once the plan's step cursor passes N
(resilience/faults.py) — the deterministic way to prove the missed-
heartbeat detection path without actually wedging a process.
"""
import json
import os
import socket
import threading
import time

from ..core.utils import atomic_write_json as _atomic_write_json
from . import faults as _faults

__all__ = ["HeartbeatWriter", "HeartbeatMonitor", "read_heartbeats",
           "heartbeat_path", "HB_PREFIX"]

HB_PREFIX = "hb_"

# lifecycle statuses a worker publishes; "done"/"left" are terminal and
# exempt from staleness (a finished worker stops beating by design)
TERMINAL_STATUSES = ("done", "left")


def heartbeat_path(cluster_dir, worker_id):
    return os.path.join(cluster_dir, "%s%s.json" % (HB_PREFIX, worker_id))


class HeartbeatWriter(object):
    """One worker's beat thread. `update(**fields)` changes the payload
    and beats immediately (acks must not wait an interval); the thread
    re-beats every `interval` seconds so the coordinator sees liveness
    even while the training loop is inside a long dispatch."""

    def __init__(self, cluster_dir, worker_id, interval=0.2):
        self.cluster_dir = str(cluster_dir)
        self.worker_id = str(worker_id)
        self.path = heartbeat_path(cluster_dir, worker_id)
        self.interval = float(interval)
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._payload = {"worker_id": self.worker_id,
                         "pid": os.getpid(),
                         "host": socket.gethostname(),
                         "status": "joining",
                         "step": -1,
                         "gen": 0,
                         "gen_acked": 0,
                         # published so liveness readers that don't set
                         # a timeout (a status tool) can scale
                         # their staleness window to THIS fleet's beat
                         # cadence instead of a fixed default
                         "interval": self.interval}
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(self.cluster_dir, exist_ok=True)

    # ----------------------------------------------------------- write --
    def beat(self):
        """Publish the current payload atomically. Honors an armed
        fault plan's heartbeat stall (the injected 'wedged host')."""
        plan = _faults.active_plan()
        if plan is not None and plan.heartbeat_stalled():
            return False
        # one write at a time: the beat thread and an update() from the
        # training loop share the pid-named tmp file of the atomic write,
        # and two writers at once could replace the beat with a torn
        # document the monitor cannot read (a live worker read as dead)
        with self._write_lock:
            with self._lock:
                self._seq += 1
                payload = dict(self._payload, seq=self._seq,
                               wall_time=time.time())
            try:
                # liveness signal, not durable state: no fsync (beats
                # fire every fraction of a second; a lost-on-power-cut
                # beat is indistinguishable from a missed one)
                _atomic_write_json(self.path, payload)
            except OSError:
                return False  # a missed beat is survivable; a crash is not
        return True

    def update(self, **fields):
        """Merge `fields` into the payload and beat NOW (plan acks and
        status transitions must reach the coordinator promptly)."""
        with self._lock:
            self._payload.update(fields)
        return self.beat()

    def snapshot(self):
        with self._lock:
            return dict(self._payload)

    # ------------------------------------------------------- lifecycle --
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="ptpu-heartbeat-%s" % self.worker_id)
            self._thread.start()
        self.beat()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def close(self, status="left"):
        """Stop the thread and publish one final terminal beat, so the
        coordinator reads an orderly departure instead of a death."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval + 1.0)
        if status:
            self.update(status=status)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def _is_zombie(pid):
    """Linux: a SIGKILL'd child whose parent has not reaped it yet is
    state 'Z' in /proc/<pid>/stat — dead for every purpose that
    matters here. Platforms without /proc answer False (the staleness
    timeout still catches the death)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            fields = f.read()
        # state is the first field after the parenthesized comm (which
        # may itself contain spaces/parens)
        return fields.rpartition(")")[2].split()[0] == "Z"
    except (OSError, IndexError):
        return False


# ------------------------------------------------------------- monitor --
def read_heartbeats(cluster_dir):
    """{worker_id: payload} for every parseable heartbeat file. A
    half-written or vanished file is skipped (atomic replace makes that
    a transient, not a corruption)."""
    out = {}
    try:
        entries = os.listdir(cluster_dir)
    except OSError:
        return out
    for e in entries:
        if not e.startswith(HB_PREFIX) or not e.endswith(".json"):
            continue
        try:
            with open(os.path.join(cluster_dir, e)) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        wid = payload.get("worker_id")
        if wid:
            out[wid] = payload
    return out


class HeartbeatMonitor(object):
    """Coordinator-side view over the heartbeat directory."""

    def __init__(self, cluster_dir, timeout=3.0):
        self.cluster_dir = str(cluster_dir)
        self.timeout = float(timeout)
        self._host = socket.gethostname()

    def poll(self):
        """{worker_id: payload} with `age` and `alive` folded in."""
        now = time.time()
        beats = read_heartbeats(self.cluster_dir)
        for wid, hb in beats.items():
            hb["age"] = max(0.0, now - float(hb.get("wall_time", 0.0)))
            hb["alive"] = self._alive(hb)
        return beats

    def _alive(self, hb):
        if hb.get("status") in TERMINAL_STATUSES:
            return True  # finished, not dead — staleness is expected
        # same-host fast path: a SIGKILL'd worker is detected the
        # instant its pid vanishes, not a heartbeat-timeout later. A
        # zombie (dead but not yet reaped by its parent) still answers
        # kill(pid, 0) — on Linux, /proc exposes the truth.
        pid = hb.get("pid")
        if pid and hb.get("host") == self._host:
            try:
                os.kill(int(pid), 0)
                if _is_zombie(int(pid)):
                    return False
            except ProcessLookupError:
                return False
            except OSError:
                pass  # EPERM etc: alive under another uid
        return hb["age"] <= self.timeout

    def fleet_view(self):
        """The fleet gauge rows derived from the heartbeats, one
        implementation for a status tool and the observability
        registry's cluster collector: per worker the lifecycle status,
        liveness (the monitor's staleness/pid verdict), step cursor,
        steps behind the cohort's front-runner (None when the worker
        never reported a step), plan generations, beat age, the metrics
        port it published (if any), and the training-health fields: the
        worker's last sentinel status dict (z-scores, spike count),
        canary status dict, the fault repr a faulted worker escalated
        with, and the `sdc_device` a canary conviction named."""
        beats = self.poll()
        # the front-runner is the furthest LIVE, still-participating
        # worker: a dead worker's stale file (nothing ever deletes it)
        # or a finished worker's terminal beat would otherwise pin
        # `front` past a rollback forever and every healthy worker
        # would read permanently behind
        live_steps = [int(b.get("step", -1)) for b in beats.values()
                      if int(b.get("step", -1)) >= 0 and b.get("alive")
                      and b.get("status") not in TERMINAL_STATUSES]
        front = max(live_steps) if live_steps else 0
        rows = []
        for wid, b in sorted(beats.items()):
            step = int(b.get("step", -1))
            rows.append({
                "worker": wid,
                "status": b.get("status"),
                "alive": bool(b.get("alive")),
                "step": step,
                "steps_behind": (max(0, front - step)
                                 if step >= 0 else None),
                "gen": int(b.get("gen", 0) or 0),
                "gen_acked": int(b.get("gen_acked", 0) or 0),
                "beat_age_s": float(b.get("age", 0.0)),
                "metrics_port": b.get("metrics_port"),
                "sentinel": b.get("sentinel"),
                "sdc": b.get("sdc"),
                "fault": b.get("fault"),
                "sdc_device": b.get("sdc_device"),
            })
        return rows

    def dead_workers(self, expected=None):
        """worker_ids considered dead: stale/vanished-pid heartbeats,
        plus any `expected` id that never wrote a heartbeat at all."""
        beats = self.poll()
        dead = [wid for wid, hb in beats.items() if not hb["alive"]]
        for wid in expected or ():
            if wid not in beats:
                dead.append(wid)
        return sorted(set(dead))
