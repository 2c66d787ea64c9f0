"""ptpu_elastic — launch, kill and replace elastic training workers.

The operational front end of paddle_tpu_torch.resilience.cluster (parity:
the JAX package's tools/ptpu_elastic.py, the same subcommands, flags,
environment, exit codes and `[ptpu_elastic] done: {...}` line): spawns a
cohort of worker processes, runs the ClusterCoordinator over them
(heartbeat monitoring, fence/rollback/reshard on host death, grow on
replacement join), and optionally replaces dead workers so the mesh
grows back.

    # 2 workers, built-in demo MLP, kill worker 1 at step 10 via the
    # fault registry, spawn a replacement once the cohort rescales:
    python -m paddle_tpu_torch.tools.ptpu_elastic launch \
        --cluster-dir /tmp/el --workers 2 --steps 40 --demo \
        --host-devices 4 --total-devices 4 \
        --fault-worker 1 --fault-plan host_death@10 --replace

    # the same module is the demo worker entry point (spawned per
    # worker by `launch --demo`):
    python -m paddle_tpu_torch.tools.ptpu_elastic worker \
        --cluster-dir /tmp/el --worker-id w0 --steps 40

Workers train on the card. `--host-devices N` makes each worker see its
one device N times (PTPU_HOST_DEVICES=N: `cuda:0` on a card, the CPU
where there is none), the port's counterpart of the JAX launcher's N
virtual XLA CPU devices.

Custom trainers: point --worker-cmd at any script that constructs an
`ElasticWorker` (see the demo_build in this file for the build_fn
shape); the launcher hands it PTPU_CLUSTER_DIR / PTPU_WORKER_ID /
PTPU_ELASTIC_STEPS via env.

Exit codes: 0 = the cohort finished training; 1 = ClusterAborted (the
merged diagnostic bundle path is printed); 2 = usage error.
"""
import argparse
import json
import os
import subprocess
import sys
import threading

from paddle_tpu_torch.parallel.distributed import HOST_DEVICES_ENV

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "paddle_tpu_torch.tools.ptpu_elastic"


# ------------------------------------------------------------ demo model --
def demo_build(layout):
    """The built-in demo trainer: a deterministic feed-fed MLP (Adam +
    dropout, so the snapshot seed cursor is load-bearing). Batch 8 —
    divisible across any dp size the demo meshes use."""
    import numpy as np
    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="tanh")
        h = fluid.layers.dropout(h, dropout_prob=0.1)
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    rng = np.random.RandomState(5)
    data = [rng.rand(8, 6).astype("float32") for _ in range(32)]

    def feed_fn(i):
        xb = data[i % len(data)]
        return {"x": xb, "y": xb[:, :1].copy()}

    del layout  # the demo trains the same program at every mesh shape
    return {"main": main, "startup": startup, "loss": loss,
            "feed_fn": feed_fn}


def cmd_worker(args):
    from paddle_tpu_torch.resilience.cluster import (ClusterAborted,
                                                     ElasticWorker)
    worker = ElasticWorker(
        args.cluster_dir, args.worker_id, demo_build,
        checkpoint_every=args.checkpoint_every,
        watchdog_timeout=args.watchdog_timeout,
        sharded_weight_update=args.sharded_weight_update,
        step_delay=args.step_delay,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        sentinel=bool(args.sentinel) or None,
        sdc=bool(args.sdc_every) or None,
        sdc_every=args.sdc_every or 64)
    try:
        out = worker.run(args.steps)
    except ClusterAborted as e:
        print("worker %s: %s" % (args.worker_id, e), file=sys.stderr)
        return 1
    print("worker %s finished: %s" % (args.worker_id, out))
    return 0


def cmd_status(args):
    """The fleet gauge table: every worker's
    heartbeat-derived status — step cursor, generation acked, beat age,
    steps behind the cohort's front-runner — plus the current plan.
    Exactly the gauges the observability registry exports as
    `ptpu_cluster_worker_*` when a worker serves /metrics."""
    from paddle_tpu_torch.resilience import heartbeat as hb
    from paddle_tpu_torch.resilience.cluster import read_plan
    # scale the staleness window to the fleet's own published beat
    # cadence (heartbeats carry `interval`) — but an operator's
    # EXPLICIT --heartbeat-timeout always wins, tighter or looser
    # (default None = auto)
    if args.heartbeat_timeout is not None:
        timeout = args.heartbeat_timeout
    else:
        intervals = [float(b.get("interval", 0) or 0) for b in
                     hb.read_heartbeats(args.cluster_dir).values()]
        timeout = max([3.0] + [3.0 * i for i in intervals])
    mon = hb.HeartbeatMonitor(args.cluster_dir, timeout=timeout)
    # ONE derivation, shared with the registry's cluster collector
    # (HeartbeatMonitor.fleet_view) — this table and the exported
    # ptpu_cluster_worker_* gauges can never disagree
    rows = mon.fleet_view()
    for r in rows:
        r["beat_age_s"] = round(r["beat_age_s"], 3)
    plan = read_plan(args.cluster_dir)
    quarantine = (plan or {}).get("quarantine") or {}
    if args.json:
        print(json.dumps({
            "plan": None if plan is None else {
                "gen": plan.get("gen"), "phase": plan.get("phase"),
                "num_workers": plan.get("num_workers"),
                "restore_step": plan.get("restore_step"),
                "quarantine": quarantine},
            "workers": rows}, indent=1, sort_keys=True))
        return 0
    if plan is not None:
        print("plan: gen %s phase %s world=%d restore_step=%s%s"
              % (plan.get("gen"), plan.get("phase"),
                 plan.get("num_workers"), plan.get("restore_step"),
                 " quarantine=%s" % json.dumps(quarantine,
                                               sort_keys=True)
                 if quarantine else ""))
    else:
        print("plan: none published yet")
    if not rows:
        print("no heartbeats under %s" % args.cluster_dir)
        return 0
    hdr = "%-8s %-8s %-6s %6s %7s %5s %6s %9s %8s %7s %7s %6s" % (
        "WORKER", "STATUS", "ALIVE", "STEP", "BEHIND", "GEN",
        "ACKED", "BEAT_AGE", "METRICS", "LOSS_Z", "SPIKES", "QUAR")
    print(hdr)
    for r in rows:
        sent = r.get("sentinel") or {}
        z = sent.get("z")
        qdevs = quarantine.get(r["worker"]) or []
        print("%-8s %-8s %-6s %6s %7s %5d %6d %7.2fs %8s %7s %7s %6s"
              % (r["worker"], r["status"], r["alive"], r["step"],
                 "-" if r["steps_behind"] is None else r["steps_behind"],
                 r["gen"], r["gen_acked"], r["beat_age_s"],
                 r["metrics_port"] or "-",
                 "-" if z is None else "%.1f" % z,
                 sent.get("spikes", "-") if sent else "-",
                 ",".join(str(d) for d in qdevs) if qdevs else "-"))
        # a faulted worker's WHY, when it escalated one (the sentinel/
        # canary message is the operator's first clue)
        if r.get("fault") and r.get("status") == "fault":
            extra = ""
            if r.get("sdc_device") is not None:
                extra = " [sdc_device=%s]" % r["sdc_device"]
            print("  `- fault: %.100s%s" % (r["fault"], extra))
    return 0


# -------------------------------------------------------------- launcher --
class _WorkerPool(object):
    """Child-process bookkeeping: spawn, kill, replace."""

    def __init__(self, args):
        self.args = args
        self.procs = {}   # worker_id -> Popen
        self._next = 0
        self._lock = threading.Lock()

    def _worker_env(self, worker_id, with_fault, metrics_port=None):
        env = dict(os.environ)
        env["PTPU_CLUSTER_DIR"] = self.args.cluster_dir
        env["PTPU_WORKER_ID"] = worker_id
        env["PTPU_ELASTIC_STEPS"] = str(self.args.steps)
        if metrics_port is not None:
            # custom --worker-cmd workers read this env default; the
            # built-in worker also gets the explicit flag below
            env["PTPU_METRICS_PORT"] = str(metrics_port)
        else:
            env.pop("PTPU_METRICS_PORT", None)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        if self.args.host_devices:
            env[HOST_DEVICES_ENV] = str(self.args.host_devices)
        if with_fault and self.args.fault_plan:
            env["PTPU_FAULT_PLAN"] = self.args.fault_plan
        else:
            env.pop("PTPU_FAULT_PLAN", None)
        return env

    def spawn(self, with_fault=False):
        with self._lock:
            idx = self._next
            worker_id = "w%d" % idx
            self._next += 1
        metrics_port = None
        if getattr(self.args, "metrics_port_base", None):
            metrics_port = int(self.args.metrics_port_base) + idx
        if self.args.worker_cmd:
            cmd = self.args.worker_cmd.split() + [
                "--cluster-dir", self.args.cluster_dir,
                "--worker-id", worker_id, "--steps", str(self.args.steps)]
        else:
            cmd = [sys.executable, "-m", MODULE, "worker",
                   "--cluster-dir", self.args.cluster_dir,
                   "--worker-id", worker_id,
                   "--steps", str(self.args.steps),
                   "--checkpoint-every", str(self.args.checkpoint_every)]
            if self.args.watchdog_timeout:
                cmd += ["--watchdog-timeout",
                        str(self.args.watchdog_timeout)]
            if self.args.sharded_weight_update:
                cmd += ["--sharded-weight-update"]
            if self.args.step_delay:
                cmd += ["--step-delay", str(self.args.step_delay)]
            if metrics_port is not None:
                cmd += ["--metrics-port", str(metrics_port)]
            if getattr(self.args, "sentinel", False):
                cmd += ["--sentinel"]
            if getattr(self.args, "sdc_every", 0):
                cmd += ["--sdc-every", str(self.args.sdc_every)]
        proc = subprocess.Popen(cmd,
                                env=self._worker_env(
                                    worker_id, with_fault,
                                    metrics_port=metrics_port))
        self.procs[worker_id] = proc
        # reap immediately on exit: a SIGKILL'd worker must not linger
        # as a zombie pid the heartbeat monitor reads as alive
        threading.Thread(target=proc.wait, daemon=True).start()
        print("[ptpu_elastic] spawned %s (pid %d%s)"
              % (worker_id, proc.pid,
                 ", fault plan armed" if with_fault
                 and self.args.fault_plan else ""))
        return worker_id

    def kill_all(self):
        for wid, p in self.procs.items():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — shutdown best-effort
                pass


def cmd_launch(args):
    from paddle_tpu_torch.resilience.cluster import (ClusterAborted,
                                                     ClusterCoordinator)
    os.makedirs(args.cluster_dir, exist_ok=True)
    pool = _WorkerPool(args)
    replaced = {"n": 0}

    def on_event(ev):
        # the "replace a dead host" operator action, automated: once the
        # cohort has rescaled around a death, spawn a fresh worker — the
        # coordinator grows the mesh back at a step barrier
        if args.replace and ev.get("event") == "rescale" \
                and replaced["n"] < args.max_replacements:
            replaced["n"] += 1
            pool.spawn(with_fault=False)

    coord = ClusterCoordinator(
        args.cluster_dir, num_workers=args.workers,
        heartbeat_timeout=args.heartbeat_timeout,
        total_device_count=args.total_devices,
        local_device_count=args.local_devices,
        max_rescales=args.max_rescales,
        on_event=on_event)
    for i in range(args.workers):
        pool.spawn(with_fault=(i == args.fault_worker))
    try:
        summary = coord.run(deadline=args.deadline)
    except ClusterAborted as e:
        print("[ptpu_elastic] ABORTED: %s" % e, file=sys.stderr)
        if e.bundle:
            print("[ptpu_elastic] merged bundle: %s" % e.bundle,
                  file=sys.stderr)
        return 1
    finally:
        pool.kill_all()
    print("[ptpu_elastic] done: %s" % json.dumps(
        {"gen": summary["gen"], "steps": summary["steps"],
         "rescales": coord.rescales,
         "events": [e["event"] for e in summary["events"]]}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ptpu_elastic",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd")

    lp = sub.add_parser("launch", help="spawn a cohort + coordinator")
    lp.add_argument("--cluster-dir", required=True)
    lp.add_argument("--workers", type=int, default=2)
    lp.add_argument("--steps", type=int, default=40)
    lp.add_argument("--demo", action="store_true",
                    help="use the built-in demo MLP worker (default "
                         "when --worker-cmd is not given)")
    lp.add_argument("--worker-cmd", default=None,
                    help="custom worker command (gets --cluster-dir/"
                         "--worker-id/--steps appended)")
    lp.add_argument("--host-devices", type=int, default=None,
                    help="local devices per worker process: its one "
                         "device this many times (PTPU_HOST_DEVICES)")
    lp.add_argument("--total-devices", type=int, default=None,
                    help="fixed cluster chip budget re-split across the "
                         "live cohort (shrink => each survivor's mesh "
                         "grows)")
    lp.add_argument("--local-devices", type=int, default=None,
                    help="fixed local mesh size per worker")
    lp.add_argument("--checkpoint-every", type=int, default=4)
    lp.add_argument("--watchdog-timeout", type=float, default=None)
    lp.add_argument("--sharded-weight-update", action="store_true")
    lp.add_argument("--step-delay", type=float, default=0.0,
                    help="demo-worker pacing: sleep per step (gives a "
                         "replacement worker time to join mid-run)")
    lp.add_argument("--heartbeat-timeout", type=float, default=3.0)
    lp.add_argument("--max-rescales", type=int, default=8)
    lp.add_argument("--fault-plan", default=None,
                    help="PTPU_FAULT_PLAN spec armed in ONE worker "
                         "(e.g. host_death@10)")
    lp.add_argument("--fault-worker", type=int, default=-1,
                    help="index of the worker that gets --fault-plan")
    lp.add_argument("--replace", action="store_true",
                    help="spawn a replacement worker after each rescale")
    lp.add_argument("--max-replacements", type=int, default=1)
    lp.add_argument("--deadline", type=float, default=None,
                    help="abort the whole run after this many seconds")
    lp.add_argument("--metrics-port-base", type=int, default=None,
                    help="serve each worker's /metrics (observability "
                         "registry incl. fleet gauges) on base+index")
    lp.add_argument("--sentinel", action="store_true",
                    help="arm the training-health sentinel in every "
                         "demo worker (loss-spike rollback_skip_data, "
                         "divergence detection)")
    lp.add_argument("--sdc-every", type=int, default=0,
                    help="run the SDC canary every N steps in every "
                         "demo worker (0 = off); a conviction "
                         "quarantines the device")
    lp.set_defaults(fn=cmd_launch)

    sp = sub.add_parser("status", help="fleet gauge table from "
                                       "heartbeats")
    sp.add_argument("--cluster-dir", required=True)
    sp.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="staleness window (default: 3x the fleet's "
                         "published beat interval, floor 3s)")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_status)

    wp = sub.add_parser("worker", help="built-in demo worker")
    wp.add_argument("--cluster-dir",
                    default=os.environ.get("PTPU_CLUSTER_DIR"))
    wp.add_argument("--worker-id",
                    default=os.environ.get("PTPU_WORKER_ID"))
    wp.add_argument("--steps", type=int,
                    default=int(os.environ.get("PTPU_ELASTIC_STEPS",
                                               "40")))
    wp.add_argument("--checkpoint-every", type=int, default=4)
    wp.add_argument("--watchdog-timeout", type=float, default=None)
    wp.add_argument("--sharded-weight-update", action="store_true")
    wp.add_argument("--step-delay", type=float, default=0.0)
    wp.add_argument("--metrics-port", type=int,
                    default=(int(os.environ["PTPU_METRICS_PORT"])
                             if os.environ.get("PTPU_METRICS_PORT")
                             else None),
                    help="serve the observability registry's /metrics "
                         "on this port (0 = pick free)")
    wp.add_argument("--metrics-host", default="127.0.0.1",
                    help="bind address for /metrics (0.0.0.0 for a "
                         "remote scraper; the heartbeat's host field "
                         "names the machine)")
    wp.add_argument("--sentinel", action="store_true",
                    help="arm the training-health sentinel")
    wp.add_argument("--sdc-every", type=int, default=0,
                    help="SDC canary cadence in steps (0 = off)")
    wp.set_defaults(fn=cmd_worker)

    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2
    if args.cmd == "worker" and (not args.cluster_dir
                                 or not args.worker_id):
        ap.error("worker needs --cluster-dir and --worker-id "
                 "(or PTPU_CLUSTER_DIR / PTPU_WORKER_ID)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
