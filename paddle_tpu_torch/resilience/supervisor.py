"""Supervisor: the recovery policy engine around the training dispatch.

Parity: the JAX package's resilience/supervisor.py (the same classes,
chains, actions and event log). The port's Executor is recognised by
type (it has `.device`, not the JAX executor's `.place`), so it never
takes the parallel executor's branch; a parallel.ParallelExecutor does.
`restore_layout=` reshards every rollback onto a device mesh. Cut here:
the profiler rows of each action wait for A11's profiler.

The TensorFlow-paper stance (arXiv:1605.08695) made concrete: detection
(device guards, hang watchdog, reader fault channel, host divergence) is
only half of fault tolerance — something must DECIDE. The Supervisor
owns the training loop and, per fault CLASS, applies a configured
escalation chain of actions:

    classes:  numeric   — NumericalGuardError (device guard trip) or
                          DivergenceFault (host EMA spike)
              hang      — DispatchTimeoutError (per-dispatch watchdog)
              reader    — reader-tagged failures (worker-thread errors,
                          injected reader faults)
              dispatch  — everything else raised by the dispatch
    actions:  skip_batch(times=)        exact for guard trips (updates
                                        were gated on device) and for
                                        reader faults (records dropped
                                        at known positions)
              retry(times=, backoff=)   re-attempt the same step
              rollback(times=, lr_scale=)  restore the newest valid
                                        snapshot — params,
                                        accumulators, seed cursor,
                                        reader positions — then
                                        optionally damp the LR; a
                                        repeat rollback with no
                                        progress walks back a snapshot
              abort(bundle_dir=)        capture a diagnostic bundle and
                                        raise TrainingAborted

Every action lands in the structured event log (`sup.events`), in the
flight recorder (`resilience/<class>:<action>` instants) and in the
`ptpu_supervisor_events_total` counter.
Budgets are consumed per class; when a chain runs dry the terminal
action is abort. Recovered-from faults leave training bit-exact where
the mechanism allows it (tests/test_torch_resilience.py pins this):
a rollback-resumed run equals the fault-free run, and a skipped bad
batch equals a fault-free run that skipped the same batch.
"""
import collections
import time

import numpy as np

from ..observability import registry as _obsreg
from ..observability import trace as _otrace
from ..core import readers as _readers
from ..core.executor import (DispatchTimeoutError, Executor,
                             NumericalGuardError, global_scope, to_numpy)
from ..core.readers import EOFException
from . import faults as _faults
from . import watchdog as _watchdog
from .guards import DivergenceFault
from .sentinel import DivergenceError, LossSpikeError
from .sdc import SilentCorruptionError

__all__ = ["Supervisor", "TrainingAborted", "Action",
           "skip_batch", "retry", "rollback", "rollback_skip_data",
           "abort", "DEFAULT_POLICIES", "FAULT_CLASSES"]

FAULT_CLASSES = ("numeric", "hang", "reader", "dispatch",
                 "loss_spike", "divergence", "sdc")


class TrainingAborted(RuntimeError):
    """Terminal escalation: the configured chains are exhausted (or an
    abort action was reached). `bundle` is the diagnostic-bundle path
    when one was captured (feed ptpu_doctor.py), `cause` the original
    fault."""

    def __init__(self, message, bundle=None, cause=None):
        super(TrainingAborted, self).__init__(message)
        self.bundle = bundle
        self.cause = cause


class Action(object):
    """One escalation-chain entry. `times` is the per-class budget this
    action absorbs before the chain escalates past it."""

    __slots__ = ("kind", "times", "backoff", "lr_scale", "bundle_dir",
                 "skip")

    def __init__(self, kind, times=1, backoff=0.0, lr_scale=None,
                 bundle_dir=None, skip=0):
        self.kind = kind
        self.times = max(1, int(times))
        self.backoff = float(backoff)
        self.lr_scale = lr_scale
        self.bundle_dir = bundle_dir
        self.skip = max(0, int(skip))

    def __repr__(self):
        return "Action(%s, times=%d)" % (self.kind, self.times)


def skip_batch(times=1):
    """Drop the offending batch and move on. Exact for device-guard
    trips (the step's updates were already gated off on device) and for
    reader faults (the batch's records are consumed at known reader
    positions); best-effort for hang/dispatch faults."""
    return Action("skip_batch", times=times)


def retry(times=1, backoff=0.0):
    """Re-attempt the same step after `backoff` seconds (transient
    dispatch failures, brief stalls)."""
    return Action("retry", times=times, backoff=backoff)


def rollback(times=1, lr_scale=None):
    """Restore the newest valid checkpoint snapshot (full training
    state: params, accumulators, seed cursor, reader positions) and
    resume from it; `lr_scale` damps every persistable learning-rate
    var on re-entry (optimizer.scale_learning_rate)."""
    return Action("rollback", times=times, lr_scale=lr_scale)


def rollback_skip_data(times=1, skip=0, lr_scale=None):
    """The PaLM-style bad-batch remedy: restore the newest valid
    snapshot AND advance every in-graph reader stream past the
    offending batch window — the records the faulted attempt (and
    everything since the snapshot) consumed, plus `skip` further
    K-blocks for margin. The resumed run is bit-exact vs a from-scratch
    resume over a stream that never contained those records
    (tests/test_torch_sentinel.py pins this). A feed-fed program
    (no readers) degrades to a plain rollback with a logged note."""
    return Action("rollback_skip", times=times, skip=skip,
                  lr_scale=lr_scale)


def abort(bundle_dir=None):
    """Capture a diagnostic bundle (to `bundle_dir`, falling back to the
    Supervisor's) and raise TrainingAborted."""
    return Action("abort", bundle_dir=bundle_dir)


DEFAULT_POLICIES = {
    "numeric": (skip_batch(times=2), rollback(times=2), abort()),
    # no retry for hangs: post-timeout device state is indeterminate
    # (DispatchTimeoutError's contract) — a retry would re-dispatch
    # against the wedged arrays and deterministically burn a second
    # full deadline before escalating anyway
    "hang": (rollback(times=2), abort()),
    "reader": (skip_batch(times=2), abort()),
    "dispatch": (retry(times=2, backoff=0.05), rollback(times=1), abort()),
    # sentinel classes (ARCHITECTURE.md §29). A loss spike's update
    # ALREADY landed (it is only visible after the fetch), so skip/
    # retry can't help: roll back and route the stream around the bad
    # window. Divergence is drift, not one batch — skipping data won't
    # fix it; rollback (configure lr_scale where the program has a
    # persistable LR) then abort. SDC is hardware: locally terminal —
    # the elastic worker escalates it so the coordinator quarantines
    # the device instead.
    "loss_spike": (rollback_skip_data(times=2), abort()),
    "divergence": (rollback(times=2), abort()),
    "sdc": (abort(),),
}


class Supervisor(object):
    def __init__(self, executor, program, scope=None,
                 checkpoint_manager=None, policies=None,
                 watchdog_timeout=None, divergence=None, bundle_dir=None,
                 metrics_window=64, restore_layout=None, sentinel=None,
                 sdc=None, sdc_every=64):
        """Wrap `executor` dispatches of `program` in detection +
        recovery. `policies` maps fault class -> escalation chain
        (missing classes use DEFAULT_POLICIES). `watchdog_timeout` arms
        the per-dispatch hang watchdog (seconds; None = off).
        `divergence` is a guards.DivergenceDetector fed every step's
        first fetch. `checkpoint_manager` enables rollback (and
        train(checkpoint_every=)); without one, rollback actions
        escalate straight past themselves. `restore_layout` (a
        parallel.DeviceLayout, Mesh or ShardingPlan) makes every rollback
        restore reshard onto that target mesh, so the state lands where
        the executor's mesh wants it. Registers itself on the reader
        fault channel so worker-thread errors surface in the event log
        the moment they happen.

        `sentinel` (a sentinel.TrainingSentinel) is fed every healthy
        step's first fetch plus the executor's guard-stat grad norm
        (`last_stats`, populated when guards were installed with
        grad_norm=True); its detections route through the loss_spike/
        divergence fault classes. `sdc` (an sdc.CanaryChecker) runs a
        deterministic canary dispatch every `sdc_every` completed
        steps; a digest mismatch routes through the sdc class."""
        self.exe = executor
        self.program = program
        self.restore_layout = restore_layout
        # a parallel executor owns its scope and takes no program/scope
        # per call. The port's Executor is told apart by
        # type: it has `.device`, not the JAX executor's `.place`, so the
        # JAX package's hasattr test would call every one parallel
        self._is_parallel = not isinstance(executor, Executor)
        if scope is None and self._is_parallel:
            scope = getattr(executor, "_scope", None)
        self.scope = scope if scope is not None else global_scope()
        self.ckpt = checkpoint_manager
        self.policies = dict(DEFAULT_POLICIES)
        for cls, chain in (policies or {}).items():
            if cls not in FAULT_CLASSES:
                raise ValueError("unknown fault class %r (known: %s)"
                                 % (cls, ", ".join(FAULT_CLASSES)))
            self.policies[cls] = tuple(chain)
        # lr_scale needs a persistable LR var: fail HERE, at
        # construction, not from inside the first real fault's recovery
        # (a scheduler-derived rate is recomputed in-graph every step
        # and cannot be damped by scaling scope state)
        if any(a.kind in ("rollback", "rollback_skip")
               and a.lr_scale is not None
               for chain in self.policies.values() for a in chain):
            from ..optimizer import persistable_lr_names
            if not persistable_lr_names(program):
                raise ValueError(
                    "rollback(lr_scale=...) configured but the program "
                    "has no persistable learning-rate variable to scale "
                    "(scheduler-derived rates are recomputed in-graph; "
                    "build with a float learning_rate to use lr_scale)")
        self.watchdog_timeout = watchdog_timeout
        self.divergence = divergence
        self.sentinel = sentinel
        self.sdc = sdc
        self.sdc_every = None if not sdc_every else max(1, int(sdc_every))
        self._sdc_last = 0
        self.bundle_dir = bundle_dir
        self.step = 0          # completed training steps (save label)
        self.events = []       # structured recovery log
        self.metrics = collections.deque(maxlen=int(metrics_window))
        self._chain_pos = {}   # class -> [chain index, uses of current]
        self._last_restore_step = None
        self._made_progress = True
        self._closed = False
        self._prev_listener = _readers.set_fault_listener(
            self._on_reader_fault)

    # ------------------------------------------------------- lifecycle --
    def close(self):
        if not self._closed:
            self._closed = True
            _readers.set_fault_listener(self._prev_listener)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- events --
    def _log(self, cls, action, detail=None, error=None, seconds=0.0,
             **extra):
        ev = {"step": int(self.step), "class": cls, "action": action,
              "detail": detail,
              "error": None if error is None else repr(error),
              "wall_time": time.time()}
        ev.update(extra)
        self.events.append(ev)
        # always-on observability (ARCHITECTURE.md §24): every recovery
        # action is an instant event in the flight recorder (it lands in
        # the same timeline as the dispatch spans it interrupted — a
        # bundle shows the guard trip BETWEEN the steps) and a labeled
        # counter on /metrics
        _otrace.instant("resilience/%s:%s" % (cls, action),
                        cat="resilience", step=int(self.step),
                        error=ev["error"])
        _obsreg.REGISTRY.counter(
            "ptpu_supervisor_events_total",
            "supervisor recovery events by fault class and action"
        ).inc(**{"class": cls, "action": action})
        # the profiler's resilience/<class>:<action> rows (`seconds`)
        # come with ROADMAP A11's profiler
        return ev

    def _on_reader_fault(self, reader, exc):
        """Reader fault channel (worker thread): log IMMEDIATELY — the
        raise will reach the loop at the next read, but the supervisor
        (and anyone tailing the event log) knows now."""
        self._log("reader", "notified", error=exc,
                  detail="worker-thread fault in %s" % type(reader).__name__)

    # ----------------------------------------------------------- steps --
    def run_step(self, feed=None, fetch_list=None, steps=1,
                 fetch_reduce="stack", **run_kw):
        """One supervised step (or K-step block with steps=K). Returns
        the fetches, or None when no fetches exist for this call:
        either the step was SKIPPED (self.step advanced past it) or a
        ROLLBACK rewound self.step — compare self.step to tell, and
        after a rollback re-derive `feed` for the new step index before
        calling again (a rolled-back attempt never re-dispatches the
        stale feed; train() does this re-derivation automatically).
        Raises EOFException at end of data and TrainingAborted at
        terminal escalation; everything else is handled per policy."""
        while True:
            plan = _faults.active_plan()
            if plan is not None:
                plan.set_step(self.step)
            t0 = time.perf_counter()
            try:
                if self._is_parallel:
                    fetches = self.exe.run(
                        fetch_list or [], feed=feed, steps=steps,
                        fetch_reduce=fetch_reduce,
                        timeout=self.watchdog_timeout, **run_kw)
                else:
                    fetches = self.exe.run(
                        self.program, feed=feed, fetch_list=fetch_list,
                        scope=self.scope, steps=steps,
                        fetch_reduce=fetch_reduce,
                        timeout=self.watchdog_timeout, **run_kw)
            except EOFException:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if getattr(e, "_cluster_fence", False):
                    # a cluster fence is not a fault: the coordinator
                    # moved the plan and THIS process must reconfigure —
                    # hand it up to the elastic worker loop untouched
                    # (nothing was consumed: the barrier fires before
                    # the prepass and seed draw)
                    raise
                outcome = self._handle_fault(self._classify(e), e,
                                             feed=feed, steps=steps)
                if outcome == "skip":
                    self.step += steps
                    self._made_progress = True
                    return None
                if outcome == "rolled_back":
                    # self.step rewound: this call's feed belongs to the
                    # OLD index — hand control back so the caller feeds
                    # the restored step, never the stale batch
                    return None
                continue  # retry: same step, same feed
            # healthy dispatch: host-side divergence check on fetch 0
            detail = None
            fetch0 = None
            if fetches:
                f0 = fetches[0]
                fetch0 = float(np.mean(to_numpy(f0) if hasattr(
                    f0, "detach") else np.asarray(f0)))
            if self.divergence is not None and fetch0 is not None:
                detail = self.divergence.update(fetch0)
            if detail is not None:
                outcome = self._handle_fault(
                    "numeric", DivergenceFault(detail), feed=feed,
                    steps=steps, applied=True)
                if outcome == "rolled_back":
                    return None  # caller re-feeds the restored step
                # skip/retry cannot undo an applied update: accept the
                # step (the event log carries the warning) and move on
            if self.sentinel is not None and fetch0 is not None:
                # the grad-norm scalar rode the guard stat channel in
                # the run that just returned (Executor.last_stats): the
                # run's one flag read already brought it to the host
                gn = None
                stats = getattr(self.exe, "last_stats", None) or {}
                if "grad_norm" in stats:
                    gn = float(stats["grad_norm"])
                err = self.sentinel.observe(fetch0, grad_norm=gn,
                                            step=self.step)
                if err is not None:
                    outcome = self._handle_fault(
                        self._classify(err), err, feed=feed,
                        steps=steps, applied=True)
                    if outcome == "rolled_back":
                        return None  # caller re-feeds the restored step
            if fetch0 is not None:
                self.metrics.append(
                    {"step": int(self.step), "fetch0": fetch0,
                     "seconds": time.perf_counter() - t0})
            self.step += steps
            self._made_progress = True
            if self.sdc is not None and self.sdc_every \
                    and self.step - self._sdc_last >= self.sdc_every:
                self._sdc_last = self.step
                try:
                    self.sdc.check()
                except SilentCorruptionError as e:
                    outcome = self._handle_fault("sdc", e, feed=feed,
                                                 steps=steps,
                                                 applied=True)
                    if outcome == "rolled_back":
                        return None
            return fetches

    def train(self, num_steps, feed_fn=None, fetch_list=None, steps=1,
              fetch_reduce="stack", checkpoint_every=None):
        """Drive the supervised loop until `num_steps` training steps
        complete (EOF ends it early, cleanly). `feed_fn(step_index)`
        must be a deterministic function of the index — after a rollback
        the loop re-asks for the replayed indices. With a checkpoint
        manager, `checkpoint_every=E` snapshots at every E-step
        boundary. Returns [{"step", "fetches"}] per block attempt that
        completed or was skipped (replayed indices appear again, in
        order — the event log tells the story)."""
        results = []
        try:
            while self.step < num_steps:
                idx = self.step
                feed = feed_fn(idx) if feed_fn is not None else None
                out = self.run_step(feed=feed, fetch_list=fetch_list,
                                    steps=steps,
                                    fetch_reduce=fetch_reduce)
                if self.step <= idx:
                    continue  # rolled back: re-derive feed for new index
                results.append({"step": idx, "fetches": out})
                if (checkpoint_every and self.ckpt is not None
                        and self.step // int(checkpoint_every)
                        > idx // int(checkpoint_every)):
                    self.ckpt.save(self.step, program=self.program,
                                   scope=self.scope)
        except EOFException:
            self._log("reader", "eof", detail="end of data")
        return results

    # ------------------------------------------------------ escalation --
    def _classify(self, exc):
        if isinstance(exc, LossSpikeError):
            return "loss_spike"
        if isinstance(exc, DivergenceError):
            return "divergence"
        if isinstance(exc, SilentCorruptionError):
            return "sdc"
        if isinstance(exc, (NumericalGuardError, DivergenceFault)):
            return "numeric"
        if isinstance(exc, DispatchTimeoutError):
            return "hang"
        if getattr(exc, "_reader_fault", False):
            return "reader"
        return "dispatch"

    def _next_action(self, cls):
        chain = self.policies.get(cls) or (abort(),)
        pos = self._chain_pos.setdefault(cls, [0, 0])
        while pos[0] < len(chain):
            act = chain[pos[0]]
            if act.kind == "abort" or pos[1] < act.times:
                pos[1] += 1
                return act
            pos[0] += 1
            pos[1] = 0
        return Action("abort")

    def _handle_fault(self, cls, exc, feed=None, steps=1, applied=False):
        """Apply the next action of `cls`'s chain. Returns "skip",
        "retry" or "rolled_back"; raises TrainingAborted at the end of
        every chain. A hang trip captures its diagnostic bundle BEFORE
        escalating (the wedged state is the evidence; an abort for the
        same fault reuses that capture instead of writing a second).
        `applied=True` marks faults whose step's updates already landed
        (host divergence): skip/retry can't undo those — they log
        honestly, consume their budget (repeat divergence escalates
        toward rollback) and do nothing else."""
        bundle = None
        if cls == "hang" and self.bundle_dir:
            bundle = _watchdog.write_bundle(
                self.bundle_dir, "hang watchdog tripped", fault_class=cls,
                step=self.step, program=self.program, feed=feed,
                scope=self.scope, metrics=self.metrics,
                events=self.events, error=exc)
            self._log(cls, "bundle", detail=bundle, error=exc)
        while True:
            t0 = time.perf_counter()
            act = self._next_action(cls)
            if act.kind == "skip_batch":
                detail = None
                if applied:
                    detail = ("update already applied (divergence); "
                              "tolerated — budget consumed, repeats "
                              "escalate")
                elif cls != "numeric":
                    # a guard trip already consumed its records (and
                    # gated its updates); everything else must drop the
                    # batch at the readers' known positions to skip it
                    dropped, want = self._drop_batch(steps)
                    if dropped < want:
                        # a record the source refuses to produce cannot
                        # be dropped: say so — the next attempt faults
                        # again and the budgeted chain escalates
                        detail = ("dropped %d/%d records; the reader "
                                  "source is failing" % (dropped, want))
                self._log(cls, "skip_batch", error=exc, detail=detail,
                          seconds=time.perf_counter() - t0)
                return "skip"
            if act.kind == "retry":
                if applied:
                    self._log(cls, "retry", error=exc,
                              detail="update already applied "
                                     "(divergence); nothing to retry — "
                                     "budget consumed, repeats escalate",
                              seconds=time.perf_counter() - t0)
                    return "skip"
                if act.backoff > 0:
                    time.sleep(act.backoff)
                self._log(cls, "retry", error=exc,
                          detail="backoff %.3fs" % act.backoff,
                          seconds=time.perf_counter() - t0)
                return "retry"
            if act.kind == "rollback":
                restored = self._rollback(act, exc, t0)
                if restored is None:
                    continue  # no manager / no snapshot: escalate
                return "rolled_back"
            if act.kind == "rollback_skip":
                restored = self._rollback_skip(act, exc, t0, steps)
                if restored is None:
                    continue  # no manager / no snapshot: escalate
                return "rolled_back"
            # abort (also the terminal fallthrough)
            bdir = act.bundle_dir or self.bundle_dir
            if bundle is None and bdir:
                bundle = _watchdog.write_bundle(
                    bdir, "escalation chain aborted", fault_class=cls,
                    step=self.step, program=self.program, feed=feed,
                    scope=self.scope, metrics=self.metrics,
                    events=self.events, error=exc)
            self._log(cls, "abort", detail=bundle, error=exc,
                      seconds=time.perf_counter() - t0)
            raise TrainingAborted(
                "training aborted at step %d on a %s fault: %r%s"
                % (self.step, cls, exc,
                   " (diagnostic bundle: %s)" % bundle if bundle else ""),
                bundle=bundle, cause=exc)

    def _rollback(self, act, exc, t0):
        if self.ckpt is None:
            self._log("_", "rollback_unavailable",
                      detail="no checkpoint manager", error=exc)
            return None
        # never restore PAST the current position: a checkpoint dir
        # holding newer snapshots (stale dir, walked-back state) must
        # not jump training forward. A repeat rollback that made no
        # progress past its last restore additionally walks back one
        # snapshot (the newest may be poisoned).
        bound = self.step + 1
        before = bound if self._made_progress else min(
            self._last_restore_step, bound)
        restored = self.ckpt.restore(
            program=self.program, scope=self.scope, before=before,
            executor=None if self._is_parallel else self.exe,
            layout=self.restore_layout)
        if restored is None:
            self._log("_", "rollback_unavailable",
                      detail="no valid snapshot%s" % (
                          " before step %d" % before if before else ""),
                      error=exc)
            return None
        self.step = int(restored)
        self._last_restore_step = int(restored)
        self._made_progress = False
        scaled = None
        if act.lr_scale is not None:
            from ..optimizer import scale_learning_rate
            try:
                scaled = scale_learning_rate(self.program, self.scope,
                                             act.lr_scale)
            except ValueError as se:
                # construction-time validation should have caught this;
                # mid-recovery the restore already happened, so continue
                # un-damped (budgets still bound the loop) rather than
                # crash out of the handler with no abort and no bundle
                self._log("_", "lr_scale_failed", error=se)
        if self.divergence is not None:
            self.divergence.reset()
        if self.sentinel is not None:
            # the restored state replays an earlier stream — the
            # window's samples come from a future that will now unfold
            # differently, so the baseline restarts (warmup included)
            self.sentinel.reset()
        self._log(self._classify(exc), "rollback", error=exc,
                  detail="restored step %d%s" % (
                      restored,
                      "; lr x%g on %s" % (act.lr_scale, scaled)
                      if scaled else ""),
                  seconds=time.perf_counter() - t0)
        return restored

    def _reader_states(self):
        """(name, state) per distinct in-graph reader with a position
        cursor — the checkpoint machinery rollback_skip_data rides."""
        out, seen = [], set()
        for op in self.program.global_block().ops:
            if op.type != "read":
                continue
            name = op.inputs["Reader"][0]
            if name in seen:
                continue
            seen.add(name)
            state = self.scope.get(name)
            if state is not None and hasattr(state, "_consumed"):
                out.append((name, state))
        return out

    def _rollback_skip(self, act, exc, t0, steps):
        """rollback_skip_data: capture every reader's CURRENT position
        (one past the offending window — the records of the faulted
        attempt are already consumed when a spike is observed), restore
        the newest snapshot (which rewinds the readers to the
        snapshot's positions), then advance each stream back to the
        captured position plus `act.skip` further K-blocks. The resumed
        run therefore trains over exactly the stream a from-scratch
        resume that never saw those records would: restore + skip is
        deterministic replay, not approximation."""
        readers = self._reader_states()
        targets = {n: int(s._consumed) + act.skip * int(steps)
                   for n, s in readers}
        restored = self._rollback(act, exc, t0)
        if restored is None:
            return None
        from ..checkpoint.manager import skip_reader_records
        want = {}
        for n, _ in readers:
            state = self.scope.get(n)
            if state is None or not hasattr(state, "_consumed"):
                continue
            want[n] = max(0, targets[n] - int(state._consumed))
        # EOF while skipping propagates: end of data, the caller's
        # loop ends cleanly
        total = skip_reader_records(self.scope, want, want)
        detail = ("skipped %d records across %d reader(s) past the "
                  "fault window (skip=%d x steps=%d)"
                  % (total, len(readers), act.skip, int(steps))
                  if readers else
                  "no in-graph readers: degraded to a plain rollback "
                  "(feed-fed program — the caller's feed_fn decides "
                  "what the restored step sees)")
        self._log(self._classify(exc), "rollback_skip", error=exc,
                  detail=detail, seconds=time.perf_counter() - t0)
        return restored

    def _drop_batch(self, steps):
        """Consume (and discard) the records the failed attempt would
        have trained on — one K-block per in-graph reader, at the
        readers' current (exactly known) positions, record by record so
        a single raising record doesn't refund the whole block
        (next_many's atomicity is exactly wrong here: the good records
        around a bad one SHOULD be dropped). Returns (dropped, wanted)
        summed over all readers — a record the source refuses to
        produce never materialized, so it cannot be counted as dropped.
        A clean EOF propagates (end of data, not a fault); a feed-fed
        program (no readers) returns (0, 0)."""
        dropped = wanted = 0
        for op in self.program.global_block().ops:
            if op.type != "read":
                continue
            state = self.scope.get(op.inputs["Reader"][0])
            if state is None:
                continue
            for _ in range(int(steps)):
                wanted += 1
                try:
                    state.next()
                    dropped += 1
                except EOFException:
                    raise
                except Exception:
                    pass  # the raising record IS the fault being skipped
        return dropped, wanted
