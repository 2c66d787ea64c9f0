"""Deterministic fault injection: one registry for every failure mode.

Parity: the JAX package's resilience/faults.py (the same spec strings,
kinds, one-shot rules and seams). Feeds here are torch tensors on the
host (the executor converts them before its dispatch hooks fire) or
numpy arrays; reader records are numpy arrays on the host, poisoned
before a DoubleBufferReader's worker copies them to the card.

A `FaultPlan` is an ordered set of (kind, index[, arg]) entries — parsed
from the `PTPU_FAULT_PLAN` env var (`"nan_feed@5;reader_stall@8:0.5"`) or
built programmatically — that injects failures at chosen indices so every
recovery path (resilience.Supervisor policies, checkpoint rollback, the
hang watchdog) is provable in CI instead of waited for in production.
Arming a plan installs hooks at three seams:

  * `core.executor._fault_hook` — fires per DISPATCH, keyed on the step
    counter (`plan.set_step`, which the Supervisor advances): `nan_feed`
    poisons a float feed array, `dispatch_exc` raises
    InjectedDispatchError, `slow_step` sleeps `arg` seconds (trips the
    watchdog). All fire BEFORE the io pre-pass and seed draw, so a
    failed attempt consumes nothing and retries replay bit-exactly.
    Cluster faults ride the same seam, keyed on the same step cursor:
    `host_death@N` SIGKILLs the whole worker process at step N (nothing
    of step N is consumed, so the newest snapshot is at most N-1), and
    `heartbeat_stall@N[:secs]` marks the heartbeat stalled from step N
    for `secs` seconds (default: forever): resilience/heartbeat.py's
    `HeartbeatWriter.beat()` consults `heartbeat_stalled`. The sentinel faults
    (ARCHITECTURE.md §29) ride here for FEED-FED programs:
    `loss_spike@N[:mag]` / `grad_blowup@N[:mag]` scale every float feed
    of step N by a large-but-FINITE magnitude (defaults 1e3 / 1e6) —
    no guard trips, only the statistical monitors can see it.
  * `core.readers._fault_hook` — fires per RECORD, keyed on each
    reader's own delivered-record counter (deterministic even when a
    DoubleBufferReader worker pre-stages ahead of the training loop):
    `reader_nan` poisons the record's float fields, `reader_exc` raises
    InjectedReaderError (from the worker thread for buffered readers —
    exercising the immediate fault channel), `reader_stall` sleeps,
    `reader_eof` ends the stream early. For READER-FED programs the
    sentinel faults key here instead: `loss_spike@N[:mag]` /
    `grad_blowup@N[:mag]` scale record N's float fields — the bad
    batch lands at a known stream position, which is exactly what
    rollback_skip_data's bit-exactness proof needs.
  * `resilience.sdc._fault_hook` — `bitflip@N[:device]` flips ONE bit
    of canary check >= N's result (waiting, with `device`, until the
    rotation lands on that local device index): the minimal silent
    corruption, invisible to every guard, that must trip the digest
    compare and get the device quarantined.
  * `checkpoint.snapshot._fault_hook` — `ckpt_kill@N` SIGKILLs at the
    Nth durability crossing of the write protocol, subsuming the
    checkpoint's own `PTPU_CKPT_FAULT_AT` (which keeps working unchanged) under this
    registry.
  * `serving_fault` — the SERVING seam: the replica pool's pre-dispatch
    tap (core/dispatch.ReplicaTap, fired by InferenceEngine at the top
    of every batch dispatch) consults the armed plan before every replica
    dispatch, keyed on that REPLICA's own dispatch count (deterministic
    per replica regardless of routing): `replica_exc@N` raises
    InjectedReplicaError inside the Nth dispatch (the batcher's group
    isolation fails only that batch; the pool must fail the requests
    over), `replica_wedge@N[:secs]` sleeps the replica's batcher worker
    `secs` seconds (default: effectively forever) — the wedged-engine
    case only per-attempt timeouts can detect — and `replica_poison@N`
    NaNs every float value in the replica's private Scope, the
    crashed-trainer-pushed-garbage-weights case the pool's finite-output
    check must catch. The fleet chaos kinds ride the same tap:
    `replica_slow@N[:secs]` sleeps a SHORT, repeatable latency (default
    0.2s; arm with `*`) — the slow-but-alive replica the pool's latency
    breaker must brown out, as opposed to the wedge only timeouts see;
    `replica_crash@N` kills the engine abruptly MID-WINDOW (the batcher
    closes drain=False from a side thread while this dispatch fails) —
    queued and in-flight requests on it must all resolve via failover,
    nothing may hang; `canary_poison@N` corrupts weights like
    replica_poison but fires ONLY on a canary engine's tap
    (replica_id == "canary") — the bad-canary case promotion gating
    must catch and auto-roll-back with zero client errors. One-shot
    entries fire on the FIRST replica to reach count N; the recovery
    invariant (zero client-visible errors) must hold whichever replica
    that is.

Entries are ONE-SHOT by default (`kind@idx`); `kind@idx*` repeats every
time the index matches. One plan may be armed per process at a time.
"""
import os
import threading

import numpy as np
import torch

__all__ = ["FaultPlan", "InjectedFault", "InjectedDispatchError",
           "InjectedReaderError", "InjectedReplicaError",
           "InjectedReplicaCrash", "active_plan"]

_KINDS = frozenset({
    "nan_feed", "dispatch_exc", "slow_step",
    "reader_nan", "reader_exc", "reader_stall", "reader_eof",
    "ckpt_kill", "host_death", "heartbeat_stall",
    "replica_exc", "replica_wedge", "replica_poison",
    "replica_slow", "replica_crash", "canary_poison",
    "loss_spike", "grad_blowup", "bitflip",
})
_READER_KINDS = frozenset({"reader_nan", "reader_exc", "reader_stall",
                           "reader_eof"})


class InjectedFault(RuntimeError):
    """Base of all plan-injected failures (so tests/supervisors can tell
    injected faults from organic ones when they need to)."""


class InjectedDispatchError(InjectedFault):
    """Injected executor-dispatch failure (fault kind `dispatch_exc`)."""


class InjectedReaderError(InjectedFault):
    """Injected reader failure (fault kind `reader_exc`); tagged
    reader-class for the supervisor's fault classifier."""
    _reader_fault = True


class InjectedReplicaError(InjectedFault):
    """Injected serving-replica dispatch failure (fault kind
    `replica_exc`); tagged replica-class so the pool's failover logic
    and tests can tell an injected replica fault from an organic one."""
    _replica_fault = True


class InjectedReplicaCrash(InjectedFault):
    """Injected abrupt replica death (fault kind `replica_crash`): the
    replica's engine is force-closed (no drain) mid-window while this
    dispatch fails — the pool must fail everything queued on it over
    with zero client-visible errors and no hangs."""
    _replica_fault = True


class _Entry(object):
    __slots__ = ("kind", "at", "arg", "repeat", "fired")

    def __init__(self, kind, at, arg=None, repeat=False):
        if kind not in _KINDS:
            raise ValueError(
                "unknown fault kind %r; known kinds: %s"
                % (kind, ", ".join(sorted(_KINDS))))
        self.kind = kind
        self.at = int(at)
        self.arg = arg
        self.repeat = bool(repeat)
        self.fired = False

    def __repr__(self):
        return "%s@%d%s%s" % (self.kind, self.at,
                              ":%g" % self.arg if self.arg is not None
                              else "", "*" if self.repeat else "")


def _parse_entry(spec):
    """'kind@idx[:arg][*]' -> _Entry. Raises LOUDLY on malformed specs
    (the FLAGS_conv_layout rule: a typo'd plan silently injecting nothing
    would green-light an untested recovery path)."""
    s = spec.strip()
    repeat = s.endswith("*")
    if repeat:
        s = s[:-1]
    if "@" not in s:
        raise ValueError("fault spec %r: expected 'kind@index[:arg]'" % spec)
    kind, _, rest = s.partition("@")
    arg = None
    if ":" in rest:
        at_s, _, arg_s = rest.partition(":")
        arg = float(arg_s)
    else:
        at_s = rest
    return _Entry(kind.strip(), int(at_s), arg=arg, repeat=repeat)


_active = None
_lock = threading.Lock()


def active_plan():
    """The currently armed FaultPlan, or None."""
    return _active


class FaultPlan(object):
    def __init__(self, entries=()):
        self.entries = []
        for e in entries:
            if isinstance(e, _Entry):
                self.entries.append(e)
            elif isinstance(e, str):
                self.entries.append(_parse_entry(e))
            else:
                kind, at = e[0], e[1]
                arg = e[2] if len(e) > 2 else None
                self.entries.append(_Entry(kind, at, arg=arg))
        self._step = 0
        self._ckpt_crossings = 0
        self._hb_stall_until = 0.0  # monotonic deadline (inf = forever)
        # one-shot bookkeeping is check-then-act; reader hooks fire from
        # worker threads (DoubleBuffer pre-staging), so _take must be
        # atomic or a "one-shot" could fire twice in a tight race
        self._take_lock = threading.Lock()

    @classmethod
    def from_env(cls, spec=None):
        """Parse PTPU_FAULT_PLAN (or an explicit spec string). Returns
        None when the var is unset/empty — callers can arm
        unconditionally via `plan = FaultPlan.from_env();
        if plan: plan.arm()`."""
        spec = os.environ.get("PTPU_FAULT_PLAN", "") if spec is None \
            else spec
        spec = spec.strip()
        if not spec:
            return None
        return cls([s for s in spec.split(";") if s.strip()])

    # ------------------------------------------------------------ state --
    def set_step(self, step):
        """Advance the step cursor the dispatch-level faults key on (the
        Supervisor calls this before every attempt)."""
        self._step = int(step)

    def pending(self):
        """Entries that have not fired yet (one-shot bookkeeping)."""
        return [e for e in self.entries if e.repeat or not e.fired]

    def _take(self, kinds, at):
        with self._take_lock:
            for e in self.entries:
                if e.kind in kinds and e.at == at \
                        and (e.repeat or not e.fired):
                    e.fired = True
                    return e
        return None

    # ------------------------------------------------------------- arm --
    def arm(self):
        """Install this plan's hooks (executor, readers, checkpoint,
        canary).
        Raises if another plan is armed — overlapping plans would make
        the injection schedule nondeterministic."""
        global _active
        from ..core import executor as _exe
        from ..core import readers as _rdr
        from ..checkpoint import snapshot as _snap
        from . import sdc as _sdc
        with _lock:
            if _active is not None and _active is not self:
                raise RuntimeError("another FaultPlan is already armed")
            _active = self
            _exe._fault_hook = self._executor_hook
            _rdr._fault_hook = self._reader_hook
            _snap._fault_hook = self._ckpt_hook
            _sdc._fault_hook = self._sdc_hook
        return self

    def disarm(self):
        global _active
        from ..core import executor as _exe
        from ..core import readers as _rdr
        from ..checkpoint import snapshot as _snap
        from . import sdc as _sdc
        with _lock:
            if _active is self:
                _active = None
                _exe._fault_hook = None
                _rdr._fault_hook = None
                _snap._fault_hook = None
                _sdc._fault_hook = None

    def __enter__(self):
        return self.arm()

    def __exit__(self, *exc):
        self.disarm()

    # ----------------------------------------------------------- hooks --
    def heartbeat_stalled(self):
        """True while an injected heartbeat stall is in effect
        (HeartbeatWriter.beat consults this before every write)."""
        import time
        return time.monotonic() < self._hb_stall_until

    def _executor_hook(self, point, program=None, steps=1,
                       feed_arrays=None):
        del point, program
        e = self._take(("host_death",), self._step)
        if e is not None:
            # the whole WORKER dies, exactly like a preempted host: no
            # atexit, no cleanup, before anything of this step is
            # consumed (the same SIGKILL discipline as ckpt_kill)
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        e = self._take(("heartbeat_stall",), self._step)
        if e is not None:
            import time
            self._hb_stall_until = time.monotonic() + (
                e.arg if e.arg is not None else float("inf"))
        e = self._take(("slow_step",), self._step)
        if e is not None:
            import time
            time.sleep(e.arg if e.arg is not None else 1.0)
        e = self._take(("dispatch_exc",), self._step)
        if e is not None:
            raise InjectedDispatchError(
                "injected dispatch failure at step %d (fault plan)"
                % self._step)
        e = self._take(("nan_feed",), self._step)
        if e is not None and feed_arrays is not None:
            _poison_first_float(feed_arrays)
        # sentinel faults, feed-fed seam: scale the float feeds by a
        # large-but-FINITE magnitude — no guard trips, only statistics
        # can see it. Taken only when explicit feeds exist; a reader-fed
        # program's records are injected at the reader seam instead
        # (same kinds, keyed on the source reader's record counter), so
        # a one-shot entry is never burned against an empty feed dict.
        if feed_arrays:
            e = self._take(("loss_spike", "grad_blowup"), self._step)
            if e is not None:
                _scale_float_feeds(feed_arrays, _spike_mag(e))

    def _reader_hook(self, phase, reader, record=None):
        # fire only at SOURCE readers (no `_under` wrapper): in a
        # decorator chain both the inner reader (worker thread,
        # pre-staging ahead) and the outer one pass every index, and
        # whichever hit a one-shot entry first would win by thread
        # timing — source-level injection is deterministic in stream
        # order regardless of buffering
        if getattr(reader, "_under", None) is not None:
            return None
        at = reader._consumed
        if phase == "read":
            e = self._take(("reader_stall",), at)
            if e is not None:
                import time
                time.sleep(e.arg if e.arg is not None else 1.0)
            e = self._take(("reader_eof",), at)
            if e is not None:
                from ..core.readers import EOFException
                raise EOFException()
            e = self._take(("reader_exc",), at)
            if e is not None:
                raise InjectedReaderError(
                    "injected reader failure at record %d (fault plan)"
                    % at)
            return None
        # phase == "record": poison the popped record's float fields
        e = self._take(("loss_spike", "grad_blowup"), at)
        if e is not None:
            # sentinel faults, reader seam: the "bad batch" — every
            # float field scaled by a finite magnitude at a KNOWN
            # record index, so rollback_skip_data's bit-exactness leg
            # can reconstruct exactly which records to never see
            mag = _spike_mag(e)
            return tuple(
                np.array(f, copy=True) * mag
                if np.issubdtype(np.asarray(f).dtype, np.floating)
                else f for f in record)
        e = self._take(("reader_nan",), at)
        if e is None:
            return None
        poisoned = []
        hit = False
        for f in record:
            a = np.array(f, copy=True)
            if not hit and np.issubdtype(a.dtype, np.floating):
                a.reshape(-1)[0] = np.nan
                hit = True
            poisoned.append(a)
        return tuple(poisoned)

    def serving_fault(self, replica_id, dispatch_count, engine=None):
        """Serving seam: called by a replica pool's pre-dispatch tap with
        the dispatching replica's id and ITS OWN dispatch count (the
        key). Unlike the executor/reader seams this one is pulled
        (`active_plan()` at the tap) rather than pushed at arm() — the
        pool may not exist when a training-only plan arms, and arming
        must not import the serving stack."""
        e = self._take(("replica_wedge",), dispatch_count)
        if e is not None:
            import time
            # sleeps ON the replica's batcher worker: every request
            # queued behind this dispatch stalls — only the pool's
            # per-attempt timeout can see it, exactly like a real wedge
            time.sleep(e.arg if e.arg is not None else 3600.0)
        e = self._take(("replica_slow",), dispatch_count)
        if e is not None:
            import time
            # SHORT, usually repeated (`replica_slow@0:0.2*`): the
            # slow-but-answering replica — requests complete, latency
            # collapses; the pool's latency breaker (and the fleet's
            # brownout) must act on measurements, not timeouts
            time.sleep(e.arg if e.arg is not None else 0.2)
        if replica_id == "canary":
            # canary-targeted corruption: fires only on the canary
            # engine's tap, never a serving replica's — the bad-canary
            # rollback leg must not depend on routing luck
            e = self._take(("canary_poison",), dispatch_count)
            if e is not None and engine is not None:
                _poison_scope_floats(engine._scope)
        e = self._take(("replica_poison",), dispatch_count)
        if e is not None and engine is not None:
            _poison_scope_floats(engine._scope)
        e = self._take(("replica_crash",), dispatch_count)
        if e is not None and engine is not None:
            import threading
            # abrupt death mid-window: close(drain=False) fails every
            # queued/formed request with ServingClosedError — from a
            # SIDE thread, because close() joins the very batcher
            # worker this tap runs on — while the current dispatch
            # fails with the typed crash error
            threading.Thread(
                target=lambda: engine.close(drain=False, timeout=5.0),
                daemon=True, name="ptpu-fault-crash").start()
            raise InjectedReplicaCrash(
                "injected replica crash on replica %s at dispatch %d "
                "(fault plan)" % (replica_id, dispatch_count))
        e = self._take(("replica_exc",), dispatch_count)
        if e is not None:
            raise InjectedReplicaError(
                "injected replica failure on replica %s at dispatch %d "
                "(fault plan)" % (replica_id, dispatch_count))

    def _ckpt_hook(self):
        n = self._ckpt_crossings
        self._ckpt_crossings = n + 1
        e = self._take(("ckpt_kill",), n)
        if e is not None:
            import signal
            os.kill(os.getpid(), signal.SIGKILL)

    def _sdc_hook(self, check_index, device_index, result):
        """SDC seam (resilience/sdc.py CanaryChecker): `bitflip@N[:dev]`
        corrupts the result of canary check >= N — waiting, when `dev`
        is given, until the round-robin rotation lands on that local
        device index, so the quarantine leg deterministically blames
        the device the plan names. One bit of one element flips: the
        minimal silent corruption, far below any statistical monitor's
        floor and invisible to every finiteness guard."""
        taken = None
        with self._take_lock:
            for en in self.entries:
                if en.kind == "bitflip" and (en.repeat or not en.fired) \
                        and check_index >= en.at \
                        and (en.arg is None
                             or int(en.arg) == device_index):
                    en.fired = True
                    taken = en
                    break
        if taken is None:
            return result
        a = np.array(result, copy=True)
        flat = a.reshape(-1)
        bits = flat[:1].view(np.uint32 if flat.dtype == np.float32
                             else np.uint64)
        bits[0] ^= np.asarray(1 << 20, bits.dtype)
        return a


def _is_float(v):
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


def _poisoned(v):
    """A copy of `v` (tensor or array) with its first element NaN."""
    if isinstance(v, torch.Tensor):
        a = v.detach().clone()
    else:
        a = np.array(v, copy=True)
    a.reshape(-1)[0] = float("nan")
    return a


def _poison_scope_floats(scope):
    """NaN the first element of EVERY float tensor in a Scope — the
    `replica_poison` payload. Poisoning every float persistable (not
    just the first) makes the corruption reach the outputs of any model
    topology: one NaN weight element propagates through its matmul
    column, and softmax/normalizing heads spread it across the row."""
    for name in sorted(scope.names()):
        v = scope.get(name)
        if not isinstance(v, torch.Tensor) or not v.is_floating_point() \
                or v.numel() == 0:
            continue
        scope.set(name, _poisoned(v))


def _spike_mag(entry):
    """Magnitude for the sentinel fault kinds: the entry's arg, or a
    kind-specific default — loss_spike 1e3 (a clear statistical outlier
    that stays well inside float range through the loss), grad_blowup
    1e6 (big enough that the grad-norm monitor, watching a noisier
    stream, trips before the loss z-score does)."""
    if entry.arg is not None:
        return float(entry.arg)
    return 1e6 if entry.kind == "grad_blowup" else 1e3


def _scale_float_feeds(feed_arrays, mag):
    """Scale every float feed by `mag` in the feed dict, in its own dtype
    — the finite 'bad batch' payload (contrast _poison_first_float:
    NaN)."""
    for name in sorted(feed_arrays):
        v = feed_arrays[name]
        if not _is_float(v):
            continue
        if isinstance(v, torch.Tensor):
            feed_arrays[name] = v * mag
        else:
            a = np.asarray(v)
            feed_arrays[name] = a * a.dtype.type(mag)


def _poison_first_float(feed_arrays):
    """Overwrite the first element of the first float feed with NaN —
    in the feed dict, deterministically (sorted name order)."""
    for name in sorted(feed_arrays):
        v = feed_arrays[name]
        if _is_float(v):
            feed_arrays[name] = _poisoned(v)
            return name
    return None
