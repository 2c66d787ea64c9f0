"""The dispatch core the serving batcher and the executor front.

Parity: the JAX package's core/dispatch.py — its `InflightWindow`, its
host-io prefetcher and its watchdog pair `run_with_deadline` /
`dispatch_with_deadline` — and its dispatch-guard seam: the pre-dispatch
hooks (`run_dispatch_hooks`: the cluster step barrier an
`ElasticWorker` installs, and the fault-injection tap) and the
post-dispatch checks (`run_post_dispatch_checks`: the assertion and
guard flags, the FLAGS_check_nan_inf sweep), and the serving side of
that seam: a replica pool's `ReplicaTap` over its `TapCounter`.

  * `InflightWindow` bounds how many dispatches may be outstanding on the
    device at once (the serving batcher's continuous-batching window).
    A dispatch returns its fetch tensors without a host sync; `track()`
    records a CUDA event on the current stream behind them, and a
    completion thread waits on those events in FIFO order — the window's
    one host sync, off the dispatch path — and frees the slot. On the CPU
    a dispatch has finished by the time it returns, so its handle
    completes at once. The completion thread also sums the device's idle
    gaps (one dispatch's completion to the next one's enqueue).

  * `HostIoPrefetcher` runs the NEXT call's host-io pre-pass (reader
    pops, stacking) on a background thread while the current call's work
    runs on the device. The staged block is consumed by the next matching
    `run()` call; anything else (a raise after the kick, a different
    program / scope / steps, a quiesce) pushes the staged records back
    exactly (`_StagedBlock.refund`), so the stream replays bit-exactly.
    `consume_host_io` and `kick_next_prepass` are the executor's two
    calls into it; `rollback_all_staged` is the quiesce hook.

  * `run_step_traced` wraps one Executor run in its `exec/step` span,
    inheriting the thread's ambient trace (the serving batcher scopes
    each batch's trace around its dispatch).

  * `run_with_deadline` runs a function on a worker thread and gives up
    on it after `timeout` seconds; `dispatch_with_deadline` is the
    executor's wrapper that attaches the run's cache key to the raise.

  * `TapCounter` / `ReplicaTap`: the serving engine fires its
    `_replica_tap` at the top of every batch dispatch; a replica pool
    attaches one per replica engine, which consults the armed fault
    plan's `serving_fault` keyed on the replica's own dispatch count.
"""
import queue
import threading
import time
import weakref

import torch

from ..observability import registry as _obsreg
from ..observability import trace as _trace

__all__ = ["InflightWindow", "run_with_deadline", "dispatch_with_deadline",
           "run_step_traced", "HostIoPrefetcher", "has_read_ops",
           "has_host_io_ops", "kick_next_prepass", "consume_host_io",
           "rollback_all_staged", "run_dispatch_hooks",
           "run_post_dispatch_checks", "TapCounter", "ReplicaTap",
           "CANCELLED"]

_CLOSE = object()
# HostIoPrefetcher.take / consume_host_io: the caller's watchdog fired
CANCELLED = object()


def _completion_event(handles):
    """A CUDA event recorded on the current stream of the first CUDA
    tensor's device among `handles`, or None when none is on a card."""
    for h in handles:
        if isinstance(h, torch.Tensor) and h.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(h.device))
            return ev
    return None


class InflightWindow(object):
    """Bounded window of dispatched-but-not-device-complete batches.

    The dispatch worker `acquire()`s a slot before it enqueues a batch and
    hands the batch's fetch tensors to `track()`; the completion thread
    waits for each tracked dispatch's event in FIFO order and releases
    its slot when the device is done. With depth >= 2 the device has the
    next batch queued behind the running one while the host pads the one
    after.

    Idle accounting: completion of dispatch i at t_ready and enqueue of
    dispatch i+1 at t_enq > t_ready means the device sat idle for
    (t_enq - t_ready); `stats()["idle_s"]` sums those gaps (a host-side
    lower bound: a dispatch enqueued before the previous one completed
    counts zero)."""

    def __init__(self, depth, tag=None):
        if depth < 1:
            raise ValueError("InflightWindow depth must be >= 1, got %r"
                             % (depth,))
        self.depth = int(depth)
        self.tag = tag
        self._sem = threading.Semaphore(self.depth)
        self._q = queue.Queue()
        self._lock = threading.Lock()
        self._last_ready = None   # monotonic completion of previous batch
        self._idle_s = 0.0
        self._gaps = 0
        self._completed = 0
        self._iterations = 0  # decode iterations (note_iteration)
        self._thread = threading.Thread(
            target=self._completion_loop, daemon=True,
            name="ptt-window-%s" % (tag or "anon"))
        self._thread.start()
        # depth/completed/idle on /metrics for this window's lifetime
        # (a weak reference: a closed, dropped window drops off)
        _obsreg.note_window(self)

    # ------------------------------------------------------------ slots --
    def acquire(self, timeout=None):
        """Take one in-flight slot (blocks while `depth` dispatches are
        outstanding). Returns False on timeout."""
        return self._sem.acquire(timeout=timeout) if timeout is not None \
            else self._sem.acquire()

    def release(self):
        """Give a slot back WITHOUT tracking (the dispatch failed before
        any device work was enqueued)."""
        self._sem.release()

    def track(self, handles, enqueued_at=None, on_complete=None):
        """Register an enqueued dispatch's fetch tensors: an event goes on
        the current stream behind them, and the completion thread releases
        the slot (and accounts the idle gap) once the device reaches it.
        `handles` may be empty or on the CPU (completes at once).
        `on_complete(**kw)` runs on the completion thread right after,
        with error=<exception class name> when the wait raised."""
        self._q.put((_completion_event(handles or ()),
                     time.monotonic() if enqueued_at is None
                     else enqueued_at, on_complete))

    # ------------------------------------------------------- completion --
    def _completion_loop(self):
        while True:
            item = self._q.get()
            if item is _CLOSE:
                return
            event, enq_t, on_complete = item
            err = None
            try:
                if event is not None:
                    event.synchronize()   # the window's one host sync
            except Exception as e:  # noqa: BLE001 — the slot must come
                err = type(e).__name__   # back whatever the device did
            if on_complete is not None:
                try:
                    on_complete(**({"error": err} if err else {}))
                except Exception:  # noqa: BLE001 — an observer must never
                    pass           # wedge slot recycling
            ready = time.monotonic()
            with self._lock:
                if self._last_ready is not None and enq_t > self._last_ready:
                    self._idle_s += enq_t - self._last_ready
                    self._gaps += 1
                self._last_ready = ready
                self._completed += 1
            self._sem.release()

    def note_iteration(self):
        """Count one decode iteration (serving.DecodeBatcher): a step loop
        runs one tracked dispatch an iteration, and the count surfaces in
        stats() beside `completed`."""
        with self._lock:
            self._iterations += 1

    def stats(self):
        with self._lock:
            return {"idle_s": self._idle_s, "gaps": self._gaps,
                    "completed": self._completed,
                    "iterations": self._iterations}

    def close(self, timeout=None):
        self._q.put(_CLOSE)
        self._thread.join(timeout)


def run_with_deadline(fn, timeout, what="dispatch"):
    """Run fn(cancelled_event) on a worker thread and join it for
    `timeout` seconds. On expiry the worker is abandoned (its cancelled
    event set, so it writes no scope when it eventually finishes) and
    DispatchTimeoutError raises on the caller's thread."""
    from .executor import DispatchTimeoutError
    box = {}
    cancelled = threading.Event()

    def work():
        try:
            box["value"] = fn(cancelled)
        except BaseException as e:  # noqa: BLE001 — re-raised on caller
            box["error"] = e

    t = threading.Thread(target=work, daemon=True, name="ptt-watchdog")
    t.start()
    t.join(timeout)
    if t.is_alive():
        cancelled.set()
        raise DispatchTimeoutError(
            "%s did not complete within %.3fs (hang watchdog)"
            % (what, timeout))
    if "error" in box:
        raise box["error"]
    return box.get("value")


def dispatch_with_deadline(run_impl, timeout, what):
    """The executor's watchdog wrapper: run `run_impl(cancelled, info)`
    under `run_with_deadline` and attach the cache key the run recorded
    in `info` to a timeout raise."""
    from .executor import DispatchTimeoutError
    info = {}
    try:
        return run_with_deadline(
            lambda cancelled: run_impl(cancelled, info), timeout, what=what)
    except DispatchTimeoutError as e:
        e.cache_key = info.get("cache_key")
        raise


def run_step_traced(label, cancelled, body_fn, **span_args):
    """One `exec/step` span around `body_fn(tspan)` (parity: the JAX
    package's dispatch.run_step_traced): the span takes the thread's
    ambient trace when a layer above owns one (a serving batch), else a
    new one; a raise ends every open span of the trace with the error's
    name, and a watchdog-cancelled body ends it as DispatchCancelled."""
    tr = _trace.ambient()
    tspan = _trace.span("exec/step", cat="train",
                        trace=tr if tr is not None else _trace.new_trace(),
                        executor=label, **span_args)
    try:
        out = body_fn(tspan)
    except BaseException as e:
        err = type(e).__name__
        _trace.end_open(tspan.trace, error=err)
        tspan.end(error=err)
        raise
    if cancelled is not None and cancelled.is_set():
        _trace.end_open(tspan.trace, error="DispatchCancelled")
        tspan.end(error="DispatchCancelled")
        return out
    tspan.end()
    return out


# ---------------------------------------------------------------------------
# host-io prefetch (Executor.run(prefetch=True))
# ---------------------------------------------------------------------------

_live_prefetchers = weakref.WeakSet()


class _StagedBlock(object):
    """One prefetched pre-pass result, parked until the next run.

    Identity (program, scope, steps) decides whether the next run may
    consume it; `popped` is the exact refund ledger — (reader, records)
    in pop order, so `refund()` restores every stream position (push_back
    reversed, like the pre-pass's own rollback)."""

    __slots__ = ("program", "scope", "steps", "feeds", "stacked",
                 "popped", "error", "dropped")

    def __init__(self, program, scope, steps):
        self.program = program
        self.scope = scope
        self.steps = steps
        self.feeds = {}
        self.stacked = set()
        self.popped = []     # [(reader, [record, ...])]
        self.error = None
        self.dropped = False  # cancelled: recovery owns the positions

    def matches(self, program, scope, steps):
        return (self.program is program and self.scope is scope
                and self.steps == steps)

    def refund(self):
        if self.dropped:
            return
        for state, records in reversed(self.popped):
            for rec in reversed(records):
                state.push_back(rec)
        self.popped = []


class _OrEvent(object):
    """is_set() over the run's watchdog cancellation and the prefetcher's
    own abandon flag: the pre-pass's cancellation checkpoints honour
    either."""

    __slots__ = ("_a", "_b")

    def __init__(self, a, b):
        self._a, self._b = a, b

    def is_set(self):
        return (self._a is not None and self._a.is_set()) or \
            self._b.is_set()


class HostIoPrefetcher(object):
    """Background host-io pre-pass: pops and stacks call N+1's reader
    records while call N runs on the device (the JAX package's
    HostIoPrefetcher).

    Protocol (one owner executor, calls from its dispatch thread):
      * `kick(...)` at the end of a successful run starts the background
        pre-pass for the next call;
      * `take(program, scope, steps)` at the top of the next run waits
        for the staging thread and returns the staged block when the
        identity matches; a mismatch refunds the staged pops and returns
        None (the caller runs the pre-pass inline); a staged ERROR raises
        here, on the consuming thread, with nothing consumed (the staging
        thread refunded before parking it), and only for the matching
        identity: an error staged for another signature consumed nothing
        and is dropped. Returns CANCELLED when the caller's watchdog
        fired mid-wait;
      * `rollback()` refunds whatever is staged.

    The staging thread is the ONLY consumer of the readers between kick
    and take, so the readers need no locking; `reader.eof()` polls race
    the staging pop and are unsupported while a prefetcher is armed —
    end epochs on the EOFException instead (it surfaces at take(), the
    stream position intact). One fresh daemon thread per kick: a staged
    block's life ends crisply at take/rollback."""

    def __init__(self, name="prefetch"):
        self.name = name
        self._lock = threading.Lock()
        self._thread = None
        self._inflight = None        # _StagedBlock the thread is filling
        self._staged = None          # _StagedBlock once the thread ran
        self._abandon = threading.Event()
        _live_prefetchers.add(self)

    def has_work(self):
        """A staging thread is running or a block is parked."""
        with self._lock:
            return self._thread is not None or self._staged is not None

    def kick(self, program, scope, steps, device=None, cancelled=None):
        """Start the background pre-pass for the next call; `device` pins
        the staging device of a double-buffered reader."""
        from .executor import run_host_io_prepass
        if self.has_work():
            # defensive: the owner always takes or rolls back before it
            # kicks again; a stale block must not leak records
            self.rollback()
        with self._lock:
            self._abandon.clear()
            block = _StagedBlock(program, scope, steps)
            cancel = _OrEvent(cancelled, self._abandon)

            def work():
                ssp = _trace.span("exec/prefetch_stage", cat="train",
                                  prefetcher=self.name, steps=steps)
                try:
                    run_host_io_prepass(
                        program, scope, block.feeds, steps=steps,
                        stacked_out=block.stacked, cancelled=cancel,
                        device=device, popped_out=block.popped)
                except BaseException as e:  # noqa: BLE001 — parked for
                    # the consuming thread; what this block popped before
                    # failing goes back, so the error consumes NOTHING
                    block.refund()
                    block.error = e
                ssp.end(**({"error": type(block.error).__name__}
                           if block.error is not None else {}))
                with self._lock:
                    self._staged = block
                    self._inflight = None
                    self._thread = None

            t = threading.Thread(target=work, daemon=True,
                                 name="ptt-prefetch-%s" % self.name)
            self._thread = t
            self._inflight = block
            t.start()

    def take(self, program, scope, steps, cancelled=None):
        """Claim the staged block for this run (see the class doc)."""
        block = self._wait(cancelled)
        if block is CANCELLED or block is None:
            return block
        if not block.matches(program, scope, steps):
            if block.error is None:
                block.refund()
            return None
        if block.error is not None:
            raise block.error
        return block

    def rollback(self, cancelled=None):
        """Refund the staged pops. With `cancelled` set the block is
        dropped WITHOUT refund: the caller's recovery restores reader
        positions itself."""
        block = self._wait(cancelled)
        if block is CANCELLED or block is None:
            return
        block.refund()

    def _wait(self, cancelled=None):
        """Join the staging thread and detach the staged block. On
        watchdog cancellation mid-wait: abandon the staging thread (it
        stops at its next pre-pass checkpoint without refunding) and mark
        its block dropped."""
        while True:
            with self._lock:
                t = self._thread
                if t is None:
                    block, self._staged = self._staged, None
                    if block is not None and block.dropped:
                        block = None  # parked by an abandoned staging run
                    return block
            if cancelled is not None and cancelled.is_set():
                self._abandon.set()
                with self._lock:
                    if self._staged is not None:
                        self._staged.dropped = True
                        self._staged = None
                    if self._inflight is not None:
                        self._inflight.dropped = True
                return CANCELLED
            t.join(timeout=0.05)

    def close(self):
        """Refund anything staged and forget the prefetcher."""
        self.rollback()
        _live_prefetchers.discard(self)


def _cached_flag(program, cache, pred):
    key = (program._uid, program._version)
    if key not in cache:
        cache[key] = any(pred(op.type) for op in program.global_block().ops)
    return cache[key]


def has_read_ops(program, cache):
    """Does `program` pop reader records in its main block? Cached per
    (uid, version) in the caller's dict."""
    return _cached_flag(program, cache, lambda t: t == "read")


def has_host_io_ops(program, cache):
    """Does `program`'s main block hold any reader op (creation or
    `read`)? Cached as has_read_ops."""
    from .readers import is_host_io_op
    return _cached_flag(program, cache, is_host_io_op)


def kick_next_prepass(executor, program, scope, steps, cancelled, name,
                      **kick_kw):
    """Arm the executor's prefetcher (lazily) and kick the next call's
    pre-pass: a no-op for a readerless program (nothing to stage) and for
    a cancelled worker (its recovery owns the readers). Returns the
    prefetcher, or None when none is armed."""
    if cancelled is not None and cancelled.is_set():
        return executor._prefetcher
    if not has_read_ops(program, executor._has_read):
        return executor._prefetcher
    pf = executor._prefetcher
    if pf is None:
        pf = executor._prefetcher = HostIoPrefetcher(name=name)
    pf.kick(program, scope, steps, cancelled=cancelled, **kick_kw)
    return pf


def consume_host_io(executor, program, scope, steps, cancelled, feeds,
                    stacked_names, tspan, **inline_kw):
    """Claim the prefetcher's staged block when its identity matches
    (refunding a mismatched one BEFORE the inline pre-pass pops the
    stream, or the staged records would replay out of order), else run
    the inline pre-pass; the exec/host_io span closes on every path.
    Returns the staged block, None (the inline pre-pass ran) or
    CANCELLED."""
    from .executor import _DispatchCancelled, run_host_io_prepass
    pf = executor._prefetcher
    staged = None
    iosp = tspan.child("exec/host_io")
    try:
        if pf is not None and pf.has_work():
            # consulted on a prefetch=False call too: a block staged for
            # another signature must go back before the inline pre-pass
            staged = pf.take(program, scope, steps, cancelled=cancelled)
            if staged is CANCELLED:
                iosp.end(error="DispatchCancelled")
                return CANCELLED
        if staged is not None:
            feeds.update(staged.feeds)
            stacked_names.update(staged.stacked)
        else:
            try:
                run_host_io_prepass(program, scope, feeds, steps=steps,
                                    stacked_out=stacked_names,
                                    cancelled=cancelled, **inline_kw)
            except _DispatchCancelled:
                iosp.end(error="DispatchCancelled")
                return CANCELLED
    except BaseException as e:  # EOF / reader faults ride up
        iosp.end(error=type(e).__name__)
        raise
    iosp.end(staged=staged is not None)
    return staged


def rollback_all_staged(scope=None):
    """Quiesce hook: refund every live prefetcher's staged pops (all of
    them, or only those staging for `scope`). A checkpoint reads reader
    positions after this: a staged block's records have not trained.
    Runs on the trainer thread between runs."""
    for pf in list(_live_prefetchers):
        if not pf.has_work():
            continue
        if scope is not None:
            block = pf._staged if pf._staged is not None else pf._inflight
            if block is not None and block.scope is not scope:
                continue
        pf.rollback()


def run_dispatch_hooks(program, steps, feeds, prefetcher=None,
                       cancelled=None):
    """The pre-dispatch hooks, as the JAX package runs them: the cluster
    step barrier first (core.executor._barrier_hook), then the fault-
    injection tap (core.executor._fault_hook), which may raise, sleep or
    poison a feed of `feeds` in place. Both fire before the io pre-pass
    and the seed draw, so a fenced, failed or injected attempt consumes
    no reader record and no seed, and a retry replays bit-exactly. A raise
    refunds whatever the prefetcher staged."""
    from . import executor as _exe
    try:
        if _exe._barrier_hook is not None:
            _exe._barrier_hook("dispatch", program=program, steps=steps)
        if _exe._fault_hook is not None:
            _exe._fault_hook("dispatch", program=program, steps=steps,
                             feed_arrays=feeds)
    except BaseException:
        if prefetcher is not None:
            prefetcher.rollback(cancelled=cancelled)
        raise


def run_post_dispatch_checks(executor, errors, fetches, fetch_names,
                             new_state, context, cancelled=None):
    """The post-dispatch checks: the in-graph assertion flags (guard
    flags raise even under FLAGS_tensor_array_safety=0: a program that
    installed guards opted into their one read), with the stat channel
    riding that read into `executor.last_stats`, then the optional
    FLAGS_check_nan_inf sweep over the fetches and the new state. Any
    raise refunds the prefetcher's just-kicked next block first, so the
    stream stands where the failed run left it (its own records
    consumed, nothing more)."""
    from .executor import (GUARD_MSG_PREFIX, check_finite, pop_guard_stats,
                           raise_program_errors)
    stats = executor.last_stats = pop_guard_stats(errors) if errors else {}
    try:
        has_guards = any(m.startswith(GUARD_MSG_PREFIX) for m in errors)
        if errors and (executor._array_safety or has_guards):
            executor.flag_reads += 1
            raise_program_errors(errors,
                                 include_non_guard=executor._array_safety,
                                 stats=stats)
        if executor._check_nan_inf:
            check_finite(list(zip(fetch_names, fetches)) +
                         list(new_state.items()), context=context)
    except BaseException:
        if executor._prefetcher is not None:
            executor._prefetcher.rollback(cancelled=cancelled)
        raise


class TapCounter(object):
    """A replica's monotone dispatch counter, the key serving faults fire
    on. Owned by the pool's replica slot (not the tap), so the count
    survives engine swaps: `reload()` attaches a fresh ReplicaTap to each
    new engine, and a fault plan keyed on dispatch N sees one consistent
    sequence a replica across generations."""

    __slots__ = ("_lock", "n")

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def take(self):
        with self._lock:
            n, self.n = self.n, self.n + 1
            return n


class ReplicaTap(object):
    """The serving side of the fault-injection seam (resilience/faults.py
    `serving_fault`). A ReplicaPool attaches one to each replica engine
    (and one to a canary engine, replica_id="canary"); the engine fires it
    at the top of every batch dispatch, before padding, so a raise fails
    only that group and the batcher turns it into per-request exceptions
    the pool fails over.

    The tap holds the engine it was attached to and never follows the
    replica's engine pointer: during a swap the outgoing engine's drain
    still dispatches, and a replica_poison fired there poisons the engine
    being drained, not the new one."""

    __slots__ = ("replica_id", "engine", "counter")

    def __init__(self, replica_id, engine, counter=None):
        self.replica_id = replica_id
        self.engine = engine
        self.counter = counter if counter is not None else TapCounter()

    def __call__(self):
        count = self.counter.take()
        from ..resilience import faults as _faults
        plan = _faults.active_plan()
        if plan is not None:
            plan.serving_fault(self.replica_id, count, engine=self.engine)
