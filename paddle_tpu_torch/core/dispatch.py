"""The dispatch core the serving batcher and the executor front.

Parity: the JAX package's core/dispatch.py — its `InflightWindow` and its
watchdog pair `run_with_deadline` / `dispatch_with_deadline`. The host-io
prefetcher of that module waits for in-graph reader ops (ROADMAP A8).

  * `InflightWindow` bounds how many dispatches may be outstanding on the
    device at once (the serving batcher's continuous-batching window).
    A dispatch returns its fetch tensors without a host sync; `track()`
    records a CUDA event on the current stream behind them, and a
    completion thread waits on those events in FIFO order — the window's
    one host sync, off the dispatch path — and frees the slot. On the CPU
    a dispatch has finished by the time it returns, so its handle
    completes at once. The completion thread also sums the device's idle
    gaps (one dispatch's completion to the next one's enqueue).

  * `run_step_traced` wraps one Executor run in its `exec/step` span,
    inheriting the thread's ambient trace (the serving batcher scopes
    each batch's trace around its dispatch).

  * `run_with_deadline` runs a function on a worker thread and gives up
    on it after `timeout` seconds; `dispatch_with_deadline` is the
    executor's wrapper that attaches the run's cache key to the raise.
"""
import queue
import threading
import time

import torch

from ..observability import registry as _obsreg
from ..observability import trace as _trace

__all__ = ["InflightWindow", "run_with_deadline", "dispatch_with_deadline",
           "run_step_traced"]

_CLOSE = object()


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
