"""Micro-batching: a bounded queue and one worker that coalesces requests.

Parity: the JAX package's serving/batcher.py `Batcher`. Requests enter
via `submit()` (any thread) and wait at most `max_queue_delay_ms` — or
until `max_batch_size` rows are pending — before a worker pops a
contiguous batch.

  * pipeline_depth >= 1 (the engine's default is 2): continuous batching.
    A formation worker owns the request queue and a dispatch worker owns
    the device, joined by a short formed-batch queue; up to
    `pipeline_depth` dispatches stay outstanding on the device, tracked by
    a core/dispatch.InflightWindow whose completion thread waits on a CUDA
    event behind each dispatch and recycles its slot — off the dispatch
    path, which makes no host sync.
  * pipeline_depth=0: the serial loop — form -> pad -> dispatch ->
    scatter on one thread.

Robustness contract:
  * bounded queue — `submit()` on a full queue raises `QueueFullError`
    immediately,
  * per-request deadlines — expired requests never reach the device,
  * graceful shutdown — `close(drain=True)` stops intake, drains every
    queued and formed request, then joins the workers; `close(drain=False)`
    fails queued and formed requests immediately, and a dispatch worker
    parked on a full window gives up its batch rather than wedge.
"""
import collections
import threading
import time

__all__ = ["Batcher", "RequestFuture", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServingClosedError",
           "RequestTooLargeError"]


class ServingError(RuntimeError):
    """Base class for serving-runtime errors."""


class QueueFullError(ServingError):
    """Fast rejection: the bounded request queue is at capacity."""
    retry_after_s = None


class DeadlineExceededError(ServingError):
    """The request's deadline passed while it waited in the queue."""


class ServingClosedError(ServingError):
    """The engine is shutting down (or closed) and rejects new work."""


class RequestTooLargeError(ServingError):
    """A single request exceeds max_batch_size rows."""


class RequestFuture(object):
    """Completion handle for one submitted request: `result(timeout)`
    blocks until a worker scatters the batch output (an
    `engine.ResultSlice`, still on the device: `numpy()` copies this
    request's rows) or fails the request."""

    __slots__ = ("_event", "_value", "_error", "_callbacks", "_cb_lock",
                 "latency_s", "bucket")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._callbacks = []
        self._cb_lock = threading.Lock()
        self.latency_s = None   # submit -> scatter, set by the worker
        self.bucket = None      # (batch_bucket, seq_bucket|None) dispatched

    def done(self):
        return self._event.is_set()

    def add_done_callback(self, fn):
        """Run fn(self) once the future completes — at once (on the
        calling thread) if it already has, else on the completing thread
        (a batcher worker). Callbacks must be cheap and must not block:
        they run inside the dispatch loop."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire_callbacks(self):
        self._event.set()
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — an observer must never
                pass           # fail the dispatch loop that notified it

    def set_result(self, value):
        self._value = value
        self._fire_callbacks()

    def set_exception(self, exc):
        self._error = exc
        self._fire_callbacks()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within %rs" % timeout)
        if self._error is not None:
            raise self._error
        return self._value


# dispatch this far ahead of a pending deadline
_DEADLINE_MARGIN_S = 1e-3


class _Request(object):
    __slots__ = ("feed", "rows", "future", "deadline", "enqueued_at")

    def __init__(self, feed, rows, deadline):
        self.feed = feed
        self.rows = rows
        self.future = RequestFuture()
        self.deadline = deadline          # monotonic seconds, or None
        self.enqueued_at = time.monotonic()


def _fail_closed(reqs):
    for req in reqs:
        if not req.future.done():
            req.future.set_exception(ServingClosedError(
                "serving engine shut down before dispatch"))


class Batcher(object):
    """The coalescing pipeline. `dispatch_fn(requests)` (the engine) pads
    the requests into one bucket, runs the program once, scatters
    per-request results into `req.future` and returns the batch's fetch
    tensors; the batcher decides WHAT rides in a batch, WHEN it leaves
    and HOW MANY batches may be in flight on the device at once."""

    def __init__(self, dispatch_fn, max_batch_size=32, max_queue_delay_ms=5,
                 queue_capacity=256, metrics=None, name="batcher",
                 pipeline_depth=2):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self._dispatch = dispatch_fn
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_s = float(max_queue_delay_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self.pipeline_depth = int(pipeline_depth)
        self._metrics = metrics
        self._queue = collections.deque()
        self._pending_rows = 0   # running sum over _queue
        self._deadlined = 0      # queued requests that carry a deadline
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._draining = False
        self._drainers = 0       # live drain() calls: skip the window
        self._dispatching = False
        self._formed = collections.deque()  # formed, awaiting dispatch
        self._formed_cap = max(1, self.pipeline_depth)
        self._form_busy = False  # formation holds a popped batch
        self._form_done = False  # formation worker exited
        self._window = None
        if self.pipeline_depth >= 1:
            from ..core.dispatch import InflightWindow
            self._window = InflightWindow(self.pipeline_depth,
                                          tag="serving/%s" % name)
            self._workers = [
                threading.Thread(target=self._form_loop, daemon=True,
                                 name="ptt-%s-form" % name),
                threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name="ptt-%s-dispatch" % name)]
        else:
            self._workers = [threading.Thread(
                target=self._loop, daemon=True, name="ptt-" + name)]
        if metrics is not None:
            metrics.bind_queue_depth(lambda: len(self._queue))
        for w in self._workers:
            w.start()

    # ---------------------------------------------------------- intake --
    def submit(self, feed, rows, deadline_ms=None):
        """Enqueue one request; returns its RequestFuture. Raises
        QueueFullError / ServingClosedError / RequestTooLargeError
        without blocking."""
        if rows < 1:
            raise ValueError("request must carry at least one row")
        if rows > self.max_batch_size:
            raise RequestTooLargeError(
                "request has %d rows but max_batch_size is %d"
                % (rows, self.max_batch_size))
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        req = _Request(feed, rows, deadline)
        with self._cond:
            if self._closed:
                raise ServingClosedError("serving engine is shut down")
            if len(self._queue) >= self.queue_capacity:
                if self._metrics is not None:
                    self._metrics.on_queue_full()
                raise QueueFullError(
                    "request queue at capacity (%d); retry with backoff"
                    % self.queue_capacity)
            self._queue.append(req)
            self._pending_rows += req.rows
            if req.deadline is not None:
                self._deadlined += 1
            # the formation worker, the dispatch worker and any drainers
            # share this condition
            self._cond.notify_all()
        if self._metrics is not None:
            self._metrics.on_submit()
        return req.future

    def queue_depth(self):
        return len(self._queue)

    def pipeline_stats(self):
        """The in-flight window's stats ({"depth", "completed", "idle_s",
        "gaps"}), or None in serial mode."""
        if self._window is None:
            return None
        stats = self._window.stats()
        stats["depth"] = self._window.depth
        return stats

    # ---------------------------------------------------------- worker --
    def _collect_batch(self):
        """Wait for work, honor the delay/size policy, pop one batch.
        Returns (requests, expired) or (None, None) on shutdown."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None, None
                self._cond.wait()
            # coalescing window anchored at the OLDEST pending request; a
            # full batch leaves at once, and a pending deadline inside the
            # window caps it
            leave_at = self._queue[0].enqueued_at + self.max_queue_delay_s
            while not (self._closed or self._draining or self._drainers):
                if self._pending_rows >= self.max_batch_size \
                        or leave_at <= time.monotonic():
                    break
                wake_at = leave_at
                if self._deadlined:
                    wake_at = min(
                        [leave_at] + [r.deadline - _DEADLINE_MARGIN_S
                                      for r in self._queue
                                      if r.deadline is not None])
                remaining = wake_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch, expired, rows, now = [], [], 0, time.monotonic()
            while self._queue:
                req = self._queue[0]
                if req.deadline is not None and req.deadline < now:
                    expired.append(self._pop_head())
                    continue
                if rows + req.rows > self.max_batch_size:
                    break
                batch.append(self._pop_head())
                rows += req.rows
            # busy while STILL holding the lock, so a drain() cannot
            # declare victory with a popped batch between the queues
            if self._window is not None:
                self._form_busy = bool(batch)
            else:
                self._dispatching = bool(batch)
            return batch, expired

    def _pop_head(self):
        """Pop the queue head, keeping the counters true (lock held)."""
        req = self._queue.popleft()
        self._pending_rows -= req.rows
        if req.deadline is not None:
            self._deadlined -= 1
        return req

    def _fail_expired(self, expired):
        for req in expired:
            if not req.future.done():
                req.future.set_exception(DeadlineExceededError(
                    "deadline passed after %.1fms in queue"
                    % ((time.monotonic() - req.enqueued_at) * 1e3)))
        if expired and self._metrics is not None:
            self._metrics.on_deadline_expired(len(expired))

    def _run_batch(self, batch):
        """Dispatch one formed batch: deadline re-check (a formed batch
        may have waited behind a full window), window slot, dispatch,
        completion tracking."""
        now = time.monotonic()
        live = [r for r in batch
                if r.deadline is None or r.deadline >= now]
        if len(live) != len(batch):
            self._fail_expired([r for r in batch if r not in live])
        if not live:
            return
        window = self._window
        if window is not None:
            # park until the device finishes a batch; poll, so a hard
            # close cannot wedge this worker behind a slot that never frees
            while not window.acquire(timeout=0.1):
                with self._cond:
                    if self._closed and not self._draining:
                        _fail_closed(live)
                        return
        enq_t = time.monotonic()
        try:
            handles = self._dispatch(live)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the
            if window is not None:   # worker: serving outlives one bad
                window.release()     # batch
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
            if self._metrics is not None:
                self._metrics.on_error(len(live))
        else:
            if window is not None:
                window.track(handles or (), enq_t)

    def _loop(self):
        """Serial mode (pipeline_depth=0): form -> dispatch, one thread."""
        while True:
            batch, expired = self._collect_batch()
            if batch is None:
                return
            self._fail_expired(expired)
            if not batch:
                if expired:
                    with self._cond:
                        self._cond.notify_all()  # wake drain() waiters
                continue
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self._dispatching = False
                    self._cond.notify_all()   # wake drain() waiters

    def _form_loop(self):
        """Pipelined formation: owns the request queue and hands formed
        batches to the dispatch worker through the bounded formed queue;
        while one batch dispatches, the next one forms here."""
        while True:
            batch, expired = self._collect_batch()
            if batch is None:
                break
            self._fail_expired(expired)
            if not batch:
                if expired:
                    with self._cond:
                        self._cond.notify_all()
                continue
            with self._cond:
                while len(self._formed) >= self._formed_cap \
                        and not self._closed:
                    self._cond.wait()
                self._form_busy = False
                self._cond.notify_all()
                if self._closed and not self._draining:
                    _fail_closed(batch)   # a hard close caught it formed
                    continue
                self._formed.append(batch)
        with self._cond:
            self._form_done = True
            self._cond.notify_all()

    def _dispatch_loop(self):
        """Pipelined dispatch: enqueues formed batches behind the
        in-flight window; exits once formation has exited and the formed
        queue is empty."""
        while True:
            with self._cond:
                while not self._formed and not self._form_done:
                    self._cond.wait()
                if not self._formed:
                    return
                batch = self._formed.popleft()
                self._dispatching = True
                self._cond.notify_all()  # formation may wait on space
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self._dispatching = False
                    self._cond.notify_all()   # wake drain() waiters

    # ----------------------------------------------------------- drain --
    def drain(self, timeout=None):
        """Block until everything queued, formed or mid-dispatch has been
        scattered. Intake stays open; while a drain waits the workers skip
        the coalescing window. Returns True when drained, False on
        timeout."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            self._drainers += 1
            self._cond.notify_all()
            try:
                while self._queue or self._formed or self._form_busy \
                        or self._dispatching:
                    if not any(w.is_alive() for w in self._workers) \
                            and not self._queue and not self._formed:
                        return True
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False
                    self._cond.wait(timeout=remaining)
                return True
            finally:
                self._drainers -= 1

    # -------------------------------------------------------- shutdown --
    def close(self, drain=True, timeout=None):
        """Stop intake; with drain=True the workers finish every queued
        request first, otherwise queued and formed requests fail with
        ServingClosedError. The window closes after the workers, once
        every tracked dispatch has completed."""
        with self._cond:
            already = self._closed
            self._closed = True
            if drain and not already:
                self._draining = True
            if not drain and not already:
                while self._queue:
                    _fail_closed([self._pop_head()])
                while self._formed:
                    _fail_closed(self._formed.popleft())
            self._cond.notify_all()
        if already:
            return
        if drain:
            self.drain(timeout)
        for w in self._workers:
            w.join(timeout)
        if self._window is not None:
            self._window.close(timeout)
