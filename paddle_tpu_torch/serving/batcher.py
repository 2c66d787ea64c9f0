"""Micro-batching: a bounded queue and one worker that coalesces requests.

Parity: the JAX package's serving/batcher.py `Batcher` with
`pipeline_depth=0` — the serial loop: form a batch -> pad -> dispatch ->
scatter, on one thread. Requests enter via `submit()` (any thread) and wait
at most `max_queue_delay_ms` — or until `max_batch_size` rows are pending
— before the worker pops a contiguous batch. Pipelined dispatch
(`pipeline_depth > 0`) needs an in-flight window over CUDA events and
comes with a later slice of the port.

Robustness contract:
  * bounded queue — `submit()` on a full queue raises `QueueFullError`
    immediately,
  * per-request deadlines — expired requests never reach the device,
  * graceful shutdown — `close(drain=True)` stops intake, drains every
    queued request, then joins the worker; `close(drain=False)` fails
    queued requests immediately.
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
    blocks until the worker scatters the batch output (an
    `engine.ResultSlice`) or fails the request."""

    __slots__ = ("_event", "_value", "_error", "latency_s", "bucket")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self.latency_s = None   # submit -> scatter, set by the worker
        self.bucket = None      # (batch_bucket, seq_bucket|None) dispatched

    def done(self):
        return self._event.is_set()

    def set_result(self, value):
        self._value = value
        self._event.set()

    def set_exception(self, exc):
        self._error = exc
        self._event.set()

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


class Batcher(object):
    """The coalescing loop. `dispatch_fn(requests)` (the engine) pads the
    requests into one bucket, runs the program once and scatters
    per-request results into `req.future`; the batcher decides WHAT rides
    in a batch and WHEN it leaves."""

    def __init__(self, dispatch_fn, max_batch_size=32, max_queue_delay_ms=5,
                 queue_capacity=256, metrics=None, name="batcher",
                 pipeline_depth=0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if pipeline_depth != 0:
            raise NotImplementedError(
                "pipeline_depth=%r: pipelined dispatch (an in-flight window "
                "over CUDA events) comes with a later slice of the port; "
                "use pipeline_depth=0" % (pipeline_depth,))
        self._dispatch = dispatch_fn
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_s = float(max_queue_delay_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self.pipeline_depth = 0
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
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="ptt-" + name)
        if metrics is not None:
            metrics.bind_queue_depth(lambda: len(self._queue))
        self._worker.start()

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
            self._cond.notify_all()
        if self._metrics is not None:
            self._metrics.on_submit()
        return req.future

    def queue_depth(self):
        return len(self._queue)

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
            # declare victory with a popped batch mid-flight
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
        try:
            self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the
            for req in batch:   # worker: serving outlives one bad batch
                if not req.future.done():
                    req.future.set_exception(e)
            if self._metrics is not None:
                self._metrics.on_error(len(batch))

    def _loop(self):
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

    # ----------------------------------------------------------- drain --
    def drain(self, timeout=None):
        """Block until everything queued or mid-dispatch has been
        scattered. Intake stays open; while a drain waits the worker skips
        the coalescing window. Returns True when drained, False on
        timeout."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            self._drainers += 1
            self._cond.notify_all()
            try:
                while self._queue or self._dispatching:
                    if not self._worker.is_alive() and not self._queue:
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
        """Stop intake; with drain=True the worker finishes every queued
        request first, otherwise pending requests fail with
        ServingClosedError."""
        with self._cond:
            already = self._closed
            self._closed = True
            if drain and not already:
                self._draining = True
            if not drain and not already:
                while self._queue:
                    self._pop_head().future.set_exception(
                        ServingClosedError("serving engine shut down "
                                           "before dispatch"))
            self._cond.notify_all()
        if already:
            return
        if drain:
            self.drain(timeout)
        self._worker.join(timeout)
