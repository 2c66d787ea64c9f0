"""Serving metrics: latency percentiles, batch occupancy, request counts.

Parity: the JAX package's serving/metrics.py `ServingMetrics` (the
Prometheus exposition and the decode metrics are not ported yet). One
`ServingMetrics` per `InferenceEngine`; writers are the request threads
and the batcher worker, readers call `snapshot()`, all under one lock.
"""
import collections
import threading
import time

__all__ = ["ServingMetrics"]


def _percentile(sorted_vals, q):
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServingMetrics(object):
    """Thread-safe counters + a bounded latency window.

    Occupancy counts REQUESTS per batch (the coalescing win); row
    utilization is real rows over padded bucket rows.
    """

    def __init__(self, latency_window=2048):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests_total = 0        # accepted into the queue
        self.responses_total = 0       # scattered back successfully
        self.rejected_queue_full = 0   # fast backpressure rejections
        self.deadline_expired = 0      # dropped before batching
        self.errors_total = 0          # dispatch/scatter failures
        self.batches_total = 0         # device dispatches
        self.batch_requests_total = 0  # requests across all batches
        self.batch_rows_total = 0      # real rows across all batches
        self.bucket_rows_total = 0     # padded bucket rows dispatched
        self._latencies = collections.deque(maxlen=latency_window)
        self._queue_depth_fn = None    # live gauge, set by the batcher

    def bind_queue_depth(self, fn):
        self._queue_depth_fn = fn

    def on_submit(self):
        with self._lock:
            self.requests_total += 1

    def on_queue_full(self):
        with self._lock:
            self.rejected_queue_full += 1

    def on_deadline_expired(self, n=1):
        with self._lock:
            self.deadline_expired += n

    def on_error(self, n=1):
        with self._lock:
            self.errors_total += n

    def on_batch(self, num_requests, num_rows, bucket_rows, latencies_s):
        """One dispatch scattered; latencies_s are per-request submit ->
        scatter times."""
        with self._lock:
            self.batches_total += 1
            self.batch_requests_total += num_requests
            self.batch_rows_total += num_rows
            self.bucket_rows_total += bucket_rows
            self.responses_total += num_requests
            self._latencies.extend(latencies_s)

    def queue_depth(self):
        fn = self._queue_depth_fn
        return fn() if fn is not None else 0

    def snapshot(self):
        with self._lock:
            lat = sorted(self._latencies)
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            batches = max(self.batches_total, 1)
            return {
                "uptime_s": elapsed,
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected_queue_full": self.rejected_queue_full,
                "deadline_expired": self.deadline_expired,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "qps": self.responses_total / elapsed,
                "mean_batch_occupancy":
                    self.batch_requests_total / batches,
                "row_utilization":
                    self.batch_rows_total / max(self.bucket_rows_total, 1),
                "queue_depth": self.queue_depth(),
                "latency_ms": {
                    "p50": _percentile(lat, 0.50) * 1e3,
                    "p95": _percentile(lat, 0.95) * 1e3,
                    "p99": _percentile(lat, 0.99) * 1e3,
                    "window": len(lat),
                },
            }
