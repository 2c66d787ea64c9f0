"""PoolAutoscaler: the fleet controller that grows and shrinks a
ReplicaPool from signals the pool already measures.

Parity: the JAX package's serving/autoscaler.py, the same control loop;
`tick(now=)` drives it without the clock or the thread.

The reference era made the *user* own deployment sizing: listen_and_serv
was a fixed-size endpoint, and a traffic step either fit or 429'd until
an operator noticed. The TensorFlow system paper's stance (the runtime,
not the user, owns placement and scaling — arXiv:1605.08695) applied to
this repo's serving stack: a small control loop samples three signals
every `interval_s` and drives the pool's membership verbs
(`add_replica` / `remove_replica`) between `[min_replicas,
max_replicas]`:

  * **AIMD admission pressure** — the delta of the pool's 429 counter
    (`PoolMetrics.rejected_queue_full`) since the last tick. Any
    rejection means clients are being shed RIGHT NOW: the strongest
    scale-up signal there is.
  * **queue depth** — aggregate queued requests vs aggregate queue
    capacity; a queue filling past `up_queue_frac` scales up BEFORE the
    429s start.
  * **idle** — no rejections, no queued work, nothing in flight for
    `down_idle_s` continuous seconds scales down one replica (never
    below `min_replicas`).

Scale-up builds and WARMS the new engine before it joins routing (an
eager engine warmed at every bucket: no AOT compile cache until ROADMAP
A11; `last_scale_up_s` times it); the admission ceiling opens to the
grown capacity immediately (`_Admission.set_bounds`), so absorbed load
does not wait for additive recovery. Scale-down retires the youngest
replica (no new traffic), DRAINS everything already accepted on it, and
only then closes — a contraction can never fail an accepted request.

Cooldowns bound the loop: `scale_up_cooldown_s` between grows (one
warmup at a time; a burst scales one replica per cooldown until the
signal clears or max is hit) and `scale_down_cooldown_s` between
shrinks (and after any grow — flapping wastes exactly the warm starts
scale-up depends on). Decisions land in `pool.events`
(`scale_up`/`scale_down`) and the flight recorder
(`pool/scale_up` instants); `state()` rides `pool_state()` onto
/healthz.
"""
import threading
import time

__all__ = ["PoolAutoscaler"]


class PoolAutoscaler(object):
    def __init__(self, pool, min_replicas, max_replicas,
                 interval_s=0.25, up_queue_frac=0.5,
                 scale_up_cooldown_s=1.0, scale_down_cooldown_s=5.0,
                 down_idle_s=3.0):
        if int(min_replicas) < 1:
            raise ValueError("min_replicas must be >= 1, got %r"
                             % (min_replicas,))
        if int(max_replicas) < int(min_replicas):
            raise ValueError(
                "max_replicas (%r) must be >= min_replicas (%r)"
                % (max_replicas, min_replicas))
        self.pool = pool
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.up_queue_frac = float(up_queue_frac)
        self.scale_up_cooldown_s = float(scale_up_cooldown_s)
        self.scale_down_cooldown_s = float(scale_down_cooldown_s)
        self.down_idle_s = float(down_idle_s)

        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        self._last_rejects = pool.metrics.snapshot()["rejected_queue_full"]
        self._idle_since = None
        self._up_ok_at = 0.0     # monotonic cooldown gates
        self._down_ok_at = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_scale_up_s = None    # wall seconds of the last grow
        # (engine build + warmup)
        self.last_error = None

    # ----------------------------------------------------------- control --
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptpu-autoscaler")
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the control loop
                # must outlive a transient failure (e.g. a scale-up
                # racing close()); the error is visible, not fatal
                self.last_error = repr(e)

    # -------------------------------------------------------------- tick --
    def tick(self, now=None):
        """One control decision. Public (and `now`-injectable) so tests
        can drive the loop deterministically without the thread."""
        pool = self.pool
        if pool.closed:
            return None
        now = time.monotonic() if now is None else now
        snap = pool.metrics.snapshot()
        rejects = snap["rejected_queue_full"]
        with self._lock:
            reject_delta = rejects - self._last_rejects
            self._last_rejects = rejects
        live = pool.live_replica_count()
        qd = pool.queue_depth()
        cap = pool.queue_capacity_total()
        inflight = pool.total_inflight()

        busy = reject_delta > 0 or qd > 0 or inflight > 0
        if busy:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        want_up = (reject_delta > 0
                   or (cap > 0 and qd >= self.up_queue_frac * cap))
        if want_up and live < self.max_replicas and now >= self._up_ok_at:
            t0 = time.monotonic()
            idx = pool.add_replica()
            self.last_scale_up_s = time.monotonic() - t0
            self.scale_ups += 1
            self._up_ok_at = now + self.scale_up_cooldown_s
            # a fresh grow resets the shrink clock: don't contract the
            # capacity we just paid a warmup for
            self._down_ok_at = now + self.scale_down_cooldown_s
            self._idle_since = None
            return ("up", idx)

        if (live > self.min_replicas
                and self._idle_since is not None
                and now - self._idle_since >= self.down_idle_s
                and now >= self._down_ok_at):
            idx = pool.remove_replica(timeout=30.0)
            self.scale_downs += 1
            self._down_ok_at = now + self.scale_down_cooldown_s
            return ("down", idx)
        return None

    # ------------------------------------------------------------- state --
    def state(self):
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "live_replicas": self.pool.live_replica_count(),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "last_scale_up_s": (round(self.last_scale_up_s, 3)
                                if self.last_scale_up_s is not None
                                else None),
            "interval_s": self.interval_s,
            "last_error": self.last_error,
        }
