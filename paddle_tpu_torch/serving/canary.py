"""Canary / shadow promotion on top of ReplicaPool.reload().

Parity: the JAX package's serving/canary.py (`CanaryFuture`,
`CanaryController`, `_divergence`, `_default_bound` over the port's
`quantize.divergence_bound`), the same host logic.

`pool.reload()` is all-or-nothing: every replica flips to the new
weights, and a bad push serves garbage from 100% of the fleet until an
operator notices. `pool.promote()` makes promotion SAFE: the candidate
snapshot first earns its traffic.

  * **canary mode** — a configurable slice of requests
    (`traffic_fraction`, counter-based so the slice is deterministic)
    is answered by ONE warmed canary engine built off the candidate.
    Every canaried request is also MIRRORED to an incumbent replica
    through the pool's normal failover machinery, which is what makes
    the zero-client-error guarantee structural: the client's answer is
    the canary's only when it was already in hand when the incumbent's
    completed AND this request's gate passes (finite outputs,
    divergence vs the mirror within the bound, latency within the
    ratio); on any breach — or a canary still running — the client
    silently gets the incumbent's answer with zero added latency (the
    gate is then judged off the response path, and a canary that never
    answers is reaped as a timeout breach) — a corrupt or wedged canary
    can NEVER surface as a client error or a latency spike, only as
    gate breaches that roll the promotion back.
  * **shadow mode** — same machinery, but the client always gets the
    incumbent's answer and the canary is judged off the response path
    (compare-only). Zero client risk by construction; use it to soak a
    candidate before a canary run.

Gating rides the quantized-serving divergence measure: per request,
max |c - i| / (max|i| + 1e-6) over the fetches, and the default bound
resolves PADDLE_TPU_CANARY_BOUND -> `quantize.divergence_bound(dtype)`
for a quantized canary -> 0.05. Latency gates on canary-vs-mirror
submit->scatter time (`latency_ratio` x mirror + `latency_margin_s`).

The state machine (exposed as `pool.pool_state()["promotion"]`):

    canary|shadow --breaches >= max_breaches--> rolled_back
    canary|shadow --oks >= min_requests------> promoting
    promoting --pool.reload(candidate) ok----> promoted
    promoting --reload raises----------------> rolled_back
    canary|shadow --cancel()-----------------> cancelled

`rolled_back` closes the canary engine (no drain — its weights are
suspect) and routes 100% of traffic to the incumbent replicas, which
never stopped serving; `promoted` runs the ordinary zero-downtime
`reload()` onto the candidate source (warmed engines, nothing dropped)
and then retires the canary engine gracefully. Fault injection:
`canary_poison@N` (resilience/faults.py) corrupts the canary engine's
weights at its Nth dispatch — the bad-canary case, provable on the CPU
and on the card.
"""
import os
import threading
import time

import numpy as np

__all__ = ["CanaryController", "CanaryFuture"]

# active (routing) -> terminal states
CANARY, SHADOW = "canary", "shadow"
PROMOTING, PROMOTED = "promoting", "promoted"
ROLLED_BACK, CANCELLED = "rolled_back", "cancelled"
_ROUTING = (CANARY, SHADOW)


def _default_bound(engine):
    """Explicit arg > PADDLE_TPU_CANARY_BOUND > the quantized-serving
    bound for a non-fp32 canary > 0.05 (a same-architecture candidate
    that moves outputs more than 5% relative is not a safe promote
    without an explicit, intentional bound)."""
    env = os.environ.get("PADDLE_TPU_CANARY_BOUND", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    dtype = getattr(engine, "weights_dtype", "fp32")
    if dtype != "fp32":
        from .quantize import divergence_bound
        return divergence_bound(dtype)
    return 0.05


def _divergence(canary_out, mirror_out):
    """max over fetches of max |c - i| / (max|i| + 1e-6) — the
    quantized-serving formula, per request."""
    worst = 0.0
    for name, ref in mirror_out.items():
        if name not in canary_out:
            return float("inf")   # missing fetch = maximally divergent
        f = np.asarray(ref, dtype=np.float64)
        q = np.asarray(canary_out[name], dtype=np.float64)
        if f.shape != q.shape:
            return float("inf")
        if f.size:
            worst = max(worst, float(np.abs(q - f).max()
                                     / (np.abs(f).max() + 1e-6)))
    return worst


class CanaryFuture(object):
    """One canaried request: a normal pool future (the incumbent
    mirror, full failover guarantees) plus the canary engine's future.
    `result()` NEVER waits on the canary: the canary's answer is served
    only when it was already in hand by the time the incumbent's answer
    completed AND this request's gate passed; in every other case —
    breach, canary still running, canary wedged — the client silently
    gets the mirror's answer with zero added latency, and the gate is
    judged off the response path (the controller's pending reaper
    breaches a canary that never answers within `canary_wait_s`). A
    mirror failure propagates exactly as it would for a non-canaried
    request — the canary can only ever improve on the incumbent path,
    never regress it."""

    __slots__ = ("_ctrl", "_mirror", "_cfut", "_submitted_at",
                 "_gate_done", "_final", "latency_s", "bucket")

    def __init__(self, ctrl, mirror, cfut):
        self._ctrl = ctrl
        self._mirror = mirror
        self._cfut = cfut          # engine RequestFuture, or the submit
        self._submitted_at = time.monotonic()  # exception instance
        self._gate_done = False    # controller recorded ONE sample
        self._final = None         # the answer served (stable across
        self.latency_s = None      # repeated result() calls)
        self.bucket = None

    def done(self):
        return self._mirror.done()

    def result(self, timeout=None):
        if self._final is not None:
            return self._final
        value = self._mirror.result(timeout)   # raises = the incumbent
        # path failed; identical to a non-canaried request
        self.latency_s = self._mirror.latency_s
        self.bucket = self._mirror.bucket
        ctrl = self._ctrl
        out = value
        cfut = self._cfut
        if not hasattr(cfut, "result"):
            # canary submit failed at claim time: breach, mirror serves
            ctrl.judge(self, value.numpy(), self.latency_s)
        elif cfut.done():
            if ctrl.mode == CANARY:
                verdict, canary_value = ctrl.judge(
                    self, value.numpy(), self.latency_s,
                    want_value=True)
                if verdict == "ok" and canary_value is not None:
                    out = canary_value
            else:
                ctrl.judge(self, value.numpy(), self.latency_s)
        else:
            # the canary hasn't answered and the incumbent has: serve
            # the mirror NOW and judge on the canary's completing
            # thread later — a slow or wedged canary must not add a
            # millisecond to any client's latency
            mirror_out = value.numpy()
            lat = self.latency_s
            ctrl.note_pending(self)
            cfut.add_done_callback(
                lambda _f: ctrl.judge(self, mirror_out, lat))
        self._final = out
        return out


class CanaryController(object):
    def __init__(self, pool, engine, source, mode=CANARY,
                 traffic_fraction=0.05, min_requests=32, max_breaches=3,
                 divergence_bound=None, latency_ratio=3.0,
                 latency_margin_s=0.05, canary_wait_s=None,
                 auto_finalize=True):
        if not (0.0 < float(traffic_fraction) <= 1.0):
            raise ValueError("traffic_fraction must be in (0, 1], got %r"
                             % (traffic_fraction,))
        self.pool = pool
        self.engine = engine            # the warmed candidate engine
        self._source = dict(source)     # reload(**source) on promote
        self.mode = mode
        self.traffic_fraction = float(traffic_fraction)
        self._interval = max(1, int(round(1.0 / self.traffic_fraction)))
        self.min_requests = int(min_requests)
        self.max_breaches = int(max_breaches)
        self.divergence_bound = (float(divergence_bound)
                                 if divergence_bound is not None
                                 else _default_bound(engine))
        self.latency_ratio = (float(latency_ratio)
                              if latency_ratio is not None else None)
        self.latency_margin_s = float(latency_margin_s)
        self.canary_wait_s = (float(canary_wait_s)
                              if canary_wait_s is not None
                              else (pool.attempt_timeout_s or 10.0))
        self.auto_finalize = bool(auto_finalize)

        self._lock = threading.Lock()
        self._state = mode
        self._pending = []     # (fut, deadline): canaries judged off
        # the response path, reaped as timeout breaches if they never
        # answer (see _reap_pending)
        self._sel = 0          # request counter for the traffic slice
        self.sampled = 0       # canaried requests judged
        self.oks = 0
        self.breaches = 0
        self.breach_kinds = {}
        self.max_divergence = 0.0
        self.reason = None
        self.promoted_step = None
        self.started_at = time.monotonic()

    # ---------------------------------------------------------- routing --
    def is_routing(self):
        return self._state in _ROUTING

    def maybe_submit(self, norm, deadline_ms):
        """Called by pool.submit for every accepted request: claim this
        one for the slice (deterministic counter, not randomness) or
        return None for the normal path. A claimed request gets the
        mirror attempt (pool machinery) + the canary attempt."""
        if not self.is_routing():
            return None
        self._reap_pending()   # a wedged canary's unanswered requests
        # become timeout breaches here — without this touchpoint a
        # canary that never answers would stall the promotion forever
        if not self.is_routing():
            return None        # the reap may just have rolled back
        with self._lock:
            take = self._sel % self._interval == 0
            self._sel += 1
        if not take:
            return None
        from .pool import PoolFuture
        mirror = PoolFuture(self.pool, norm, deadline_ms)
        self.pool._submit_attempt(mirror)
        try:
            cfut = self.engine.submit_normalized(norm,
                                                 deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 — a canary that cannot
            # even accept its slice is a breach, never a client error
            cfut = e
        return CanaryFuture(self, mirror, cfut)

    # ---------------------------------------------------------- judging --
    def note_pending(self, fut):
        """A canaried request whose mirror answered first: judged when
        the canary completes (done-callback), or reaped as a timeout
        breach canary_wait_s after the mirror served."""
        with self._lock:
            self._pending.append((fut,
                                  time.monotonic() + self.canary_wait_s))

    def _reap_pending(self):
        """Expire unanswered off-path canaries as timeout breaches.
        Called from the controller's touchpoints (new claims, later
        judgments) — no dedicated thread; the clients involved were
        served mirror answers long ago."""
        now = time.monotonic()
        expired = []
        with self._lock:
            keep = []
            for fut, deadline in self._pending:
                if fut._gate_done:
                    continue           # judged by its callback already
                if now >= deadline:
                    fut._gate_done = True
                    expired.append(fut)
                else:
                    keep.append((fut, deadline))
            self._pending = keep
        for _ in expired:
            self._record_breach(
                "timeout", "canary did not answer within %.1fs"
                % self.canary_wait_s)

    def judge(self, fut, mirror_out, mirror_latency_s, want_value=False):
        """Gate one canaried request — on the client thread when the
        canary answered before the mirror, else on the canary's
        completing thread (off the response path). Idempotent per
        request. Returns (verdict, canary_PoolResult|None); verdict
        'ok' means the canary's answer may be served."""
        from .pool import PoolResult
        with self._lock:
            if fut._gate_done:
                return "skip", None
            fut._gate_done = True
        self._reap_pending()
        if not self.is_routing():
            return "skip", None
        cfut = fut._cfut
        if not hasattr(cfut, "result"):       # submit failed at claim
            self._record_breach("submit", repr(cfut))
            return "breach", None
        try:
            # the canary future is DONE on every path that reaches here
            # (inline = done-check, callback = completion): this never
            # blocks a client
            slice_ = cfut.result(1.0)
            outputs = slice_.numpy()
        except Exception as e:  # noqa: BLE001 — canary error/timeout:
            self._record_breach("error", repr(e))   # breach, not client
            return "breach", None                   # visible
        for name, arr in outputs.items():
            a = np.asarray(arr)
            if np.issubdtype(a.dtype, np.floating) \
                    and not np.isfinite(a).all():
                self._record_breach("non_finite", name)
                return "breach", None
        div = _divergence(outputs, mirror_out)
        with self._lock:
            self.max_divergence = max(self.max_divergence, div)
        if div > self.divergence_bound:
            self._record_breach("divergence",
                                "%.3e > %.3e" % (div,
                                                 self.divergence_bound))
            return "breach", None
        if (self.latency_ratio is not None
                and mirror_latency_s is not None
                and cfut.latency_s is not None
                and cfut.latency_s > self.latency_ratio * mirror_latency_s
                + self.latency_margin_s):
            self._record_breach(
                "latency", "%.3fs vs mirror %.3fs"
                % (cfut.latency_s, mirror_latency_s))
            return "breach", None
        self._record_ok()
        if not want_value:
            return "ok", None
        return "ok", PoolResult(outputs, cfut.bucket)

    def _record_ok(self):
        finalize = False
        with self._lock:
            if self._state not in _ROUTING:
                return
            self.sampled += 1
            self.oks += 1
            if (self.auto_finalize and self.oks >= self.min_requests
                    and self.breaches < self.max_breaches):
                self._state = PROMOTING
                finalize = True
        if finalize:
            self.pool._event("canary_promote", "canary",
                             "%d/%d ok, max divergence %.3e"
                             % (self.oks, self.sampled,
                                self.max_divergence))
            threading.Thread(target=self._do_finalize, daemon=True,
                             name="ptpu-canary-promote").start()

    def _record_breach(self, kind, detail):
        rollback = False
        with self._lock:
            if self._state not in _ROUTING:
                return
            self.sampled += 1
            self.breaches += 1
            self.breach_kinds[kind] = self.breach_kinds.get(kind, 0) + 1
            if self.breaches >= self.max_breaches:
                self._state = ROLLED_BACK
                self.reason = "%s: %s" % (kind, detail)
                rollback = True
        self.pool._event("canary_breach", "canary",
                         "%s: %s" % (kind, detail))
        if rollback:
            self.pool._event("canary_rollback", "canary", self.reason)
            from ..observability import trace as _otrace
            _otrace.instant("pool/canary_rollback", cat="serving")
            self._close_engine(drain=False)

    # --------------------------------------------------------- lifecycle --
    def finalize(self):
        """Manually promote (auto_finalize=False flows). Raises unless
        the canary has earned it (enough oks, breaches under budget)."""
        with self._lock:
            if self._state not in _ROUTING:
                raise RuntimeError("promotion is %s" % self._state)
            if self.oks < self.min_requests \
                    or self.breaches >= self.max_breaches:
                raise RuntimeError(
                    "canary has not earned promotion: %d/%d oks, "
                    "%d breaches" % (self.oks, self.min_requests,
                                     self.breaches))
            self._state = PROMOTING
        self._do_finalize()
        return self.promoted_step

    def _do_finalize(self):
        """The ordinary zero-downtime reload onto the candidate source —
        every replica flips to a warmed engine, nothing dropped — then
        the canary engine retires gracefully."""
        try:
            step = self.pool.reload(**self._source)
        except Exception as e:  # noqa: BLE001 — a failed final reload
            # leaves the incumbent fleet serving; the candidate is NOT
            # promoted
            with self._lock:
                self._state = ROLLED_BACK
                self.reason = "final reload failed: %r" % (e,)
            self.pool._event("canary_rollback", "canary", self.reason)
            self._close_engine(drain=False)
            return
        with self._lock:
            self._state = PROMOTED
            self.promoted_step = step
        self.pool._event("promoted", "canary",
                         "step %r at 100%%" % (step,))
        from ..observability import trace as _otrace
        _otrace.instant("pool/promoted", cat="serving")
        self._close_engine(drain=True)

    def cancel(self, reason="cancelled"):
        with self._lock:
            if self._state not in _ROUTING:
                return
            self._state = CANCELLED
            self.reason = reason
        self.pool._event("canary_cancel", "canary", reason)
        self._close_engine(drain=False)

    def _close_engine(self, drain):
        """Always off-thread: judge() runs on client threads and (shadow
        mode) on the canary's own batcher worker — engine.close joins
        that very worker."""
        eng = self.engine
        threading.Thread(
            target=lambda: eng.close(drain=drain, timeout=5.0),
            daemon=True, name="ptpu-canary-close").start()

    def state(self):
        with self._lock:
            return {
                "state": self._state,
                "mode": self.mode,
                "traffic_fraction": self.traffic_fraction,
                "sampled": self.sampled,
                "oks": self.oks,
                "breaches": self.breaches,
                "breach_kinds": dict(self.breach_kinds),
                "min_requests": self.min_requests,
                "max_breaches": self.max_breaches,
                "divergence_bound": self.divergence_bound,
                "max_divergence": round(self.max_divergence, 6),
                "reason": self.reason,
                "promoted_step": self.promoted_step,
            }
