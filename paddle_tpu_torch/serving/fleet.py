"""ModelFleet: N models behind one serving surface, with priority
brownout and weighted capacity shares.

Parity: the JAX package's serving/fleet.py (`BrownoutError`,
`_FleetModel`, `ModelFleet`), the same host logic over the port's pools.

One deployment rarely serves one model: the era's answer was one
`listen_and_serv` process per model, each sized by hand, each melting
down independently. A `ModelFleet` owns a {name: ReplicaPool} registry
— per-model replica sets, so every pool keeps its own health machine,
failover, admission, autoscaling and canary promotion — plus the one
thing no single pool can decide: WHO gets shed when the fleet as a
whole is overloaded.

  * **priority brownout** — every model carries an integer `priority`
    (higher = more important). The fleet tracks aggregate pressure
    (in-flight vs the pools' AIMD admission limits, and queue
    occupancy); when it stays above `pressure_high` the brownout level
    rises one priority TIER at a time (dwell-limited, no flapping):
    the lowest tier's requests start getting fast 429s (with a
    Retry-After hint) while higher tiers keep serving. When pressure
    falls below `pressure_low` the level steps back down. The top tier
    is never shed — brownout degrades the fleet, it never turns it off.
  * **weighted shares** — `weight` is a model's share of the fleet's
    aggregate in-flight budget. Under pressure (above `pressure_high`),
    a model running past `weight/total_weight` of the aggregate limit
    is shed even inside a surviving tier — one greedy model cannot
    starve its peers.
  * **per-model /metrics** — the fleet's `registry()` plugs straight
    into `ModelServer`: every serving/pool family is labeled
    {model, replica} per pool exactly as before, and `/healthz` carries
    every pool's state plus the fleet's brownout level.

Brownout decisions are recomputed at submit time from live counters
(deterministic, no controller thread to race tests against) with a
`shed_dwell_s` hysteresis.
"""
import threading
import time

from .batcher import QueueFullError, ServingClosedError
from .pool import ReplicaPool

__all__ = ["ModelFleet", "BrownoutError"]


class BrownoutError(QueueFullError):
    """Fleet-level shed: the request's model is browned out (fleet
    overloaded and this model's priority tier — or weighted share — is
    the one being sacrificed). Maps to 429 + Retry-After like every
    other backpressure signal."""


class _FleetModel(object):
    """The engine-shaped registry entry `ModelServer` talks to: submits
    route through the fleet (brownout), everything else delegates to
    the model's own pool."""

    def __init__(self, fleet, name, pool, priority, weight):
        self._fleet = fleet
        self._pool = pool
        self.name = name
        self.priority = int(priority)
        self.weight = float(weight)
        self.shed_total = 0

    def submit(self, feed, deadline_ms=None):
        return self._fleet.submit(self.name, feed,
                                  deadline_ms=deadline_ms)

    def infer(self, feed, deadline_ms=None, timeout=30.0):
        return self.submit(feed, deadline_ms=deadline_ms) \
            .result(timeout).numpy()

    def describe(self):
        d = self._pool.describe()
        d["priority"] = self.priority
        d["weight"] = self.weight
        d["browned_out"] = self._fleet.is_browned_out(self.name)
        d["shed_total"] = self.shed_total
        return d

    def __getattr__(self, attr):
        # pool_state / replica_metrics / metrics / run_direct /
        # closed / ... — the pool surface, unchanged
        return getattr(self._pool, attr)

    def close(self, drain=True, timeout=None):
        self._pool.close(drain=drain, timeout=timeout)


class ModelFleet(object):
    def __init__(self, brownout=True, pressure_high=0.85,
                 pressure_low=0.5, shed_dwell_s=1.0, name="fleet"):
        self.name = name
        self.brownout = bool(brownout)
        self.pressure_high = float(pressure_high)
        self.pressure_low = float(pressure_low)
        self.shed_dwell_s = float(shed_dwell_s)
        self.closed = False
        self._models = {}            # name -> _FleetModel
        self._lock = threading.Lock()
        self._level = 0              # priority tiers currently shed
        self._level_changed_at = 0.0

    # ---------------------------------------------------------- registry --
    def add_model(self, name, pool=None, priority=0, weight=1.0,
                  **pool_kw):
        """Register a model: hand in a built ReplicaPool (or any
        engine-shaped object) via `pool=`, or pass ReplicaPool kwargs
        (model_dir=..., replicas=..., autoscale=..., ...) and the fleet
        builds one. Returns the pool."""
        if weight <= 0:
            raise ValueError("weight must be > 0, got %r" % (weight,))
        with self._lock:
            if name in self._models:
                raise ValueError("model %r already registered" % name)
        if pool is None:
            pool = ReplicaPool(name=name, **pool_kw)
        entry = _FleetModel(self, name, pool, priority, weight)
        with self._lock:
            self._models[name] = entry
        return pool

    def remove_model(self, name, drain=True, timeout=None):
        with self._lock:
            entry = self._models.pop(name)
        entry._pool.close(drain=drain, timeout=timeout)

    def pool(self, name):
        return self._models[name]._pool

    def models(self):
        return sorted(self._models)

    def registry(self):
        """{name: engine-shaped entry} for ModelServer — fleet-routed
        submits, per-model pool metrics."""
        return dict(self._models)

    # ---------------------------------------------------------- pressure --
    def _pressure(self):
        """Fleet pressure in [0, inf): the MAX over pools of per-pool
        occupancy (in-flight vs the AIMD admission limit, queued vs
        queue capacity). Max, not aggregate — one saturated model means
        the fleet is already failing someone, and an idle peer's spare
        queue slots don't serve the saturated model's clients; shedding
        low-priority work is how the shared hardware gets back to the
        high-priority tier."""
        p = 0.0
        for entry in list(self._models.values()):
            pool = entry._pool
            adm = getattr(pool, "_admission", None)
            if adm is not None and adm.limit > 0:
                p = max(p, pool.total_inflight() / adm.limit)
            qcap = (pool.queue_capacity_total()
                    if hasattr(pool, "queue_capacity_total") else 0)
            if qcap:
                p = max(p, pool.queue_depth() / qcap)
        return p

    def _tiers(self):
        """Distinct priorities, lowest first."""
        return sorted({e.priority for e in self._models.values()})

    def _update_level(self, pressure, now):
        """Dwell-limited level machine: one tier up per dwell while hot,
        one tier down per dwell while cool; the top tier is never
        shed."""
        with self._lock:
            max_level = max(len(self._tiers()) - 1, 0)
            if now - self._level_changed_at < self.shed_dwell_s:
                return self._level
            if pressure >= self.pressure_high and self._level < max_level:
                self._level += 1
                self._level_changed_at = now
            elif pressure <= self.pressure_low and self._level > 0:
                self._level -= 1
                self._level_changed_at = now
            return min(self._level, max_level)

    def brownout_level(self):
        return self._level

    def is_browned_out(self, name):
        entry = self._models[name]
        tiers = self._tiers()
        return self._level > 0 and entry.priority in tiers[:self._level]

    # ------------------------------------------------------------ submit --
    def submit(self, name, feed, deadline_ms=None):
        if self.closed:
            raise ServingClosedError("model fleet is shut down")
        entry = self._models.get(name)
        if entry is None:
            raise KeyError("no model %r in the fleet (have %r)"
                           % (name, self.models()))
        if self.brownout:
            now = time.monotonic()
            pressure = self._pressure()
            level = self._update_level(pressure, now)
            shed_reason = None
            if level > 0:
                tiers = self._tiers()
                if entry.priority in tiers[:level]:
                    shed_reason = ("model %r (priority %d) browned out "
                                   "at fleet pressure %.2f"
                                   % (name, entry.priority, pressure))
            if shed_reason is None and pressure >= self.pressure_high:
                # weighted-share enforcement inside surviving tiers: a
                # model past its share of the aggregate budget sheds
                # first even at its own priority
                total_w = sum(e.weight
                              for e in self._models.values()) or 1.0
                total_limit = sum(
                    e._pool._admission.limit
                    for e in self._models.values()
                    if getattr(e._pool, "_admission", None) is not None)
                if total_limit > 0:
                    share = entry.weight / total_w * total_limit
                    if entry._pool.total_inflight() > share:
                        shed_reason = (
                            "model %r over its weighted share "
                            "(%.0f in flight > %.1f) at fleet "
                            "pressure %.2f"
                            % (name, entry._pool.total_inflight(),
                               share, pressure))
            if shed_reason is not None:
                entry.shed_total += 1
                exc = BrownoutError(shed_reason + "; retry with backoff")
                adm = getattr(entry._pool, "_admission", None)
                exc.retry_after_s = (adm.retry_after_s()
                                     if adm is not None else 1.0)
                raise exc
        return entry._pool.submit(feed, deadline_ms=deadline_ms)

    def infer(self, name, feed, deadline_ms=None, timeout=30.0):
        return self.submit(name, feed, deadline_ms=deadline_ms) \
            .result(timeout).numpy()

    # ------------------------------------------------------------- state --
    def fleet_state(self):
        out = {"models": {}, "brownout_level": self._level,
               "pressure": round(self._pressure(), 4),
               "tiers": self._tiers()}
        for name, entry in sorted(self._models.items()):
            out["models"][name] = {
                "priority": entry.priority,
                "weight": entry.weight,
                "browned_out": self.is_browned_out(name),
                "shed_total": entry.shed_total,
                "pool": (entry._pool.pool_state()
                         if hasattr(entry._pool, "pool_state") else None),
            }
        return out

    def close(self, drain=True, timeout=None):
        self.closed = True
        for entry in list(self._models.values()):
            entry._pool.close(drain=drain, timeout=timeout)
