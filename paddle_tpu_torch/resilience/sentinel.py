"""Training-health sentinel: streaming statistics over step metrics.

Parity: the JAX package's resilience/sentinel.py (the same statistics,
thresholds, decisions and state dicts); host code only.

The guards (resilience/guards.py) catch values that are *broken* —
NaN/Inf in-graph, gated updates. This module catches values that are *wrong*: finite
losses that spike off the recent distribution (one bad batch), gradient
norms that blow up, and the slow upward drift of divergence. All three
are host-side statistics over values the executor ALREADY fetched —
the loss scalar every training loop pulls, plus the global grad-norm
scalar riding the guard stat channel (`ops/guard_ops.py GRAD_NORM_STAT`
via `install_numeric_guards(grad_norm=True)` → `Executor.last_stats`)
— so the sentinel costs zero additional host syncs per step.

Statistics: a robust z-score over a sliding median/MAD window,

    z = (x - median) / (1.4826 * MAD + eps)

(1.4826 scales the median absolute deviation to the stddev of a normal
distribution). Median/MAD instead of mean/stddev because the statistic
must survive exactly the events it detects: one huge loss drags a mean
and inflates a stddev enough to mask the next ten spikes, but moves a
median by at most one rank. Spiked samples are additionally NEVER
folded into the window, so the baseline stays clean even while a chain
of bad batches is being skipped.

Detections map to typed errors the Supervisor classifies into its new
fault classes (the escalation matrix, ARCHITECTURE.md §29):

    LossSpikeError    loss z-score past `z_threshold` (two-sided), a
                      non-finite loss at the host, or the grad norm
                      past `grad_z_threshold` (one-sided — only blowups
                      are faults). class "loss_spike" → default chain
                      rollback_skip_data: restore the newest snapshot
                      AND advance every reader stream past the
                      offending batch window (the PaLM remedy).
    DivergenceError   the window median exceeding `divergence_factor` x
                      the best median seen, for `divergence_patience`
                      consecutive steps — drift, not a one-off. class
                      "divergence" → rollback (damp LR), then abort.

`observe()` RETURNS the error instance instead of raising so the
Supervisor stays the one place that decides; a bare training loop can
use the sentinel standalone and raise (or log) as it pleases.
"""
import bisect
import collections
import math

import numpy as np

__all__ = ["LossSpikeError", "DivergenceError", "RobustWindow",
           "TrainingSentinel"]


class LossSpikeError(RuntimeError):
    """A step metric (loss, or the global grad norm) spiked off its
    robust window — finite but statistically impossible under the
    recent distribution, the signature of a bad batch. The offending
    step's updates DID apply (the spike is only visible after the
    fetch), so the sane remedy is rollback_skip_data."""

    def __init__(self, message, step=None, metric="loss", value=None,
                 zscore=None):
        super(LossSpikeError, self).__init__(message)
        self.step = step
        self.metric = metric
        self.value = value
        self.zscore = zscore


class DivergenceError(RuntimeError):
    """Sustained upward drift of the loss window median past the best
    median seen — training is walking away from convergence (bad LR,
    poisoned state), not hitting one bad batch."""

    def __init__(self, message, step=None, value=None, best=None):
        super(DivergenceError, self).__init__(message)
        self.step = step
        self.value = value
        self.best = best


class RobustWindow(object):
    """Sliding median/MAD window with robust z-scores.

    `zscore(x)` is None during warmup (fewer than `warmup` samples —
    a median over three points is noise, not a baseline); `push(x)`
    folds a sample in. Callers score BEFORE pushing and skip the push
    for detected outliers, keeping the baseline uncontaminated.

    The window runs once per training step on the dispatch path, so it
    keeps a SORTED copy of the values alongside the eviction deque:
    push is one bisect insort (+ one delete on eviction), median is an
    index, and MAD is a two-pointer merge outward from the median over
    the sorted array — the absolute deviations of the left half
    (descending indices) and right half (ascending) are each already in
    increasing order, so the k-th smallest deviation falls out of an
    O(window) pure-Python walk with no sort and no numpy round-trips
    (an np.median formulation pays five numpy calls over tiny arrays
    per observe)."""

    def __init__(self, window=64, warmup=16, eps=1e-9):
        self.window = max(2, int(window))
        self.warmup = max(2, int(warmup))
        self.eps = float(eps)
        self.values = collections.deque(maxlen=self.window)
        self._sorted = []

    def __len__(self):
        return len(self.values)

    @property
    def ready(self):
        return len(self.values) >= self.warmup

    def median(self):
        s = self._sorted
        n = len(s)
        if not n:
            return None
        mid = n >> 1
        return s[mid] if n & 1 else 0.5 * (s[mid - 1] + s[mid])

    def _mad(self, med):
        """Median absolute deviation from `med`, selected by merging
        the two deviation streams the sorted array already provides."""
        s = self._sorted
        n = len(s)
        i = bisect.bisect_right(s, med) - 1  # rightmost value <= med
        j = i + 1
        k2 = n >> 1  # 0-based ranks of the deviation median
        k1 = (n - 1) >> 1
        prev = cur = 0.0
        taken = 0
        while taken <= k2:
            left = med - s[i] if i >= 0 else math.inf
            right = s[j] - med if j < n else math.inf
            if left <= right:
                cur, i = left, i - 1
            else:
                cur, j = right, j + 1
            if taken == k1:
                prev = cur
            taken += 1
        return cur if k1 == k2 else 0.5 * (prev + cur)

    def zscore(self, x):
        if not self.ready:
            return None
        med = self.median()
        mad = self._mad(med)
        return (float(x) - med) / (1.4826 * mad + self.eps)

    def push(self, x):
        x = float(x)
        if len(self.values) == self.window:
            old = self.values[0]
            del self._sorted[bisect.bisect_left(self._sorted, old)]
        self.values.append(x)
        bisect.insort(self._sorted, x)

    def state_dict(self):
        return {"values": list(self.values)}

    def load_state_dict(self, state):
        self.values.clear()
        self.values.extend(float(v) for v in state.get("values", ()))
        self._sorted = sorted(self.values)

    def reset(self):
        self.values.clear()
        del self._sorted[:]


class TrainingSentinel(object):
    """The streaming monitor a Supervisor feeds once per healthy step.

    observe(loss, grad_norm=None, step=None) -> None | LossSpikeError |
    DivergenceError. State is tiny and JSON-able
    (state_dict/load_state_dict) so a supervisor can snapshot it beside
    a checkpoint; `status()` is the heartbeat payload (last z-scores,
    spike count) that lets `python -m paddle_tpu_torch.tools.ptpu_elastic
    status` show WHY a worker fenced."""

    def __init__(self, window=64, warmup=16, z_threshold=8.0,
                 grad_z_threshold=None, divergence_factor=3.0,
                 divergence_patience=32, eps=1e-9):
        self.z_threshold = float(z_threshold)
        self.grad_z_threshold = float(
            z_threshold if grad_z_threshold is None else grad_z_threshold)
        self.divergence_factor = float(divergence_factor)
        self.divergence_patience = max(1, int(divergence_patience))
        self.eps = float(eps)
        self.loss_win = RobustWindow(window=window, warmup=warmup, eps=eps)
        self.grad_win = RobustWindow(window=window, warmup=warmup, eps=eps)
        self.last_z = None
        self.last_grad_z = None
        self.spikes = 0
        self.samples = 0
        self._best_median = None
        self._trend = 0

    # ------------------------------------------------------- detection --
    def observe(self, loss, grad_norm=None, step=None):
        v = float(loss)
        if not math.isfinite(v):
            # guards normally gate this on device; a host-visible
            # non-finite loss (guards off, or loss outside the watched
            # set) is a spike with infinite z
            self.spikes += 1
            self.last_z = float("inf")
            return LossSpikeError(
                "training sentinel: non-finite loss %r reached the host "
                "at step %s" % (v, step), step=step, value=v,
                zscore=self.last_z)
        z = self.loss_win.zscore(v)
        self.last_z = z
        if z is not None and abs(z) > self.z_threshold:
            self.spikes += 1
            return LossSpikeError(
                "training sentinel: loss %.6g at step %s has robust "
                "z-score %.1f (|z| > %.1f over a %d-sample median/MAD "
                "window) — bad batch suspected" % (
                    v, step, z, self.z_threshold, len(self.loss_win)),
                step=step, value=v, zscore=z)
        if grad_norm is not None:
            g = float(grad_norm)
            if not math.isfinite(g):
                self.spikes += 1
                self.last_grad_z = float("inf")
                return LossSpikeError(
                    "training sentinel: non-finite global grad norm %r "
                    "at step %s" % (g, step), step=step,
                    metric="grad_norm", value=g, zscore=self.last_grad_z)
            gz = self.grad_win.zscore(g)
            self.last_grad_z = gz
            # one-sided: a COLLAPSING grad norm is convergence, not a
            # fault; only blowups spike
            if gz is not None and gz > self.grad_z_threshold:
                self.spikes += 1
                return LossSpikeError(
                    "training sentinel: global grad norm %.6g at step "
                    "%s has robust z-score %.1f (> %.1f) — gradient "
                    "blowup suspected" % (g, step, gz,
                                          self.grad_z_threshold),
                    step=step, metric="grad_norm", value=g, zscore=gz)
            self.grad_win.push(g)
        self.loss_win.push(v)
        self.samples += 1
        # divergence: the window median walking up and STAYING up. The
        # sample already passed the spike check, so this triggers only
        # on drift the z-score is blind to (each step near its
        # neighbors, the whole window far from the best).
        med = self.loss_win.median()
        if med is not None and self.loss_win.ready:
            if self._best_median is None or med < self._best_median:
                self._best_median = med
                self._trend = 0
            elif med > self.divergence_factor * (
                    abs(self._best_median) + self.eps):
                self._trend += 1
                if self._trend >= self.divergence_patience:
                    return DivergenceError(
                        "training sentinel: loss window median %.6g has "
                        "exceeded %.3gx the best median %.6g for %d "
                        "consecutive steps — divergence" % (
                            med, self.divergence_factor,
                            self._best_median, self._trend),
                        step=step, value=med, best=self._best_median)
            else:
                self._trend = 0
        return None

    # ----------------------------------------------------------- state --
    def status(self):
        """Heartbeat/metrics payload: plain JSON-able floats."""
        def _f(x):
            return None if x is None or not np.isfinite(x) else float(x)
        return {"z": _f(self.last_z), "grad_z": _f(self.last_grad_z),
                "spikes": int(self.spikes), "samples": int(self.samples)}

    def state_dict(self):
        return {"loss_win": self.loss_win.state_dict(),
                "grad_win": self.grad_win.state_dict(),
                "spikes": self.spikes, "samples": self.samples,
                "best_median": self._best_median, "trend": self._trend}

    def load_state_dict(self, state):
        self.loss_win.load_state_dict(state.get("loss_win", {}))
        self.grad_win.load_state_dict(state.get("grad_win", {}))
        self.spikes = int(state.get("spikes", 0))
        self.samples = int(state.get("samples", 0))
        self._best_median = state.get("best_median")
        self._trend = int(state.get("trend", 0))

    def reset(self):
        """Full reset — the Supervisor calls this after a rollback: the
        restored state replays an earlier stream, so the window's
        samples (drawn from steps past the restore point) are from a
        future that will now unfold differently."""
        self.loss_win.reset()
        self.grad_win.reset()
        self.last_z = self.last_grad_z = None
        self._best_median = None
        self._trend = 0
