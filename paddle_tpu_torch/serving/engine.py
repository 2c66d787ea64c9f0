"""InferenceEngine: a loaded model + private Scope + bucketed dispatch.

Parity: the JAX package's serving/engine.py `InferenceEngine` — the
native-format load (a `save_inference_model` directory written by either
package), the feed contract, the per-fetch row policy, the batch-bucket
lattice, coalescing through the Batcher, and `run_direct`. Every dispatch
runs at a batch size from a small configured lattice of buckets, so a
request's rows come back the same whether it was dispatched alone
(`run_direct` at the same bucket) or coalesced with strangers: at one
shape, each row's result depends only on that row (on the card, cuBLAS
picks its algorithm by shape, which is why the comparison holds only at
the same bucket).

Waiting for later slices: sequence (LoD) feeds and seq buckets, the
decode engine, tensor parallelism, quantized weights, tuned configs, the
analysis/deployment tier, tracing, the era-wire model format and
pipelined dispatch.
"""
import os
import threading
import time

import numpy as np

from .. import io as _io
from ..core.executor import Executor, Scope, resolve_device
from ..core.framework import Parameter, convert_dtype, find_var
from .batcher import Batcher, ServingError
from .metrics import ServingMetrics

__all__ = ["InferenceEngine", "ResultSlice", "InvalidRequestError"]

SEQLEN_SUFFIX = "@SEQLEN"


class InvalidRequestError(ServingError):
    """The request's feeds don't match the model contract (missing feed,
    wrong feature dims, ...)."""


def _default_batch_buckets(max_batch_size):
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


def _covering_bucket(buckets, n, what):
    for b in buckets:
        if b >= n:
            return b
    raise InvalidRequestError(
        "%s %d exceeds the largest configured bucket %d"
        % (what, n, buckets[-1]))


class ResultSlice(object):
    """One request's share of a dispatched batch: the batch's fetch
    tensors (still on the device, possibly still being computed) plus
    this request's row range. `numpy()` copies THESE rows to the host.
    Per-fetch row policy: "rows" (declared leading dim -1: always slice),
    "whole" (parameters/persistables/scalars: never per-row), "dynamic"
    (concrete non-param leading dim: sliced when it equals the bucket —
    returning the full batch would hand one client strangers' rows)."""

    __slots__ = ("_fetch_names", "_handles", "_row_policy", "_lo", "_hi",
                 "_bucket_rows", "bucket")

    def __init__(self, fetch_names, handles, row_policy, lo, hi,
                 bucket_rows, bucket):
        self._fetch_names = fetch_names
        self._handles = handles
        self._row_policy = row_policy
        self._lo = lo
        self._hi = hi
        self._bucket_rows = bucket_rows
        self.bucket = bucket  # (batch_bucket, seq_bucket | None)

    def numpy(self):
        out = {}
        for name, h in zip(self._fetch_names, self._handles):
            policy = self._row_policy[name]
            slice_rows = policy == "rows" or (
                policy == "dynamic" and h.dim()
                and h.shape[0] == self._bucket_rows)
            t = h[self._lo:self._hi] if slice_rows else h
            out[name] = t.detach().cpu().numpy()
        return out

    def __repr__(self):
        return "ResultSlice(rows=[%d:%d), bucket=%r)" % (
            self._lo, self._hi, self.bucket)


class _NormalizedRequest(object):
    """A request's feeds, validated and dtype-cast ([rows, *feat]).
    `shape_sig` captures every concrete feature shape: requests only
    coalesce within a signature."""

    __slots__ = ("rows", "dense", "max_seq_len", "shape_sig")

    def __init__(self, rows, dense):
        self.rows = rows
        self.dense = dense          # name -> np.ndarray [rows, *feat]
        self.max_seq_len = 0
        self.shape_sig = tuple(sorted((n, a.shape[1:])
                                      for n, a in dense.items()))


class InferenceEngine(object):
    """Serve a `save_inference_model` directory on one device.

    device: "cuda" (the default) or "cpu"; with no card and no explicit
    "cpu", construction raises before anything is read.
    batch_buckets / max_batch_size: the batch lattice (default powers of
    two up to max_batch_size=32). pipeline_depth must be 0 (the serial
    batcher) in this slice."""

    def __init__(self, model_dir, device=None, name=None,
                 model_filename=None, batch_buckets=None,
                 max_batch_size=None, max_queue_delay_ms=5.0,
                 queue_capacity=256, default_deadline_ms=None, warmup=True,
                 latency_window=2048, pipeline_depth=0):
        self.device = resolve_device(device)
        self.name = name or os.path.basename(os.path.normpath(model_dir))
        self._scope = Scope()
        self._exe = Executor(self.device)
        self._run_lock = threading.Lock()
        self.default_deadline_ms = default_deadline_ms
        self.closed = False

        program, feed_names, fetch_vars = _io.load_inference_model(
            model_dir, self._exe, model_filename=model_filename,
            scope=self._scope)
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [v.name for v in fetch_vars]

        # feed contract: per-feed declared feature dims
        self._feed_vars = {}
        for n in self.feed_names:
            var = find_var(self.program, n)
            if var is None:
                raise ValueError(
                    "model metadata names feed %r but the program has no "
                    "such variable" % n)
            if var.lod_level > 0 or find_var(
                    self.program, n + SEQLEN_SUFFIX) is not None:
                raise NotImplementedError(
                    "feed %r is a sequence (LoD) input: sequence feeds and "
                    "seq buckets come with the sequence slice of the port"
                    % n)
            self._feed_vars[n] = var

        # per-fetch row policy, decided once (see ResultSlice)
        self._fetch_row_policy = {}
        for n in self.fetch_names:
            var = find_var(self.program, n)
            shape = list(var.shape or []) if var is not None else []
            if var is not None and (isinstance(var, Parameter)
                                    or var.persistable or not shape):
                self._fetch_row_policy[n] = "whole"
            elif shape and shape[0] == -1:
                self._fetch_row_policy[n] = "rows"
            else:
                self._fetch_row_policy[n] = "dynamic"

        if batch_buckets:
            self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
            self.max_batch_size = (int(max_batch_size) if max_batch_size
                                   else self.batch_buckets[-1])
        else:
            self.max_batch_size = int(max_batch_size or 32)
            self.batch_buckets = _default_batch_buckets(self.max_batch_size)
        if self.max_batch_size > self.batch_buckets[-1]:
            raise ValueError(
                "max_batch_size %d exceeds the largest batch bucket %d"
                % (self.max_batch_size, self.batch_buckets[-1]))
        self.seq_buckets = []

        self.metrics = ServingMetrics(latency_window=latency_window)
        self._batcher = Batcher(
            self._dispatch, max_batch_size=self.max_batch_size,
            max_queue_delay_ms=max_queue_delay_ms,
            queue_capacity=queue_capacity, metrics=self.metrics,
            name=self.name, pipeline_depth=pipeline_depth)
        self.pipeline_depth = self._batcher.pipeline_depth
        if warmup:
            try:
                self.warmup()
            except Exception:
                # the batcher worker is running: a constructor that raises
                # must not leak a live thread per retry
                self.close(drain=False)
                raise

    # ------------------------------------------------------- normalize --
    def normalize_feed(self, feed):
        """Validate one request's feed dict against the model contract:
        array-likes [rows, *feat], feature dims checked against the
        declared dims where those are concrete, cast to declared dtypes."""
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise InvalidRequestError("request is missing feeds %r (model "
                                      "expects %r)" % (missing,
                                                       self.feed_names))
        extra = [n for n in feed if n not in self.feed_names]
        if extra:
            raise InvalidRequestError("request has unknown feeds %r (model "
                                      "expects %r)" % (extra,
                                                       self.feed_names))
        rows = None
        dense = {}
        for n in self.feed_names:
            var = self._feed_vars[n]
            arr = np.asarray(feed[n])
            if var.dtype is not None:
                arr = arr.astype(convert_dtype(var.dtype), copy=False)
            if arr.ndim < 1:
                raise InvalidRequestError(
                    "feed %r must carry a leading batch-rows dim, got a "
                    "scalar" % n)
            want = list(var.shape or [])[1:]
            got = list(arr.shape)[1:]
            if len(got) != len(want) or any(
                    w >= 0 and w != g for w, g in zip(want, got)):
                raise InvalidRequestError(
                    "feed %r has per-row shape %r but the model declares %r"
                    % (n, got, want))
            dense[n] = arr
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise InvalidRequestError(
                    "feeds disagree on batch rows: %r carries %d, earlier "
                    "feeds carry %d" % (n, arr.shape[0], rows))
        if not rows:
            raise InvalidRequestError("request carries zero rows")
        return _NormalizedRequest(rows, dense)

    # --------------------------------------------------------- padding --
    def _pad_batch(self, normalized, batch_bucket):
        """Coalesce normalized requests into one bucket-shaped feed dict
        (pad rows are zeros). Shared by the batcher dispatch AND
        `run_direct`, so the reference path pads byte-identically."""
        feed = {}
        for n in self.feed_names:
            arr = np.concatenate([req.dense[n] for req in normalized],
                                 axis=0)
            pad_rows = batch_bucket - arr.shape[0]
            if pad_rows:
                arr = np.concatenate(
                    [arr, np.zeros((pad_rows,) + arr.shape[1:],
                                   dtype=arr.dtype)], axis=0)
            feed[n] = arr
        return feed

    # -------------------------------------------------------- dispatch --
    def _run(self, feed):
        """One executor run under the run lock; returns the fetch tensors
        (left on the device: no host sync here)."""
        with self._run_lock:
            return self._exe.run(self.program, feed=feed,
                                 fetch_list=self.fetch_names,
                                 scope=self._scope, return_numpy=False)

    def _dispatch(self, requests):
        """Batcher callback. Requests group by concrete-shape signature;
        each group pads into one bucket dispatch, and a group that fails
        fails only ITS requests."""
        groups = {}
        for req in requests:
            groups.setdefault(req.feed.shape_sig, []).append(req)
        for reqs in groups.values():
            try:
                self._dispatch_group(reqs)
            except Exception as e:  # noqa: BLE001 — isolate the group
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                self.metrics.on_error(len(reqs))

    def _dispatch_group(self, requests):
        """Pad one shape-compatible group -> one run -> scatter."""
        normalized = [req.feed for req in requests]
        rows = sum(r.rows for r in normalized)
        batch_bucket = _covering_bucket(self.batch_buckets, rows,
                                        "batch rows")
        handles = self._run(self._pad_batch(normalized, batch_bucket))
        now = time.monotonic()
        offset, latencies = 0, []
        for req, norm in zip(requests, normalized):
            req.future.bucket = (batch_bucket, None)
            req.future.latency_s = now - req.enqueued_at
            latencies.append(req.future.latency_s)
            req.future.set_result(ResultSlice(
                self.fetch_names, handles, self._fetch_row_policy,
                offset, offset + norm.rows, batch_bucket,
                (batch_bucket, None)))
            offset += norm.rows
        self.metrics.on_batch(len(requests), rows, batch_bucket, latencies)

    # ---------------------------------------------------------- public --
    def submit(self, feed, deadline_ms=None):
        """Enqueue one request for coalesced dispatch; returns a
        RequestFuture whose result is a ResultSlice. A malformed request
        fails here, on the caller's thread."""
        norm = self.normalize_feed(feed)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        return self._batcher.submit(norm, norm.rows, deadline_ms=deadline_ms)

    def infer(self, feed, deadline_ms=None, timeout=30.0):
        """Synchronous convenience: submit + wait + copy this request's
        rows. Returns {fetch_name: np.ndarray}."""
        return self.submit(feed, deadline_ms=deadline_ms) \
            .result(timeout).numpy()

    def run_direct(self, feed, batch_bucket=None):
        """ONE request, padded by the same `_pad_batch` helper and run
        directly — no queue, no coalescing. At a given bucket it gives the
        rows the same request gets back from a coalesced batch. Returns
        ({fetch_name: np.ndarray}, (batch_bucket, None))."""
        norm = self.normalize_feed(feed)
        batch_bucket = batch_bucket or _covering_bucket(
            self.batch_buckets, norm.rows, "batch rows")
        if batch_bucket < norm.rows:
            raise InvalidRequestError(
                "batch_bucket=%d cannot hold the request's %d rows"
                % (batch_bucket, norm.rows))
        handles = self._run(self._pad_batch([norm], batch_bucket))
        res = ResultSlice(self.fetch_names, handles, self._fetch_row_policy,
                          0, norm.rows, batch_bucket, (batch_bucket, None))
        return res.numpy(), (batch_bucket, None)

    def warmup(self):
        """Run every batch bucket once on zero feeds (builds the kernels
        and the libraries' per-shape state before the first request).
        Feature dims declared -1 warm up at 1."""
        for batch_bucket in self.batch_buckets:
            feed = {}
            for n in self.feed_names:
                var = self._feed_vars[n]
                dtype = convert_dtype(var.dtype) if var.dtype else "float32"
                feat = [d if d >= 0 else 1 for d in list(var.shape or [])[1:]]
                feed[n] = np.zeros([batch_bucket] + feat, dtype=dtype)
            self._run(feed)
        return len(self.batch_buckets)

    def queue_depth(self):
        return self._batcher.queue_depth()

    def drain(self, timeout=None):
        return self._batcher.drain(timeout)

    def close(self, drain=True, timeout=None):
        """Graceful shutdown: stop intake, drain queued requests, join the
        worker."""
        self.closed = True
        self._batcher.close(drain=drain, timeout=timeout)
