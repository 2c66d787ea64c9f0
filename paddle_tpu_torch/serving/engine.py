"""InferenceEngine: a loaded model + private Scope + bucketed dispatch.

Parity: the JAX package's serving/engine.py `InferenceEngine` — the
native-format load (a `save_inference_model` directory written by either
package), the feed contract for dense and sequence (LoD) feeds, the
per-fetch row policy, the (batch, seq) bucket lattice, coalescing through
the Batcher, and `run_direct`. Every dispatch runs at a batch size, and
for a sequence model at a padded length, from a small configured lattice
of buckets, so a request's rows come back the same whether it was
dispatched alone (`run_direct` at the same buckets) or coalesced with
strangers: at one shape, each row's result depends only on that row (on
the card, cuBLAS picks its algorithm by shape, which is why the comparison
holds only at the same bucket).

Dispatch is pipelined by default (the Batcher's continuous batching at
`pipeline_depth` 2): a dispatch enqueues its run on the device and
returns the batch's fetch tensors without a host sync; a client's
`ResultSlice.numpy()` is where its rows come to the host.

Waiting for later slices: the decode engine, tensor parallelism,
quantized weights, tuned configs, the analysis/deployment tier, tracing
and the era-wire model format.
"""
import os
import threading
import time

import numpy as np

from .. import io as _io
from ..core.executor import Executor, Scope, resolve_device, to_numpy
from ..core.framework import Parameter, convert_dtype, find_var
from ..core.lod import LoDTensor
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
            out[name] = to_numpy(t)
        return out

    def __repr__(self):
        return "ResultSlice(rows=[%d:%d), bucket=%r)" % (
            self._lo, self._hi, self.bucket)


class _NormalizedRequest(object):
    """A request's feeds, validated and split by kind: dense arrays
    (dtype-cast, [rows, *feat]) and sequence LoDTensors (+ the longest
    sequence). `shape_sig` captures every concrete feature shape: requests
    only coalesce within a signature."""

    __slots__ = ("rows", "dense", "seqs", "max_seq_len", "shape_sig")

    def __init__(self, rows, dense, seqs, max_seq_len):
        self.rows = rows
        self.dense = dense          # name -> np.ndarray [rows, *feat]
        self.seqs = seqs            # name -> LoDTensor
        self.max_seq_len = max_seq_len
        self.shape_sig = tuple(sorted(
            [(n, a.shape[1:]) for n, a in dense.items()] +
            [(n, lt.data.shape[1:]) for n, lt in seqs.items()]))


class InferenceEngine(object):
    """Serve a `save_inference_model` directory on one device.

    device: "cuda" (the default) or "cpu"; with no card and no explicit
    "cpu", construction raises before anything is read.
    batch_buckets / max_batch_size: the batch lattice (default powers of
    two up to max_batch_size=32). seq_buckets: the padded lengths a
    sequence model's dispatches run at (default [16, 32, 64, 128, 256]
    when the model has a sequence feed, else none). pipeline_depth: how
    many dispatches may be outstanding on the device while the next batch
    forms (None: FLAGS_serving_pipeline_depth, else 2; 0 is the serial
    batcher)."""

    def __init__(self, model_dir, device=None, name=None,
                 model_filename=None, batch_buckets=None,
                 max_batch_size=None, seq_buckets=None,
                 max_queue_delay_ms=5.0, queue_capacity=256,
                 default_deadline_ms=None, warmup=True,
                 latency_window=2048, pipeline_depth=None):
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

        # feed contract: per-feed declared feature dims + sequence-ness
        self._feed_vars = {}
        self._seq_feeds = set()
        for n in self.feed_names:
            var = find_var(self.program, n)
            if var is None:
                raise ValueError(
                    "model metadata names feed %r but the program has no "
                    "such variable" % n)
            self._feed_vars[n] = var
            if var.lod_level > 1:
                raise ValueError(
                    "feed %r has lod_level=%d: the serving batcher "
                    "coalesces single-level sequences only"
                    % (n, var.lod_level))
            if var.lod_level > 0 or find_var(
                    self.program, n + SEQLEN_SUFFIX) is not None:
                self._seq_feeds.add(n)

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
        self.seq_buckets = (sorted(set(int(s) for s in seq_buckets))
                            if seq_buckets else
                            ([16, 32, 64, 128, 256] if self._seq_feeds
                             else []))

        # an explicit argument wins over FLAGS_serving_pipeline_depth
        if pipeline_depth is None:
            try:
                pipeline_depth = int(os.environ.get(
                    "FLAGS_serving_pipeline_depth", "2"))
            except ValueError:
                pipeline_depth = 2

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
        """Validate one request's feed dict against the model contract.
        Dense feeds: array-likes [rows, *feat], feature dims checked
        against the declared dims where those are concrete, cast to
        declared dtypes. Sequence feeds: a single-level LoDTensor or a
        list of per-sequence arrays [len_i, *feat], every sequence at
        least one step long, per-token dims checked likewise."""
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
        dense, seqs, max_seq_len = {}, {}, 0
        for n in self.feed_names:
            var = self._feed_vars[n]
            if n in self._seq_feeds:
                lt = self._normalize_sequences(n, var, feed[n])
                lengths = lt.seq_lengths()
                max_seq_len = max(max_seq_len, int(lengths.max()))
                seqs[n] = lt
                r = len(lengths)
            else:
                arr = np.asarray(feed[n])
                if var.dtype is not None:
                    arr = arr.astype(convert_dtype(var.dtype), copy=False)
                if arr.ndim < 1:
                    raise InvalidRequestError(
                        "feed %r must carry a leading batch-rows dim, got "
                        "a scalar" % n)
                want = list(var.shape or [])[1:]
                got = list(arr.shape)[1:]
                if len(got) != len(want) or any(
                        w >= 0 and w != g for w, g in zip(want, got)):
                    raise InvalidRequestError(
                        "feed %r has per-row shape %r but the model "
                        "declares %r" % (n, got, want))
                dense[n] = arr
                r = arr.shape[0]
            if rows is None:
                rows = r
            elif r != rows:
                raise InvalidRequestError(
                    "feeds disagree on batch rows: %r carries %d, earlier "
                    "feeds carry %d" % (n, r, rows))
        if not rows:
            raise InvalidRequestError("request carries zero rows")
        return _NormalizedRequest(rows, dense, seqs, max_seq_len)

    @staticmethod
    def _normalize_sequences(n, var, value):
        """One sequence feed -> a single-level LoDTensor of at least one
        sequence, each at least one step long, with the declared
        per-token dims."""
        if isinstance(value, LoDTensor):
            if value.lod_level() > 1:
                raise InvalidRequestError(
                    "feed %r: nested (multi-level) LoD is not servable; "
                    "send single-level sequences" % n)
            lt = value if value.lod else LoDTensor(
                value.data, [[0, len(value.data)]])
        elif isinstance(value, (list, tuple)):
            lt = LoDTensor.from_sequences([np.asarray(s) for s in value])
        else:
            raise InvalidRequestError(
                "feed %r is a sequence input: send a LoDTensor or a list "
                "of per-sequence arrays" % n)
        lengths = lt.seq_lengths()
        if len(lengths) == 0:
            raise InvalidRequestError("feed %r carries zero sequences" % n)
        if int(lengths.min()) < 1:
            # a real row of length 0 divides by zero in the
            # length-normalizing pools: the client's fault, refused here
            raise InvalidRequestError(
                "feed %r contains an empty sequence; every sequence needs "
                "at least one step" % n)
        # checked here: a bad shape found inside the batch's concatenation
        # would fail every innocent co-batched request
        want = list(var.shape or [])[2:]
        got = list(lt.data.shape)[1:]
        if len(got) != len(want) or any(
                w >= 0 and w != g for w, g in zip(want, got)):
            raise InvalidRequestError(
                "feed %r has per-token shape %r but the model declares %r"
                % (n, got, want))
        return lt

    # --------------------------------------------------------- padding --
    def _pad_batch(self, normalized, batch_bucket, seq_bucket=None):
        """Coalesce normalized requests into one bucket-shaped feed dict.
        Dense pad rows are zeros; a sequence feed pads every sequence to
        seq_bucket steps and adds its `@SEQLEN` lengths, with pad rows of
        length 1 over zeros (a length-0 row would divide by zero in the
        AVERAGE / SQRT pools). Shared by the batcher dispatch AND
        `run_direct`, so the reference path pads byte-identically."""
        feed = {}
        for n in self.feed_names:
            if n in self._seq_feeds:
                var = self._feed_vars[n]
                parts = [req.seqs[n].to_padded(max_len=seq_bucket)
                         for req in normalized]
                arr = np.concatenate([p[0] for p in parts], axis=0)
                if var.dtype is not None:
                    arr = arr.astype(convert_dtype(var.dtype), copy=False)
                lengths = np.concatenate([p[1] for p in parts], axis=0)
                pad_rows = batch_bucket - arr.shape[0]
                if pad_rows:
                    lengths = np.concatenate(
                        [lengths, np.ones(pad_rows, dtype=lengths.dtype)])
                feed[n + SEQLEN_SUFFIX] = lengths
            else:
                arr = np.concatenate([req.dense[n] for req in normalized],
                                     axis=0)
                pad_rows = batch_bucket - arr.shape[0]
            if pad_rows:
                arr = np.concatenate(
                    [arr, np.zeros((pad_rows,) + arr.shape[1:],
                                   dtype=arr.dtype)], axis=0)
            feed[n] = arr
        return feed

    def _pick_buckets(self, rows, max_seq_len):
        """(batch bucket, seq bucket or None) covering a dispatch."""
        batch_bucket = _covering_bucket(self.batch_buckets, rows,
                                        "batch rows")
        seq_bucket = None
        if self._seq_feeds:
            seq_bucket = _covering_bucket(self.seq_buckets,
                                          max(max_seq_len, 1),
                                          "sequence length")
        return batch_bucket, seq_bucket

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
        fails only ITS requests. Returns every group's fetch tensors (for
        the in-flight window's completion event)."""
        groups = {}
        for req in requests:
            groups.setdefault(req.feed.shape_sig, []).append(req)
        handles = []
        for reqs in groups.values():
            try:
                handles.extend(self._dispatch_group(reqs))
            except Exception as e:  # noqa: BLE001 — isolate the group
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                self.metrics.on_error(len(reqs))
        return handles

    def _dispatch_group(self, requests):
        """Pad one shape-compatible group -> one run -> scatter; returns
        the run's fetch tensors."""
        normalized = [req.feed for req in requests]
        rows = sum(r.rows for r in normalized)
        bucket = self._pick_buckets(
            rows, max(r.max_seq_len for r in normalized))
        batch_bucket = bucket[0]
        handles = self._run(self._pad_batch(normalized, *bucket))
        now = time.monotonic()
        offset, latencies = 0, []
        for req, norm in zip(requests, normalized):
            req.future.bucket = bucket
            req.future.latency_s = now - req.enqueued_at
            latencies.append(req.future.latency_s)
            req.future.set_result(ResultSlice(
                self.fetch_names, handles, self._fetch_row_policy,
                offset, offset + norm.rows, batch_bucket, bucket))
            offset += norm.rows
        self.metrics.on_batch(len(requests), rows, batch_bucket, latencies)
        return handles

    # ---------------------------------------------------------- public --
    def submit(self, feed, deadline_ms=None):
        """Enqueue one request for coalesced dispatch; returns a
        RequestFuture whose result is a ResultSlice. A malformed request,
        or one longer than the largest seq bucket, fails here, on the
        caller's thread."""
        norm = self.normalize_feed(feed)
        if self._seq_feeds:
            _covering_bucket(self.seq_buckets, max(norm.max_seq_len, 1),
                             "sequence length")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        return self._batcher.submit(norm, norm.rows, deadline_ms=deadline_ms)

    def infer(self, feed, deadline_ms=None, timeout=30.0):
        """Synchronous convenience: submit + wait + copy this request's
        rows. Returns {fetch_name: np.ndarray}."""
        return self.submit(feed, deadline_ms=deadline_ms) \
            .result(timeout).numpy()

    def run_direct(self, feed, batch_bucket=None, seq_bucket=None):
        """ONE request, padded by the same `_pad_batch` helper and run
        directly — no queue, no coalescing. At given buckets it gives the
        rows the same request gets back from a coalesced batch at those
        buckets. Returns ({fetch_name: np.ndarray}, (batch_bucket,
        seq_bucket)); seq_bucket is None for a model with no sequence
        feed."""
        norm = self.normalize_feed(feed)
        auto_b, auto_s = self._pick_buckets(norm.rows, norm.max_seq_len)
        batch_bucket = batch_bucket or auto_b
        seq_bucket = (seq_bucket or auto_s) if self._seq_feeds else None
        if batch_bucket < norm.rows:
            raise InvalidRequestError(
                "batch_bucket=%d cannot hold the request's %d rows"
                % (batch_bucket, norm.rows))
        if seq_bucket is not None and seq_bucket < norm.max_seq_len:
            raise InvalidRequestError(
                "seq_bucket=%d cannot hold the request's longest sequence "
                "(%d steps)" % (seq_bucket, norm.max_seq_len))
        bucket = (batch_bucket, seq_bucket)
        handles = self._run(self._pad_batch([norm], *bucket))
        res = ResultSlice(self.fetch_names, handles, self._fetch_row_policy,
                          0, norm.rows, batch_bucket, bucket)
        return res.numpy(), bucket

    def warmup(self):
        """Run every bucket of the lattice once on zero feeds (builds the
        kernels and the libraries' per-shape state before the first
        request): every batch bucket, by every seq bucket for a sequence
        model. Sequence feeds warm up with every row of length 1; feature
        dims declared -1 warm up at 1. Returns the number of buckets
        run."""
        buckets = [(b, s) for b in self.batch_buckets
                   for s in (self.seq_buckets or [None])]
        for batch_bucket, seq_bucket in buckets:
            feed = {}
            for n in self.feed_names:
                var = self._feed_vars[n]
                dtype = convert_dtype(var.dtype) if var.dtype else "float32"
                if n in self._seq_feeds:
                    feat = [d if d >= 0 else 1
                            for d in list(var.shape or [])[2:]]
                    feed[n] = np.zeros([batch_bucket, seq_bucket or 1]
                                       + feat, dtype=dtype)
                    feed[n + SEQLEN_SUFFIX] = np.ones(batch_bucket,
                                                      dtype=np.int32)
                else:
                    feat = [d if d >= 0 else 1
                            for d in list(var.shape or [])[1:]]
                    feed[n] = np.zeros([batch_bucket] + feat, dtype=dtype)
            self._run(feed)
        return len(buckets)

    def queue_depth(self):
        return self._batcher.queue_depth()

    def pipeline_stats(self):
        """The batcher's in-flight window stats, or None in serial
        mode."""
        return self._batcher.pipeline_stats()

    def drain(self, timeout=None):
        return self._batcher.drain(timeout)

    def close(self, drain=True, timeout=None):
        """Graceful shutdown: stop intake, drain queued requests, join the
        workers."""
        self.closed = True
        self._batcher.close(drain=drain, timeout=timeout)
