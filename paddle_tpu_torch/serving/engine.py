"""Serving engines: InferenceEngine (bucketed scoring) and DecodeEngine
(slot-resident continuous decode).

Parity: the JAX package's serving/engine.py. `InferenceEngine`: the
native-format load (a `save_inference_model` directory written by either
package) or an in-memory program, the feed contract for dense and
sequence (LoD) feeds, the per-fetch row policy, the (batch, seq) bucket
lattice, coalescing through the Batcher, `run_direct`, and weight-dtype
serving (`weights_dtype` "bf16" / "int8", serving/quantize.py). Every
dispatch runs at a batch size, and for a sequence model at a padded
length, from a small configured lattice of buckets, so a request's rows
come back the same whether it was dispatched alone (`run_direct` at the
same buckets) or coalesced with strangers: at one shape, each row's
result depends only on that row (on the card, cuBLAS picks its algorithm
by shape, which is why the comparison holds only at the same bucket).

Dispatch is pipelined by default (the Batcher's continuous batching at
`pipeline_depth` 2): a dispatch enqueues its run on the device and
returns the batch's fetch tensors without a host sync; a client's
`ResultSlice.numpy()` is where its rows come to the host.

`DecodeEngine` serves ONE step of an autoregressive loop at a fixed
[max_slots, ...] shape, its carried state in persistable slot vars, one
`Executor.run` an iteration, streams admitted and retired between
iterations by a `DecodeBatcher`.

`validate`: the analysis tier (ROADMAP A11) is not ported. Both engines
always run their own checks (feed and fetch names against the program,
the feed contract, the decode slot vars); `validate=True` asked for
explicitly raises NotImplementedError naming A11, so no analysis a
caller asks for is skipped silently, and `deployment_report` stays None.

`InferenceEngine` loads a native directory, a reference-era (era-wire)
one (`model_format` "reference", or "auto" on a directory without
`__model_meta__.json`), or, through `from_checkpoint`, the newest valid
training snapshot of a checkpoint directory.

Tensor-parallel engines: `tp=M` serves over the mesh {"dp": 1, "tp": M}
of `mesh_devices` (default: the first M CUDA devices; a device listed
twice is a mesh of replicas that share it), its weights placed by the
ShardingPlan's tensor-parallel rule with "gather" placement and every
dispatch run by a parallel.ParallelExecutor bound to the engine's program
and Scope: the answers are bit-equal to a one-device engine's.

The pre-dispatch tap: `_replica_tap`, when a ReplicaPool sets it, fires
at the top of every batch dispatch, before padding (core/dispatch.
ReplicaTap): a raise there fails only that group.

Waiting for a later slice: tuned configs (`apply_tuned`; A11).
"""
import os
import threading
import time

import numpy as np
import torch

from .. import io as _io
from ..core.executor import (Executor, Scope, resolve_device, to_numpy,
                             to_tensor)
from ..core.framework import Parameter, convert_dtype, find_var
from ..core.lod import LoDTensor
from ..observability import trace as _trace
from .batcher import Batcher, DecodeBatcher, ServingError
from .metrics import DecodeMetrics, ServingMetrics

__all__ = ["InferenceEngine", "ResultSlice", "InvalidRequestError",
           "DecodeEngine"]

SEQLEN_SUFFIX = "@SEQLEN"

# validate's default: the engine's own checks, and no analysis tier
ENGINE_CHECKS = "engine_checks"


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


def _check_validate(validate, what):
    """`validate` of an engine: the sentinel default (or False) runs the
    engine's own checks; True asks for the analysis tier, which comes
    with ROADMAP A11 and raises rather than being skipped."""
    if validate is True:
        raise NotImplementedError(
            "%s(validate=True): the analysis tier (validate_or_raise, "
            "analyze_deployment, row certificates) comes with ROADMAP A11; "
            "the engine's own checks run by default" % what)


def _load_model(exe, scope, model_dir, model_format, model_filename,
                params_filename):
    """(program, feed_names, fetch_vars) of a model directory loaded into
    `scope`. model_format "native" reads a save_inference_model directory,
    "reference" a reference-era (era-wire) one through
    io.load_reference_model; "auto" reads a directory with a
    `__model_meta__.json` as native and any other as reference."""
    if model_format not in ("auto", "native", "reference"):
        raise ValueError("model_format must be auto|native|reference, "
                         "got %r" % (model_format,))
    if model_format == "auto":
        native = os.path.exists(os.path.join(model_dir,
                                             "__model_meta__.json"))
        model_format = "native" if native else "reference"
    load = (_io.load_inference_model if model_format == "native"
            else _io.load_reference_model)
    return load(model_dir, exe, model_filename=model_filename,
                params_filename=params_filename, scope=scope)


def _strip_host_io(program):
    """A pruned reader-fed training program as a servable one: its `read`
    ops and reader vars go, and the records' vars the kept ops read (data
    vars) become the feeds. An engine has no reader to pull from."""
    from ..core.readers import is_host_io_op
    block = program.global_block()
    io_ops = [op for op in block.ops if is_host_io_op(op.type)]
    if not io_ops:
        return
    block.ops = [op for op in block.ops if not is_host_io_op(op.type)]
    read = set(n for op in block.ops for ns in op.inputs.values()
               for n in ns)
    for op in io_ops:
        for ns in list(op.inputs.values()) + list(op.outputs.values()):
            for n in ns:
                if n not in read:
                    block.vars.pop(n, None)
    program._bump_version()


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
                 "_bucket_rows", "bucket", "_trace")

    def __init__(self, fetch_names, handles, row_policy, lo, hi,
                 bucket_rows, bucket, trace=None):
        self._fetch_names = fetch_names
        self._handles = handles
        self._row_policy = row_policy
        self._lo = lo
        self._hi = hi
        self._bucket_rows = bucket_rows
        self.bucket = bucket  # (batch_bucket, seq_bucket | None)
        self._trace = trace   # the request's trace id: its materialize
        # span records under it, completing the per-request timeline

    def numpy(self):
        with _trace.span("serving/materialize", cat="serving",
                         trace=self._trace):
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
    """Serve a `save_inference_model` directory (or an in-memory program)
    on one device.

    device: "cuda" (the default) or "cpu" (or a Place); with no card and
    no explicit CPU, construction raises before anything is read.
    model_dir (with model_filename, params_filename and model_format
    "auto" | "native" | "reference") or program=, feed_names= and
    fetch_vars=; or `from_checkpoint`.
    batch_buckets / max_batch_size: the
    batch lattice (default powers of two up to max_batch_size=32).
    seq_buckets: the padded lengths a sequence model's dispatches run at
    (default [16, 32, 64, 128, 256] when the model has a sequence feed,
    else none). pipeline_depth: how many dispatches may be outstanding on
    the device while the next batch forms (None:
    FLAGS_serving_pipeline_depth, else 2; 0 is the serial batcher).
    weights_dtype: None/"fp32", "bf16" (weights cast, the program's
    mixed precision on) or "int8" (per-channel quantized weights behind
    `dequantize_channel` ops), applied to a model_dir load; see
    serving/quantize.py. validate: see the module docstring. tp /
    mesh_devices: a tensor-parallel engine (the module docstring); the
    model loads on `device` (default: the mesh's first device), int8
    weights are refused with it as in the JAX package."""

    def __init__(self, model_dir=None, device=None, name=None,
                 model_filename=None, batch_buckets=None,
                 max_batch_size=None, seq_buckets=None,
                 max_queue_delay_ms=5.0, queue_capacity=256,
                 default_deadline_ms=None, warmup=True,
                 latency_window=2048, pipeline_depth=None,
                 params_filename=None, model_format="auto", program=None,
                 feed_names=None, fetch_vars=None, weights_dtype=None,
                 validate=ENGINE_CHECKS, tp=None, mesh_devices=None):
        _check_validate(validate, "InferenceEngine")
        if tp is not None and int(tp) < 1:
            # before the falsy mapping: tp=0 must raise, not serve on one
            # device
            raise ValueError("tp must be >= 1, got %r" % (tp,))
        self.tp = int(tp) if tp is not None else None
        mesh_devices = list(mesh_devices) if mesh_devices else None
        if mesh_devices is not None and self.tp is None:
            self.tp = len(mesh_devices)
        self.mesh = None
        self.plan = None
        self._pexe = None
        self.quantize_report = None
        self._set_weights_dtype(weights_dtype)
        if self.tp is not None:
            mesh_devices = self._tp_devices(mesh_devices)
            if device is None:
                device = mesh_devices[0]
        self.device = resolve_device(device)
        self.name = name or (os.path.basename(os.path.normpath(model_dir))
                             if model_dir else "model")
        self._scope = Scope()
        self._exe = Executor(self.device)
        self._run_lock = threading.Lock()
        self.default_deadline_ms = default_deadline_ms
        self.closed = False
        self.deployment_report = None   # the analysis tier: ROADMAP A11

        if program is None:
            if model_dir is None:
                raise ValueError("need model_dir or an in-memory program")
            program, feed_names, fetch_vars = _load_model(
                self._exe, self._scope, model_dir, model_format,
                model_filename, params_filename)
        elif feed_names is None or fetch_vars is None:
            raise ValueError("in-memory program needs feed_names and "
                             "fetch_vars")
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [v if isinstance(v, str) else v.name
                            for v in fetch_vars]
        for n in self.fetch_names:
            if find_var(self.program, n) is None:
                raise ValueError(
                    "model metadata names fetch %r but the program has no "
                    "such variable" % n)
        if model_dir is not None:
            self._apply_weights_dtype()    # the weights are in the scope
        elif self.weights_dtype != "fp32":
            # an in-memory program has no loaded weights to quantize:
            # serving fp32 under an int8 label would pass every gate
            raise ValueError(
                "weights_dtype=%r needs a model_dir load; an in-memory "
                "program= engine has no loaded weights to quantize"
                % (self.weights_dtype,))

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

        if self.tp is not None:
            from ..parallel.mesh import make_mesh
            from ..parallel.parallel_executor import ParallelExecutor
            from ..parallel.plan import ShardingPlan
            # dp stays in the mesh at size 1: request batches replicate
            # over tp, so the buckets need not divide by anything
            self.mesh = make_mesh({"dp": 1, "tp": self.tp}, mesh_devices)
            self.plan = ShardingPlan.build(self.program, self.mesh,
                                           tp_axis="tp")
            self._pexe = ParallelExecutor(main_program=self.program,
                                          plan=self.plan)
            self._pexe._scope = self._scope

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
            name=self.name, pipeline_depth=pipeline_depth,
            device=self.device)
        self.pipeline_depth = self._batcher.pipeline_depth
        if warmup:
            try:
                self.warmup()
            except Exception:
                # the batcher worker is running: a constructor that raises
                # must not leak a live thread per retry
                self.close(drain=False)
                raise

    @classmethod
    def from_checkpoint(cls, checkpoint_dir, fetch_list, feed_names=None,
                        step=None, warmup=True, **engine_kw):
        """Serve the newest VALID training snapshot of `checkpoint_dir`
        (checkpoint.CheckpointManager's layout, either package's): its
        recorded program pruned to `fetch_list` with for_test=True (as
        save_inference_model prunes), its hash-verified arrays read once
        into the engine's scope on the engine's device, in the declared
        dtypes. A torn or bit-flipped newest snapshot is skipped for the
        newest one that verifies, unless `step` pins one (then it raises).
        A reader-fed program serves with its `read` ops' records as the
        feeds. `weights_dtype` applies after the fp32 masters land; the
        program keeps the training program's mixed-precision setting, as
        save_inference_model's does. feed_names defaults to the pruned
        program's data vars. Sets `checkpoint_step`."""
        from ..checkpoint import CheckpointManager, load_verified_arrays
        target_names = [v if isinstance(v, str) else v.name
                        for v in fetch_list]
        mgr = CheckpointManager(checkpoint_dir, async_save=False)
        try:
            before = None
            while True:
                program, found_step, snap_path = mgr.load_program(
                    step=step, before=before)
                inference = program.prune(target_names, for_test=True)
                _strip_host_io(inference)
                wanted = set(v.name for v in inference.list_vars()
                             if v.persistable)
                try:
                    # single pass: each file is read once, hashed against
                    # the manifest, and decoded from those bytes
                    arrays = load_verified_arrays(snap_path, names=wanted)
                    break
                except (OSError, ValueError):
                    if step is not None:
                        raise  # the caller pinned THIS snapshot
                    before = found_step  # corrupt arrays: walk back
        finally:
            mgr.close()
        if feed_names is None:
            feed_names = [v.name for v in inference.list_vars()
                          if getattr(v, "is_data", False)
                          and not v.persistable]
        fetch_vars = [inference.global_block().var(n)
                      for n in target_names]
        # weights_dtype is applied here, not by the program= constructor
        # (which refuses it: an in-memory program has no weights yet)
        weights_dtype = engine_kw.pop("weights_dtype", None)
        engine = cls(program=inference, feed_names=feed_names,
                     fetch_vars=fetch_vars,
                     name=engine_kw.pop("name", None)
                     or "ckpt-step-%d" % found_step,
                     warmup=False, **engine_kw)
        try:
            declared = {v.name: v for v in inference.list_vars()}
            for name, arr in arrays.items():
                engine._scope.set(name, to_tensor(
                    np.array(arr), declared[name].dtype, engine.device))
            # the snapshot on disk stays the fp32 master copy
            engine._set_weights_dtype(weights_dtype)
            engine._apply_weights_dtype()
            if warmup:
                engine.warmup()
        except Exception:
            engine.close(drain=False)  # no thread leak per failed load
            raise
        engine.checkpoint_step = found_step
        return engine

    def _tp_devices(self, mesh_devices):
        """The mesh's devices: `mesh_devices` (its length must be tp), or
        the first tp CUDA devices (never a device twice on its own: a
        repeated device comes only from an explicit list)."""
        if mesh_devices is None:
            from ..parallel.mesh import default_devices
            try:
                avail = default_devices()
            except RuntimeError:
                avail = []   # no card: none visible
            if len(avail) < self.tp:
                raise ValueError(
                    "tp=%d needs %d devices but only %d are visible"
                    % (self.tp, self.tp, len(avail)))
            return avail[:self.tp]
        if len(mesh_devices) != self.tp:
            raise ValueError("tp=%d but mesh_devices has %d devices"
                             % (self.tp, len(mesh_devices)))
        return mesh_devices

    # --------------------------------------------------- weights dtype --
    def _set_weights_dtype(self, weights_dtype):
        """Validate and record the weight-dtype contract."""
        from .quantize import WEIGHTS_DTYPES
        self.weights_dtype = (weights_dtype or "fp32").lower()
        if self.weights_dtype not in WEIGHTS_DTYPES:
            raise ValueError("weights_dtype must be one of %s, got %r"
                             % (WEIGHTS_DTYPES, weights_dtype))
        if self.weights_dtype == "int8" and self.tp is not None:
            raise ValueError(
                "weights_dtype='int8' does not compose with "
                "tensor-parallel engines yet (the sharding plan "
                "partitions the fp32 param names, not the @QVAL "
                "rewrite); use weights_dtype='bf16' for TP replicas")

    def _apply_weights_dtype(self):
        """Apply weights_dtype to the loaded (program, scope) pair once,
        before the first run. No-op for fp32 or when already applied."""
        if self.weights_dtype == "fp32" or self.quantize_report is not None:
            return
        from .quantize import apply_weights_dtype
        self.quantize_report = apply_weights_dtype(
            self.program, self._scope, self.weights_dtype)

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
        (left on the device: no host sync here). A tensor-parallel engine
        runs through its mesh-bound ParallelExecutor (the same Scope, the
        same buckets, the same fetch tensors)."""
        with self._run_lock:
            if self._pexe is not None:
                return self._pexe.run(self.fetch_names, feed=feed,
                                      return_numpy=False)
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

    # the pre-dispatch tap: a ReplicaPool points it at its per-replica
    # ReplicaTap (dispatch counting, injected replica faults). A raise
    # here fails only this group; the pool fails its requests over
    _replica_tap = None

    def _dispatch_group(self, requests):
        """Pad one shape-compatible group -> one run -> scatter; returns
        the run's fetch tensors."""
        tap = self._replica_tap
        if tap is not None:
            tap()
        normalized = [req.feed for req in requests]
        traces = [getattr(req, "trace", None) for req in requests]
        rows = sum(r.rows for r in normalized)
        bucket = self._pick_buckets(
            rows, max(r.max_seq_len for r in normalized))
        batch_bucket = bucket[0]
        with _trace.span("serving/pad_h2d", cat="serving", traces=traces,
                         rows=rows) as psp:
            feed = self._pad_batch(normalized, *bucket)
            psp.set(bucket=batch_bucket)
        with _trace.span("serving/enqueue", cat="serving", traces=traces,
                         bucket=batch_bucket):
            handles = self._run(feed)
        now = time.monotonic()
        offset, latencies = 0, []
        for req, norm, rtrace in zip(requests, normalized, traces):
            req.future.bucket = bucket
            req.future.latency_s = now - req.enqueued_at
            latencies.append(req.future.latency_s)
            req.future.set_result(ResultSlice(
                self.fetch_names, handles, self._fetch_row_policy,
                offset, offset + norm.rows, batch_bucket, bucket,
                trace=rtrace))
            offset += norm.rows
        self.metrics.on_batch(len(requests), rows, batch_bucket, latencies)
        return handles

    # ---------------------------------------------------------- public --
    def submit(self, feed, deadline_ms=None):
        """Enqueue one request for coalesced dispatch; returns a
        RequestFuture whose result is a ResultSlice. A malformed request,
        or one longer than the largest seq bucket, fails here, on the
        caller's thread."""
        return self.submit_normalized(self.normalize_feed(feed),
                                      deadline_ms=deadline_ms)

    def submit_normalized(self, norm, deadline_ms=None):
        """Enqueue an already-normalized request (a `normalize_feed`
        result): every engine over one program shares the contract, so a
        caller that normalized once may resubmit the same request."""
        if self._seq_feeds:     # reject unservable lengths before queueing
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

    def warmup(self, buckets=None):
        """Run buckets of the lattice once on zero feeds (builds the
        kernels and the libraries' per-shape state before the first
        request). `buckets`: explicit [(batch, seq | None), ...]; default
        every batch bucket, by every seq bucket for a sequence model.
        Sequence feeds warm up with every row of length 1; feature dims
        declared -1 warm up at 1. Returns the number of buckets run."""
        if buckets is None:
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
        self.metrics.on_warmup_compile(len(buckets))
        return len(buckets)

    def queue_depth(self):
        return self._batcher.queue_depth()

    def pipeline_stats(self):
        """The batcher's in-flight window stats, or None in serial
        mode."""
        return self._batcher.pipeline_stats()

    def device_span(self):
        """The devices this engine's dispatches run on: the mesh's (tp
        entries) for a tensor-parallel engine, else its one device."""
        if self.mesh is not None:
            return [str(d) for d in self.mesh.devices.flat]
        return [str(self.device)]

    def describe(self):
        """The /v1/models entry for this engine."""
        return {
            "name": self.name,
            "tp": self.tp,
            "weights_dtype": self.weights_dtype,
            "devices": self.device_span(),
            "feeds": [
                {"name": n,
                 "shape": list(self._feed_vars[n].shape or []),
                 "dtype": convert_dtype(self._feed_vars[n].dtype)
                 if self._feed_vars[n].dtype else None,
                 "sequence": n in self._seq_feeds}
                for n in self.feed_names],
            "fetches": self.fetch_names,
            "batch_buckets": self.batch_buckets,
            "seq_buckets": self.seq_buckets,
            "max_batch_size": self.max_batch_size,
            "pipeline_depth": self.pipeline_depth,
            "status": "closed" if self.closed else "serving",
            "metrics": self.metrics.snapshot(),
        }

    def drain(self, timeout=None):
        return self._batcher.drain(timeout)

    def close(self, drain=True, timeout=None):
        """Graceful shutdown: stop intake, drain queued requests, join the
        workers."""
        self.closed = True
        self._batcher.close(drain=drain, timeout=timeout)


# ---------------------------------------------------------------------------
# DecodeEngine: slot-resident continuous decode
# ---------------------------------------------------------------------------

class DecodeEngine(object):
    """A decode-step program + private Scope + iteration-level batcher.

    The served artifact is ONE step of an autoregressive loop, authored
    (or exported) at a fixed [max_slots, ...] batch shape with its
    carried state (hidden rows, token cursors, caches) held in
    persistable "slot vars", one slot per batch row. Every iteration is
    one eager `Executor.run` of that step at the one shape; the token and
    finished rows come to the host in ONE device-to-host read (the decode
    loop's one synchronizing call: it must see `finished` to admit and
    retire), and the DecodeBatcher admits and retires streams between
    iterations.

    Bit-exactness contract: the program must be deterministic (greedy
    decode, no dropout or sampling), and then a stream's token sequence
    equals a solo decode of that stream on a fresh engine, whatever
    shared the batch or used its slot before: at the fixed shape a row's
    outputs and next state depend only on that row (on the card, cuBLAS
    picks its kernel by shape, so the solo clone runs the same
    [max_slots] shape), and admit rewrites EVERY slot var's row (init
    rows from the stream, zeros otherwise) in place
    (core/lowering.build_slot_update_fn).

    Export caveat: `save_inference_model` prunes to the fetch subgraph,
    so a decode step must be saved with its state-writing outputs among
    the fetch targets (token and finished first; the engine takes
    fetch[0] / fetch[1] as token / finished by default) or the state
    `assign`s are pruned.

    Parity: the JAX package's serving.DecodeEngine, with its signature:
    `place=` is a Place or a device string ("cuda", "cpu"), the card
    unless the caller asks for the CPU (core/executor.resolve_device)."""

    def __init__(self, model_dir=None, model_format="auto",
                 model_filename=None, params_filename=None, place=None,
                 name=None, program=None, startup_program=None,
                 token_var=None,
                 finished_var=None, slot_vars=None, max_slots=8,
                 queue_capacity=256, default_max_new_tokens=128,
                 default_deadline_ms=None, validate=ENGINE_CHECKS,
                 warmup=True, latency_window=4096):
        from ..core.lowering import analyze_state, build_slot_update_fn
        _check_validate(validate, "DecodeEngine")
        self.device = resolve_device(place)
        self.name = name or (os.path.basename(os.path.normpath(model_dir))
                             if model_dir else "decode")
        self._scope = Scope()
        self._exe = Executor(self.device)
        self._run_lock = threading.Lock()
        self.closed = False
        self.deployment_report = None   # the analysis tier: ROADMAP A11
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1, got %r"
                             % (max_slots,))
        self.default_deadline_ms = default_deadline_ms

        if program is None:
            if model_dir is None:
                raise ValueError("need model_dir or an in-memory program")
            program, _feeds, fetch_vars = _load_model(
                self._exe, self._scope, model_dir, model_format,
                model_filename, params_filename)
            fetch_names = [v if isinstance(v, str) else v.name
                           for v in fetch_vars]
            if token_var is None or finished_var is None:
                if len(fetch_names) < 2:
                    raise ValueError(
                        "a decode model dir must be saved with at least "
                        "[token, finished] fetch targets (got %r); or "
                        "pass token_var/finished_var explicitly"
                        % (fetch_names,))
                token_var = token_var or fetch_names[0]
                finished_var = finished_var or fetch_names[1]
        elif token_var is None or finished_var is None:
            raise ValueError("an in-memory decode program needs "
                             "token_var and finished_var")
        self.program = program
        self.token_name = token_var if isinstance(token_var, str) \
            else token_var.name
        self.finished_name = finished_var if isinstance(finished_var, str) \
            else finished_var.name
        self.fetch_names = [self.token_name, self.finished_name]
        for n in self.fetch_names:
            if find_var(self.program, n) is None:
                raise ValueError("decode program has no variable %r" % n)
        if startup_program is not None:
            # the in-memory form: weights into the private scope from the
            # program's seeds (two engines over one pair decode alike);
            # slot vars re-zero below regardless
            self._exe.run(startup_program, scope=self._scope)

        # the step feeds on nothing (everything it consumes is carried
        # persistable state), so analyze_state sees every scope read and
        # write
        self._state_rw, self._state_ro, self._state_out = analyze_state(
            self.program, feed_names=[], fetch_names=self.fetch_names)
        state_read = list(self._state_rw) + list(self._state_ro)

        # slot vars: an explicit list wins; else every WRITTEN persistable
        # (inference programs never write weights) plus read-only state
        # whose leading dim is exactly max_slots (per-slot context set at
        # admit). Pass slot_vars when a [max_slots, d] weight exists.
        if slot_vars is None:
            slot_vars = list(self._state_out)
            for n in self._state_ro:
                var = find_var(self.program, n)
                shape = list(var.shape or []) if var is not None else []
                if shape and shape[0] in (-1, self.max_slots):
                    slot_vars.append(n)
        self.slot_vars = [v if isinstance(v, str) else v.name
                          for v in slot_vars]
        if not self.slot_vars:
            raise ValueError(
                "decode program carries no slot state (no persistable "
                "var is written and none matches max_slots=%d); a decode "
                "step must carry its loop state in persistables"
                % self.max_slots)
        self._slot_var_meta = {}   # name -> (row_shape, dtype)
        for n in self.slot_vars:
            var = find_var(self.program, n)
            if var is None or not var.persistable:
                raise ValueError(
                    "slot var %r is not a persistable variable of the "
                    "decode program" % n)
            shape = list(var.shape or [])
            if not shape or shape[0] not in (-1, self.max_slots):
                raise ValueError(
                    "slot var %r has shape %r; its leading dim must be "
                    "the slot count (max_slots=%d, or -1)"
                    % (n, shape, self.max_slots))
            feat = shape[1:]
            if any(d < 0 for d in feat):
                raise ValueError(
                    "slot var %r has free feature dims %r; decode slot "
                    "state needs concrete per-slot shapes" % (n, feat))
            dtype = convert_dtype(var.dtype) if var.dtype else "float32"
            self._slot_var_meta[n] = (tuple(feat), dtype)

        # non-slot state the step reads must exist in the scope too
        # (zeros for whatever the model load didn't provide)
        self._reset_slot_state()
        for n in state_read:
            if n not in self._slot_var_meta \
                    and self._scope.get(n) is None:
                var = find_var(self.program, n)
                shape = [d if d >= 0 else 1 for d in (var.shape or [1])]
                dtype = convert_dtype(var.dtype) if var.dtype \
                    else "float32"
                self._scope.set(n, self._device_zeros(shape, dtype))

        self._update_rows = build_slot_update_fn()
        self.metrics = DecodeMetrics(latency_window=latency_window)
        self._batcher = DecodeBatcher(
            self._step, self._admit, self.max_slots,
            queue_capacity=queue_capacity,
            default_max_new_tokens=default_max_new_tokens,
            metrics=self.metrics, name=self.name, device=self.device)
        if warmup:
            try:
                self.warmup()
            except Exception:
                self.close(drain=False)   # no thread leak per failed
                raise                     # constructor

    # ----------------------------------------------------- slot state --
    def _device_zeros(self, shape, dtype):
        return torch.from_numpy(np.zeros(shape, dtype=dtype)).to(self.device)

    def _zero_row(self, name):
        feat, dtype = self._slot_var_meta[name]
        return np.zeros(feat, dtype=dtype)

    def _reset_slot_state(self):
        """All slots to zeros: at startup and after warmup (a warmup step
        changes carried state; serving starts from the zeros a fresh solo
        engine starts from)."""
        for n, (feat, dtype) in self._slot_var_meta.items():
            self._scope.set(n, self._device_zeros(
                (self.max_slots,) + feat, dtype))

    def _admit(self, slot, feeds):
        """DecodeBatcher admit callback: overwrite row `slot` of EVERY
        slot var in place, the stream's init rows where given, zeros
        otherwise; the other slots' rows are not touched."""
        feeds = feeds or {}
        names = list(self.slot_vars)
        with self._run_lock:
            vals = tuple(self._scope.get(n) for n in names)
            # a step may leave two slot vars on one tensor (one assign
            # feeding both): each gets its own before a row is written
            seen = set()
            vals = list(vals)
            for i, v in enumerate(vals):
                key = (v.untyped_storage().data_ptr(), v.storage_offset())
                if key in seen:
                    vals[i] = v.clone()
                seen.add(key)
            rows = tuple(feeds[n] if n in feeds else self._zero_row(n)
                         for n in names)
            new_vals = self._update_rows(tuple(vals), slot, rows)
            for n, v in zip(names, new_vals):
                if v is not self._scope.get(n):
                    self._scope.set(n, v)

    def _run_step(self):
        with self._run_lock:
            return self._exe.run(self.program, feed={},
                                 fetch_list=self.fetch_names,
                                 scope=self._scope, return_numpy=False)

    def _step(self):
        """DecodeBatcher step callback: ONE fixed-shape decode iteration
        (an eager Executor.run), then the token and finished rows to the
        host in ONE device-to-host read. Returns (tokens [slots, ...],
        finished [slots] bool, the step's fetch tensors)."""
        handles = self._run_step()
        tok, fin = handles
        wide = torch.float64 if tok.dtype.is_floating_point \
            else torch.int64
        both = torch.cat([tok.reshape(-1).to(wide),
                          fin.reshape(-1).to(wide)]).cpu().numpy()
        k = tok.numel()
        # the token dtype as numpy has it (bf16 comes back as f32, as
        # to_numpy gives it), read off a host tensor: no device copy
        np_dtype = np.float32 if tok.dtype == torch.bfloat16 else \
            torch.empty(0, dtype=tok.dtype).numpy().dtype
        tokens = both[:k].astype(np_dtype).reshape(tuple(tok.shape))
        finished = both[k:].reshape(-1) != 0
        return tokens, finished, handles

    def warmup(self):
        """Run the step once (builds the kernels and the libraries' state
        at the step's shape) and reset slot state to zeros. Returns 1."""
        self._run_step()
        with self._run_lock:
            self._reset_slot_state()
        return 1

    # ---------------------------------------------------------- public --
    def normalize_stream_feed(self, feeds):
        """Validate one stream's init rows: {slot var: row}, each row of
        the var's per-slot shape (dtype cast here). Unknown names and
        shape mismatches are client faults (InvalidRequestError)."""
        feeds = dict(feeds or {})
        out = {}
        for n, value in feeds.items():
            if n not in self._slot_var_meta:
                raise InvalidRequestError(
                    "unknown slot var %r (decode slot state: %r)"
                    % (n, self.slot_vars))
            feat, dtype = self._slot_var_meta[n]
            row = np.asarray(value).astype(dtype, copy=False)
            if tuple(row.shape) != feat:
                raise InvalidRequestError(
                    "init row for %r has shape %r but the slot carries "
                    "%r per stream" % (n, tuple(row.shape), feat))
            out[n] = row
        return out

    def submit(self, feeds=None, max_new_tokens=None, deadline_ms=None):
        """Admit one sequence for continuous-batched decode; returns its
        DecodeStream (tokens arrive incrementally). `feeds` are per-slot
        init rows for a subset of `slot_vars` (the start token, a context
        vector); everything else resets to zeros."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        return self._batcher.submit(self.normalize_stream_feed(feeds),
                                    max_new_tokens=max_new_tokens,
                                    deadline_ms=deadline_ms)

    def decode(self, feeds=None, max_new_tokens=None, deadline_ms=None,
               timeout=120.0):
        """Synchronous convenience: submit + wait; returns the stacked
        token array."""
        return self.submit(feeds, max_new_tokens=max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    def solo_clone(self, name=None, warmup=True):
        """A fresh engine over the SAME program and weights, the
        bit-exactness reference: decode one stream at a time on the clone
        and compare with the continuously batched original. Read-only
        persistables (the weights) are shared: the clone's scope holds
        the very same tensors. Written non-slot state is copied, and slot
        state starts from zeros, as always: the clone shares none of it."""
        clone = DecodeEngine(
            program=self.program, token_var=self.token_name,
            finished_var=self.finished_name,
            slot_vars=list(self.slot_vars), max_slots=self.max_slots,
            place=self.device, name=name or (self.name + "-solo"),
            warmup=False,
            default_max_new_tokens=self._batcher.default_max_new_tokens)
        for n in self._state_ro:
            if n not in self._slot_var_meta:
                v = self._scope.get(n)
                if v is not None:
                    clone._scope.set(n, v)
        for n in set(self._state_rw) | set(self._state_out):
            if n not in self._slot_var_meta:
                v = self._scope.get(n)
                if v is not None:
                    clone._scope.set(n, v.clone())
        if warmup:
            try:
                clone.warmup()
            except Exception:
                clone.close(drain=False)
                raise
        return clone

    def decode_stats(self):
        return self._batcher.decode_stats()

    def queue_depth(self):
        return self._batcher.queue_depth()

    def device_span(self):
        return [str(self.device)]

    def describe(self):
        """The /v1/models entry for this engine."""
        return {
            "name": self.name,
            "mode": "decode",
            "devices": self.device_span(),
            "slot_vars": [
                {"name": n, "row_shape": list(feat), "dtype": dtype}
                for n, (feat, dtype) in sorted(
                    self._slot_var_meta.items())],
            "token_var": self.token_name,
            "finished_var": self.finished_name,
            "max_slots": self.max_slots,
            "default_max_new_tokens":
                self._batcher.default_max_new_tokens,
            "status": "closed" if self.closed else "serving",
            "metrics": self.decode_stats(),
        }

    def drain(self, timeout=None):
        return self._batcher.drain(timeout)

    def close(self, drain=True, timeout=None):
        """Stop intake; drain=True retires every pending and resident
        stream first, drain=False fails them typed (no hang)."""
        self.closed = True
        self._batcher.close(drain=drain, timeout=timeout)
