"""Executor + Scope.

Parity: python/paddle/fluid/executor.py, paddle/fluid/framework/
{executor.cc,scope.cc} and the JAX package's core/executor.py. Same
`Executor(place).run(program, feed, fetch_list)` surface; a run walks the
Program op by op (core/lowering.py) on one torch device. The device is
the card unless the caller asks for the CPU (`"cpu"` or `CPUPlace()`):
with no card, construction raises — nothing falls back to the CPU
silently. Scopes nest as the JAX package's do (`new_scope`, parent
lookup, `drop_kids`); `scope_guard` / `switch_scope` swap the global
scope that runs and `fetch_var` read by default.
"""
import collections
import contextlib
import os

import numpy as np
import torch

from . import dispatch as _dispatch
from .dispatch import dispatch_with_deadline, run_step_traced
from .framework import convert_dtype, default_main_program, find_var
from .lod import LoDTensor
from .readers import ReaderBase, is_host_io_op, run_host_io_op
from .lowering import (FETCH_REDUCE_POLICIES, Env, LowerCtx, analyze_state,
                       lower_block, lower_multi_step, unread_outputs)
from .registry import torch_dtype
from .sharded import ShardedValue


def resolve_device(device=None):
    """The torch device an entry point runs on: `device` when given
    ("cuda", "cuda:1", "cpu", a torch.device, or a Place: CPUPlace() the
    CPU, CUDAPlace(i) and TPUPlace(i) card i), else the current CUDA
    device. Raises when a CUDA device is asked for (explicitly or by
    default) and none is available."""
    from ..places import Place
    if device is None:
        device = "cuda"
    if isinstance(device, Place):
        device = device.torch_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device unless asked "
                "otherwise, and torch.cuda.is_available() is False here; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (use 'cuda' or 'cpu')"
                         % (device,))
    return dev


def to_tensor(value, dtype=None, device=None):
    """Host array / tensor -> torch tensor of the declared dtype on
    `device` (the feed and parameter-load conversion)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(convert_dtype(dtype), copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(torch_dtype(convert_dtype(dtype)))
    if device is not None:
        t = t.to(device)
    return t


def to_numpy(t):
    """A tensor as a host numpy array. numpy has no bfloat16: a bf16
    tensor (a mixed-precision activation) comes back as float32, which
    holds every bf16 value exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def convert_feeds(program, feed):
    """Expand a feed dict (parity: the JAX package's
    core/executor.convert_feeds): a LoDTensor becomes its zero-padded
    [num_seqs, max_len, ...] data plus `name@SEQLEN` int32 lengths; a
    sequence var (lod_level > 0) fed any other way needs a padded array
    of its declared rank AND its `@SEQLEN` lengths in the same feed."""
    out = {}
    for name, value in feed.items():
        var = find_var(program, name)
        if isinstance(value, LoDTensor):
            out[name], out[name + "@SEQLEN"] = value.to_padded()
            continue
        if var is not None and var.lod_level > 0:
            try:  # ragged python lists make np.ndim itself raise
                ndim = np.ndim(value)
            except ValueError:
                ndim = -1
            if ndim != len(var.shape or ()) or \
                    name + "@SEQLEN" not in feed:
                raise TypeError(
                    "variable %r is a sequence (lod_level=%d): feed a "
                    "LoDTensor (fluid.create_lod_tensor / "
                    "LoDTensor.from_sequences), or a padded [num_seqs, "
                    "max_len, ...] array plus %r lengths" %
                    (name, var.lod_level, name + "@SEQLEN"))
        out[name] = value
    return out


class _DispatchCancelled(Exception):
    """A watchdog-abandoned worker reached a cancellation checkpoint of the
    io pre-pass; the run unwinds without touching more state."""


def _read_value(value, var, device):
    """A reader field as a tensor of the read_file var's declared dtype on
    the run's device (a field a DoubleBufferReader staged is there
    already; a host one goes through pinned memory, no host sync)."""
    t = to_tensor(value, var.dtype if var is not None else None)
    return t if device is None else _feed_to_device(t, device)


def run_host_io_prepass(program, scope, feeds, steps=1, stacked_out=None,
                        cancelled=None, device=None, popped_out=None):
    """The io pre-pass (parity: the JAX package's run_host_io_prepass):
    reader ops run on the host. create_* ops build reader objects in the
    scope; each `read` op pops the next record and injects its fields as
    feeds of the step (EOFException propagates: check reader.eof()
    first). Global block only.

    device: the run's device. A reader that stages asynchronously
    (DoubleBufferReader) gets it pinned (`pin_place`), so its staging
    thread copies to the device the run takes place on.

    popped_out: the refund ledger of the prefetcher (core/dispatch.py):
    every (reader, records) block that stays consumed when this call
    returns is appended in pop order.

    steps=K: each `read` op pops K records ATOMICALLY (ReaderBase.
    next_many pushes all K back on a mid-block EOF or a bad record) and
    stacks each field with a leading K axis; step i of the K-step run
    reads slice i. Atomicity spans ALL read ops: a failure at the second
    reader pushes the first reader's block back too, so a failed K-step
    run consumes nothing anywhere. The stacked feed names go into
    `stacked_out`. A reader-creation op in the main block is refused
    under steps=K: it would run once per CALL, not once per step."""
    multi_blocks = []     # [(reader, records)] popped so far this call
    multi_stacks = {}     # name -> stacked [K, ...] tensor, committed last

    def _rollback():
        if cancelled is not None and cancelled.is_set():
            return  # an abandoned worker: its caller owns the positions
        for st, recs in reversed(multi_blocks):
            for rec in reversed(recs):
                st.push_back(rec)

    for op in program.global_block().ops:
        if cancelled is not None and cancelled.is_set():
            raise _DispatchCancelled()
        if op.type == "read":
            state = scope.get(op.inputs["Reader"][0])
            if state is None:
                raise RuntimeError(
                    "reader %r has no state; run the startup program "
                    "first" % op.inputs["Reader"][0])
            if device is not None:
                state.pin_place(device)
            out_names = op.outputs["Out"]
            out_vars = [find_var(program, n) for n in out_names]

            def _check(record):
                if len(record) != len(out_names):
                    raise ValueError(
                        "reader yielded %d fields but read_file declared "
                        "%d" % (len(record), len(out_names)))

            if steps == 1:
                record = state.next()
                try:
                    _check(record)
                except Exception:
                    state.push_back(record)
                    raise
                for out_name, val, var in zip(out_names, record, out_vars):
                    feeds[out_name] = _read_value(val, var, device)
                if popped_out is not None:
                    popped_out.append((state, [record]))
            else:
                if hasattr(state, "ensure_staging_depth"):
                    # a double buffer must be able to pre-stage the NEXT
                    # K-block while this one computes
                    state.ensure_staging_depth(steps)
                try:
                    records = state.next_many(steps, validate=_check)
                except Exception:
                    _rollback()
                    raise
                multi_blocks.append((state, records))
                # stack BEFORE committing: records whose field shapes
                # differ cannot stack, and that failure must also consume
                # nothing
                try:
                    for i, (out_name, var) in enumerate(zip(out_names,
                                                            out_vars)):
                        multi_stacks[out_name] = torch.stack(
                            [_read_value(rec[i], var, device)
                             for rec in records])
                except Exception:
                    _rollback()
                    raise
        elif is_host_io_op(op.type):
            if steps > 1:
                _rollback()
                raise RuntimeError(
                    "program contains host io op %r in its main block: "
                    "with steps=%d it would run once per CALL, not once "
                    "per step like %d sequential runs would. Keep reader "
                    "creation in the startup program (the standard "
                    "split), or run this program with steps=1."
                    % (op.type, steps, steps))
            run_host_io_op(op, scope, device)
    if multi_stacks:
        feeds.update(multi_stacks)
        if stacked_out is not None:
            stacked_out.update(multi_stacks)
    if popped_out is not None:
        popped_out.extend(multi_blocks)


class _ScopeVar(object):
    """A named slot of a Scope (parity: framework::Variable as the
    reference's scope.find_var / scope.var return it)."""

    def __init__(self, scope, name):
        self.scope = scope
        self.name = name

    def get_tensor(self):
        v = self.scope._vars.get(self.name)
        return v.assemble() if isinstance(v, ShardedValue) else v

    def set(self, value, place=None):
        self.scope.set(self.name, value)


class Scope(object):
    """Name -> torch tensor store (parity: framework::Scope, with the
    kid-scope tree: new_scope, lookup through the parents, drop_kids)."""

    def __init__(self, parent=None):
        self._vars = {}
        self._rng_counter = 0
        self._parent = parent
        self._kids = []

    def new_scope(self):
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def parent(self):
        return self._parent

    def drop_kids(self):
        self._kids = []

    def set(self, name, value):
        """A tensor, a host array (made a tensor), a reader's host-side
        state (core/readers.ReaderBase) or a ParallelExecutor's sharded
        state (core/sharded.ShardedValue), the last two kept as they are."""
        self._vars[name] = value if isinstance(
            value, (torch.Tensor, ReaderBase, ShardedValue)) \
            else torch.as_tensor(np.asarray(value))

    def get(self, name):
        """The value of `name` here or in a parent scope; a sharded value
        comes back assembled (the global tensor, on replica 0's device)."""
        v = self.get_raw(name)
        return v.assemble() if isinstance(v, ShardedValue) else v

    def get_raw(self, name):
        """As get, but a sharded value as its ShardedValue (pieces and
        spec): what a ParallelExecutor reads its state from."""
        if name in self._vars:
            return self._vars[name]
        return self._parent.get_raw(name) if self._parent is not None \
            else None

    def drop(self, name):
        """Remove `name` from this scope (no-op when absent)."""
        self._vars.pop(name, None)

    def has(self, name):
        return name in self._vars or (
            self._parent is not None and self._parent.has(name))

    def find_var(self, name):
        """This scope's slot `name`, else the nearest parent's, else None
        (parity: Scope::FindVar)."""
        if name in self._vars:
            return _ScopeVar(self, name)
        return self._parent.find_var(name) if self._parent is not None \
            else None

    def var(self, name):
        """This scope's slot `name`, created empty if missing."""
        self._vars.setdefault(name, None)
        return _ScopeVar(self, name)

    def names(self):
        return list(self._vars)

    def next_seed(self):
        self._rng_counter += 1
        return self._rng_counter

    def next_seed_block(self, k):
        """Reserve k consecutive seeds, returning the first. A K-step run
        draws seed..seed+K-1, one a step; the counter moves past all of
        them, as K sequential runs would move it."""
        first = self._rng_counter + 1
        self._rng_counter += k
        return first

    def seed_state(self):
        """The rng cursor as checkpoint payload: with it restored
        (set_seed_state), the runs after a resume draw the seeds the
        straight-through run would have, so dropout masks and every other
        in-graph draw replay bit for bit, eager and under steps=K."""
        return int(self._rng_counter)

    def set_seed_state(self, counter):
        self._rng_counter = int(counter)


_global_scope = Scope()


def global_scope():
    return _global_scope


def switch_scope(scope):
    """Make `scope` the global scope, returning the previous one (parity:
    fluid.executor.switch_scope)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old


@contextlib.contextmanager
def scope_guard(scope):
    """The global scope is `scope` inside the block (parity:
    fluid.executor.scope_guard)."""
    old = switch_scope(scope)
    try:
        yield
    finally:
        switch_scope(old)


def fetch_var(name, scope=None, return_numpy=True):
    """A variable's value from `scope` (default: the global scope), as
    numpy or as the tensor (parity: fluid.executor.fetch_var)."""
    if scope is None:
        scope = _global_scope
    v = scope.find_var(name)
    if v is None or v.get_tensor() is None:
        raise RuntimeError(
            "cannot find variable %r in the scope; only persistable vars "
            "survive Executor.run (set persistable=True or fetch it in "
            "fetch_list)" % name)
    val = v.get_tensor()
    return to_numpy(val) if return_numpy else val


# message prefix check_finite_guard (ops/guard_ops.py) stamps on its
# assertion flags; raise_program_errors keys the typed raise on it
GUARD_MSG_PREFIX = "numerical guard:"


class NumericalGuardError(RuntimeError):
    """A device-side numerical guard (resilience.install_numeric_guards)
    tripped: a non-finite loss, gradient or parameter. The gated state
    updates of the offending step were skipped on the device, so the
    scope still holds the last good values: a supervisor can skip the
    batch, retry or roll back without fearing poisoned parameters."""


# Fault-injection hook (resilience/faults.py): None in production. An
# armed FaultPlan points it at its executor hook, which may raise an
# injected dispatch error, sleep (slow_step) or poison a feed at chosen
# step indices. It fires (dispatch.run_dispatch_hooks) before the io
# pre-pass and the seed draw, so a failed attempt consumes nothing.
_fault_hook = None

# Step-barrier hook of an elastic cluster worker: None outside one.
# resilience.cluster.ElasticWorker installs its _barrier_check here for
# the span of a generation (raising ClusterFenced once the plan moves
# on) and restores the previous hook after it. It fires first, before
# the fault hook.
_barrier_hook = None


def raise_program_errors(errors, include_non_guard=True, stats=None):
    """Raise on tripped in-graph assertions (LowerCtx.add_error), as the
    JAX package's executor does after a run: ONE host read of the
    combined flag in the clean case, each message's flag read only after
    it tripped. A \\x00-joined message carries a vector of flags (one a
    sub-message: check_finite_guard's per-var flags), unpacked only
    after a trip. `stats` ({name: 0-d tensor}, the stat channel) ride
    that same read: their values come back in place as host floats.

    All tripped messages are listed, in the order the JAX package's
    jitted step returns its flags (its dict, in key order), those naming
    a tensor array first. Guard messages (GUARD_MSG_PREFIX) raise
    NumericalGuardError, anything else RuntimeError; with
    include_non_guard=False (FLAGS_tensor_array_safety=0 with guards
    installed) only guard messages count."""
    stats = {} if stats is None else stats
    parts = []
    if errors:
        parts.append(torch.cat([f.reshape(-1) for f in errors.values()])
                     .any().reshape(1).float())
    parts.extend(v.reshape(1).float() for v in stats.values())
    if not parts:
        return
    host = (parts[0] if len(parts) == 1 else torch.cat(parts)).tolist()
    if errors:
        tripped_any, host = bool(host[0]), host[1:]
    for name, v in zip(list(stats), host):
        stats[name] = v
    if not errors or not tripped_any:
        return
    tripped = []
    for msg in sorted(errors):
        flag = errors[msg]
        if "\x00" in msg:
            tripped.extend(m for m, f in zip(msg.split("\x00"),
                                             flag.reshape(-1).tolist()) if f)
        elif bool(flag):
            tripped.append(msg)
    if not include_non_guard:
        tripped = [m for m in tripped if m.startswith(GUARD_MSG_PREFIX)]
    if not tripped:
        return
    # the JAX package's order: the messages naming an array lead
    named = [m for m in tripped if m.startswith("tensor array '")]
    tripped = named + [m for m in tripped if m not in named]
    cls = (NumericalGuardError
           if any(m.startswith(GUARD_MSG_PREFIX) for m in tripped)
           else RuntimeError)
    if len(tripped) == 1:
        raise cls(tripped[0])
    raise cls(
        "%d in-graph assertions tripped in this run:\n- %s"
        % (len(tripped), "\n- ".join(tripped)))


def pop_guard_stats(errors):
    """Move the stat-channel entries (GUARD_STAT_PREFIX: the guard's
    grad norm) out of a run's error dict, in place: {short name: 0-d
    device tensor}. No host read here."""
    from .lowering import GUARD_STAT_PREFIX, is_stat_key
    return {m[len(GUARD_STAT_PREFIX):]: errors.pop(m)
            for m in [m for m in errors if is_stat_key(m)]}


def array_safety_enabled():
    """In-graph assertion checking (default on; the JAX package's
    FLAGS_tensor_array_safety, read when an Executor is made). Checking
    costs one host read of the combined flag per run of a program with an
    asserting op or a tensor array; a decode loop that sizes its arrays
    can set FLAGS_tensor_array_safety=0 to skip it, and then no assertion
    raises but the numerical guards', as in the JAX package (a program
    that installed guards opted into their one read)."""
    return os.environ.get("FLAGS_tensor_array_safety", "1") not in (
        "0", "false", "False")


def _nan_inf_enabled(flag):
    """A check_nan_inf setting: an explicit flag wins, else the
    FLAGS_check_nan_inf env var (parity: the reference's gflag of that
    name, paddle/fluid/framework/operator.cc, and the JAX package)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("FLAGS_check_nan_inf", "") not in (
        "", "0", "false", "False")


def check_finite(named_tensors, context=""):
    """Raise naming the first variable holding a NaN or an infinity (the
    FLAGS_check_nan_inf sweep; parity: paddle/fluid/framework/
    tensor_util.cc TensorContainsNAN / TensorContainsInf). One stacked
    device reduction over every float tensor (ops/guard_ops.
    finite_checks) and one host read; the flags are read one by one
    only after a trip, to name the variable."""
    from ..ops.guard_ops import finite_checks
    floats = [(n, v) for n, v in named_tensors
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not floats:
        return
    bad = finite_checks([v for _, v in floats])[0]
    if not bool(bad.any()):
        return
    name, v = floats[bad.tolist().index(True)]
    kind = "NaN" if bool(torch.isnan(v).any()) else "Inf"
    raise RuntimeError(
        "Operator output variable %r contains %s%s (first bad of %d "
        "elements; enable smaller LR / grad clipping, or inspect with "
        "fluid.debuger)" % (name, kind,
                            " after %s" % context if context else "",
                            v.numel()))


class DispatchTimeoutError(RuntimeError):
    """Executor.run(timeout=) watchdog: a run did not complete within its
    deadline. `cache_key` carries the run's cache key (program uid and
    version, feed signature, fetch names, steps, fetch_reduce, AMP). The
    abandoned worker never writes the scope: in watchdog mode it waits
    for the device before the write-back and stops there once the
    deadline has passed."""

    def __init__(self, message, cache_key=None):
        super(DispatchTimeoutError, self).__init__(message)
        self.cache_key = cache_key


def _feed_signature(feeds):
    """(name, shape, dtype) of every converted feed tensor, by name."""
    return tuple((n, tuple(feeds[n].shape), str(feeds[n].dtype))
                 for n in sorted(feeds))


def _jit_cache_capacity():
    """Most multi-step runners an executor keeps (LRU beyond this); each
    holds its buffers and its CUDA graph's memory pool. The JAX
    package's PADDLE_TPU_JIT_CACHE_SIZE knob (0 = unbounded)."""
    try:
        return int(os.environ.get("PADDLE_TPU_JIT_CACHE_SIZE", "64"))
    except ValueError:
        return 64


def _cache_put_lru(cache, key, entry, capacity):
    """Insert into an OrderedDict LRU, evicting least-recently-used."""
    cache[key] = entry
    cache.move_to_end(key)
    if capacity > 0:
        while len(cache) > capacity:
            cache.popitem(last=False)


def _feed_to_device(t, device):
    """A host feed tensor on `device` without a host sync: through pinned
    memory as a non-blocking copy on the card."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Executor(object):
    """Runs Programs on one device. `place`: "cuda" (default), "cuda:N",
    "cpu", a torch.device or a Place (CPUPlace, CUDAPlace, TPUPlace).
    `check_nan_inf` (default: the FLAGS_check_nan_inf env var) sweeps
    every run's fetches and new state for NaN and infinity and raises
    naming the first bad variable (check_finite)."""

    def __init__(self, place=None, check_nan_inf=None):
        self.device = resolve_device(place)
        self._check_nan_inf = _nan_inf_enabled(check_nan_inf)
        # the guard stat channel of the newest run ({"grad_norm": float}
        # when guards were installed with grad_norm=True): read with the
        # run's one flag read, so the sentinel's watch adds no host read
        self.last_stats = {}
        # (program uid, program version, fetch names) -> the global-block
        # outputs nothing reads in such a run (lowering.unread_outputs)
        self._unread = {}
        # run cache key -> lowering.MultiStepRunner (steps > 1), LRU
        self._cache = collections.OrderedDict()
        # runs that read their in-graph assertion flags on the host: every
        # run of a program with an asserting op, a tensor array or a
        # numerical guard (one read of the combined flag, the guard's
        # statistics riding it, when none tripped), no other run
        self.flag_reads = 0
        self._array_safety = array_safety_enabled()
        # core/dispatch.HostIoPrefetcher, armed by the first
        # run(prefetch=True) of a reader-fed program
        self._prefetcher = None
        # (uid, version) -> the program has `read` ops / any host io op
        self._has_read = {}
        self._has_host_io = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, steps=1,
            fetch_reduce="stack", validate=None, timeout=None,
            apply_tuned=False, prefetch=False):
        """Run `program` once — or, with steps=K > 1, K times in one call.
        Feeds convert to their declared dtypes on this executor's device
        (a LoDTensor feed expands as in `convert_feeds`), parameters read
        from `scope`, every persistable the program writes is stored back
        into `scope`. Returns the fetches as numpy arrays, or as device
        tensors with return_numpy=False (no host sync).

        steps=1 runs the program op by op (core/lowering.lower_block).
        steps=K > 1 runs a lowering.MultiStepRunner: on CUDA one step
        captured into a CUDA graph and replayed K times with no host sync
        between steps (a step that cannot be captured raises
        GraphCaptureError naming its op; nothing runs eager instead), on
        the CPU the same step K times eagerly. The K steps give the bits
        of K sequential runs (step i draws seed s + i of
        Scope.next_seed_block(K)); explicit feeds replay every step.
        `fetch_reduce` picks what the K per-step fetch values collapse
        to: 'stack' (default, leading-K axis), 'last', or 'mean' (in
        f32). Runners are cached per (program uid and version, feed
        signature, fetch names, K, fetch_reduce, AMP), at most
        PADDLE_TPU_JIT_CACHE_SIZE of them (LRU);
        use_program_cache=False builds a fresh one and keeps nothing.

        timeout=SECONDS runs the call on a watchdog worker: it waits for
        the device (an event recorded after the run), and a call past its
        deadline raises DispatchTimeoutError carrying the cache key; the
        abandoned worker never writes the scope.

        A reader-fed program (layers.read_file) gets its records from the
        io pre-pass (run_host_io_prepass): one record a `read` op, or
        with steps=K a [K, ...] stack of K records, step i reading slice
        i. prefetch=True pipelines that pre-pass (core/dispatch.
        HostIoPrefetcher): after a run of a reader-fed program a staging
        thread pops the NEXT call's records while this call's work runs
        on the device, and the next matching run() takes them. A raise
        after the kick, or a next call of another program, scope or
        steps, pushes the staged records back, so the stream replays
        exactly. For a feed-fed program the flag changes nothing, as in
        the JAX package. validate=True and apply_tuned=True (the static
        analyzer and the tuning store) come with ROADMAP A11 and raise."""
        if validate:
            raise NotImplementedError(
                "Executor.run(validate=True): the static program analyzer "
                "comes with ROADMAP A11")
        if apply_tuned:
            raise NotImplementedError(
                "Executor.run(apply_tuned=True): the tuning store comes "
                "with ROADMAP A11")
        args = (program, feed, fetch_list, scope, return_numpy,
                use_program_cache, steps, fetch_reduce, prefetch)
        if timeout is None:
            return self._run_impl(*args)
        return dispatch_with_deadline(
            lambda cancelled, info: self._run_impl(
                *args, cancelled=cancelled, info=info),
            timeout, "Executor.run dispatch")

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache, steps, fetch_reduce, prefetch,
                  cancelled=None, info=None):
        # one `exec/step` span a run, in the ambient trace of a serving
        # batch when there is one (observability/trace: host stamps only)
        return run_step_traced(
            "exe", cancelled,
            lambda tspan: self._run_traced(
                program, feed, fetch_list, scope, return_numpy,
                use_program_cache, steps, fetch_reduce, prefetch, cancelled,
                info, tspan))

    def _run_traced(self, program, feed, fetch_list, scope, return_numpy,
                    use_program_cache, steps, fetch_reduce, prefetch,
                    cancelled, info, tspan):
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        steps = int(steps)
        if steps < 1:
            raise ValueError("steps must be >= 1, got %r" % (steps,))
        tspan.set(program=str(program._uid), version=int(program._version),
                  steps=steps)
        if fetch_reduce not in FETCH_REDUCE_POLICIES:
            raise ValueError("fetch_reduce must be one of %r, got %r"
                             % (FETCH_REDUCE_POLICIES, fetch_reduce))
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        feeds = {}
        for name, value in convert_feeds(program, feed or {}).items():
            var = find_var(program, name)
            feeds[name] = to_tensor(value,
                                    var.dtype if var is not None else None)
        # the cluster barrier and the fault tap fire before the io
        # pre-pass and the seed draw: a failed attempt consumes nothing
        _dispatch.run_dispatch_hooks(program, steps, feeds,
                                     prefetcher=self._prefetcher,
                                     cancelled=cancelled)
        if cancelled is not None and cancelled.is_set():
            return None   # the caller raised: consume nothing, not a seed
        stacked = set()
        if _dispatch.has_host_io_ops(program, self._has_host_io) or (
                self._prefetcher is not None and
                self._prefetcher.has_work()):
            staged = _dispatch.consume_host_io(
                self, program, scope, steps, cancelled, feeds, stacked,
                tspan, device=self.device)
            if staged is _dispatch.CANCELLED or (
                    cancelled is not None and cancelled.is_set()):
                return None   # the caller raised: consume nothing more
        key = (program._uid, program._version, _feed_signature(feeds),
               tuple(fetch_names), steps,
               fetch_reduce if steps > 1 else None, bool(program._amp),
               tuple(sorted(stacked)))
        if info is not None:
            info["cache_key"] = key
        ukey = (program._uid, program._version, tuple(fetch_names))
        if ukey not in self._unread:
            self._unread[ukey] = unread_outputs(program, fetch_names)
        if steps == 1:
            fetches, new_state, errors = self._run_step(
                program, scope, feeds, fetch_names, self._unread[ukey])
        else:
            runner = self._runner(key, program, scope, feeds, fetch_names,
                                  steps, fetch_reduce, self._unread[ukey],
                                  use_program_cache, stacked)
            fetches, new_state, errors = runner(
                scope, feeds, scope.next_seed_block(steps))
        if cancelled is not None:
            # watchdog mode: the deadline needs a completion signal, so
            # the worker waits for the device before the scope write-back
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            if cancelled.is_set():
                return None   # the caller raised: write nothing
        # the state first, as the JAX package writes it back before any
        # raise: a caller that catches the assertion can still read it
        for name, value in new_state.items():
            scope.set(name, value)
        if prefetch:
            # stage the NEXT call's records now, while this call's work
            # runs on the device
            _dispatch.kick_next_prepass(self, program, scope, steps,
                                        cancelled, "exe", device=self.device)
        _dispatch.run_post_dispatch_checks(self, errors, fetches,
                                           fetch_names, new_state,
                                           "Executor.run", cancelled)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def _run_step(self, program, scope, feeds, fetch_names, unread):
        """One op-by-op run: (fetches, {persistable written: value},
        {assertion message: flag})."""
        persistable = {v.name for v in program.list_vars() if v.persistable}
        env = Env(scope, persistable, self.device)
        for name, value in feeds.items():
            env.write(name, _feed_to_device(value, self.device))
        ctx = LowerCtx(program, self.device, run_seed=scope.next_seed(),
                       unread=unread)
        ctx.remat_keep = frozenset(fetch_names)
        with torch.no_grad():
            lower_block(ctx, program.global_block(), env)
        new_state = {}
        for op in program.global_block().ops:
            if is_host_io_op(op.type):
                continue   # the pre-pass put its readers in the scope
            for name in op.all_output_vars():
                if name in persistable:
                    new_state[name] = env.values[name]
        return [env.read(n) for n in fetch_names], new_state, ctx.op_errors

    def _runner(self, key, program, scope, feeds, fetch_names, steps,
                fetch_reduce, unread, use_program_cache, stacked=()):
        """The cached MultiStepRunner of `key`, or a new one."""
        runner = self._cache.get(key) if use_program_cache else None
        if runner is not None and runner.fits(scope):
            self._cache.move_to_end(key)
            return runner
        state_rw, state_ro, state_out = analyze_state(
            program, list(feeds), fetch_names)
        runner = lower_multi_step(
            program, self.device, sorted(feeds), fetch_names, state_rw,
            state_ro, state_out, steps, fetch_reduce=fetch_reduce,
            unread=unread, stacked_names=stacked)
        if use_program_cache:
            _cache_put_lru(self._cache, key, runner, _jit_cache_capacity())
        return runner
