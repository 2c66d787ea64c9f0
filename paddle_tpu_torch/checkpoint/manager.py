"""CheckpointManager: fault-tolerant asynchronous checkpointing with
bit-exact resume.

Parity: the JAX package's checkpoint/manager.py, on the same on-disk
layout (snapshot.py), so each package restores the other's snapshots.

What a snapshot captures (all of it at ONE step boundary, so the saved
state is exactly "the moment after step N"):

  * every persistable scope value — params, optimizer accumulators,
    beta-pow counters, the @LR_DECAY_COUNTER@ — tagged in the manifest
    with its owner param when it is an optimizer accumulator
  * every outer in-graph reader's position (`ReaderBase.state_dict`),
    including a DoubleBufferReader's staging depth
  * the Scope seed cursor (`Scope.seed_state`), so per-step dropout/rng
    after resume replays the straight-through run bit-for-bit
  * the training program itself (core/program_desc bytes) + its version

Async protocol on the card: `save(step)` captures state on the training
thread without a host synchronization. Reader positions and the seed
cursor are host dicts; each tensor is cloned on the device (an enqueued
copy, so the next training step's update can neither mutate nor free what
the snapshot holds), and one CUDA event is recorded behind the clones.
The single background writer thread (on the card's device) waits on that
event, copies the clones to the host on a stream of its own, serializes
the program (once a program version), then hashes and atomically
publishes the snapshot (snapshot.py) while training continues. A bounded in-flight budget (`max_in_flight`) makes `save`
block when the writer falls behind, which bounds the clones held on the
card.

`restore` walks back to the newest snapshot whose hash tree verifies
(corruption/torn saves are skipped, never half-loaded) and puts
everything back: values (on the executor's device, else the device of the
live value each replaces, else the card; in the dtype the program
declares, else the live value's), reader positions, seed cursor.

Reshard-on-restore: a snapshot records the device layout it was
captured under (`save(layout=)`, a parallel.DeviceLayout, else the active
one, in snapshot.json) and, per value the scope held as a ParallelExecutor
ShardedValue, its PartitionSpec (the manifest's "sharding", the JAX
package's encoding). Arrays are always written as global arrays, so
`restore(layout=)` re-splits them onto any target mesh (a DeviceLayout, a
parallel.Mesh, a ShardingPlan whose specs then win, or a device count):
each value gets its recorded spec adapted to the target (axes the new
mesh lacks are dropped; a dim the new axis size does not divide is not
split) and lands in the scope as per-replica pieces. A snapshot the JAX
package wrote under its 8-device mesh restores onto any port mesh, and
the values are the ones a plain restore() gives.

Cut here, raising rather than skipping: `validate` /
FLAGS_validate_program, the static analysis of the recorded program
(ROADMAP A11).
"""
import atexit
import os
import threading
import time
import weakref

import numpy as np
import torch

from . import snapshot as _snap
from ..observability import registry as _obsreg
from ..observability import trace as _otrace
from .retention import RetentionPolicy, apply_retention

__all__ = ["CheckpointManager", "SaveHandle", "skip_reader_records"]


def _spec_to_json(spec):
    """PartitionSpec -> JSON list (str | [str, ...] | None per dim): the
    plan's encoding, which the manifest's "sharding" entries share."""
    from ..parallel.plan import _spec_to_json as impl
    return impl(spec)


def _adapt_spec(spec_json, mesh, shape):
    """A recorded per-var spec, adapted to the target mesh: axes the mesh
    lacks are dropped, and a dim whose new combined axis size does not
    divide it is not split (an uneven split would corrupt the value)."""
    from ..parallel.mesh import P
    if not spec_json:
        return P()
    out = []
    for i, ent in enumerate(spec_json[:len(shape)]):
        axes = (list(ent) if isinstance(ent, (list, tuple))
                else ([] if ent is None else [ent]))
        kept = [a for a in axes if a in mesh.shape]
        if kept:
            factor = 1
            for a in kept:
                factor *= int(mesh.shape[a])
            if factor <= 0 or int(shape[i]) % factor != 0:
                kept = []
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return P(*out)


def _resolve_layout_mesh(layout):
    """restore(layout=) takes a parallel.DeviceLayout, a parallel.Mesh, a
    parallel.ShardingPlan (its mesh is the target and its specs win) or a
    device count: normalized to (mesh, plan or None). An unsatisfiable
    layout raises here, before anything is read."""
    from ..parallel.mesh import Mesh
    if isinstance(layout, Mesh):
        return layout, None
    if hasattr(layout, "sharding_for") and hasattr(layout, "mesh"):
        return layout.mesh, layout
    if isinstance(layout, int):
        from ..parallel.distributed import DeviceLayout
        layout = DeviceLayout(local_device_count=layout)
    if hasattr(layout, "local_mesh"):
        return layout.local_mesh(), None
    raise TypeError(
        "restore(layout=...) wants a parallel.DeviceLayout, a "
        "parallel.Mesh, a parallel.ShardingPlan or a device count, got %r"
        % (layout,))


def _validate_flag():
    return os.environ.get("FLAGS_validate_program", "").strip().lower() \
        not in ("", "0", "false", "no", "off")


def _refuse_validate(what):
    raise NotImplementedError(
        "%s: validating the recorded program (validate_or_raise, "
        "FLAGS_validate_program) is the analysis tier of ROADMAP A11"
        % what)


_copy_streams = {}


def _copy_stream(device):
    """The stream the writers copy snapshots to the host on (one a card,
    apart from the training stream)."""
    s = _copy_streams.get(device)
    if s is None:
        s = _copy_streams.setdefault(device, torch.cuda.Stream(device))
    return s


def _to_host(t):
    """A card tensor copied to the host on the writers' stream."""
    with torch.cuda.stream(_copy_stream(t.device)):
        return t.to("cpu")


class _DeviceCopy(object):
    """A tensor captured at save(): a clone enqueued on its device's
    current stream, and the event recorded behind every clone of the
    capture. `to_numpy()` (the writer thread) waits on the event, then
    copies to the host on the writer's own stream. numpy has no bfloat16:
    a bf16 tensor is written as float32 (exact), and restore casts it back
    to the dtype the program declares."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event

    def to_numpy(self):
        t = self.tensor
        if t.device.type == "cuda":
            self.event.synchronize()
            t = _to_host(t)
        if t.dtype == torch.bfloat16:
            t = t.float()   # numpy has no bfloat16; exact in float32
        return t.numpy()


def skip_reader_records(scope, reader_names, skip):
    """Advance live reader streams past `skip` records each (or
    per-reader counts when `skip` is a {name: count} dict) by pulling
    and DISCARDING records. A discarded record that raises while being
    read still counts (skipping a poisoned record is the point); EOF
    propagates. Returns the total number of records discarded."""
    from ..core.readers import EOFException
    per = skip if isinstance(skip, dict) else None
    total = 0
    for rname in reader_names:
        live = scope.get(rname)
        if live is None or not hasattr(live, "next"):
            continue
        want = int(per.get(rname, 0)) if per is not None else int(skip)
        for _ in range(max(0, want)):
            try:
                live.next()
            except EOFException:
                raise
            except Exception:
                pass
            total += 1
    return total


class SaveHandle(object):
    """One in-flight (or finished) save. `result()` blocks until the
    snapshot is published and returns its directory; a failed save
    re-raises its error here (and from CheckpointManager.wait)."""

    def __init__(self, step):
        self.step = int(step)
        self._done = threading.Event()
        self._path = None
        self._exc = None
        self._observed = False  # error already delivered via result()
        self.write_seconds = None  # background write+fsync+hash duration
        self.capture_seconds = None  # save()'s own time on the caller
        self.bytes_written = None    # bytes of the published directory

    def done(self):
        return self._done.is_set()

    def exception(self):
        return self._exc

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("checkpoint save for step %d still in "
                               "flight after %ss" % (self.step, timeout))
        if self._exc is not None:
            self._observed = True
            raise self._exc
        return self._path

    def _finish(self, path=None, exc=None):
        self._path = path
        self._exc = exc
        self._done.set()

    def __repr__(self):
        state = ("failed" if self._exc is not None else
                 "done" if self._done.is_set() else "in-flight")
        return "SaveHandle(step=%d, %s)" % (self.step, state)


class _SaveJob(object):
    __slots__ = ("step", "values", "meta", "program", "handle")

    def __init__(self, step, values, meta, program, handle):
        self.step = step
        self.values = values
        self.meta = meta
        self.program = program     # serialized by the writer
        self.handle = handle


class CheckpointManager(object):
    def __init__(self, checkpoint_dir, max_to_keep=None,
                 keep_every_n_steps=None, async_save=True,
                 max_in_flight=2, validate=None):
        """max_to_keep=None keeps every snapshot (the io.save_checkpoint
        behavior the shim preserves); set it to bound disk. validate=True
        (or FLAGS_validate_program with validate=None) asks for the static
        analysis of the recorded program, which comes with ROADMAP A11:
        it raises rather than being skipped."""
        if validate:
            _refuse_validate("CheckpointManager(validate=True)")
        self.checkpoint_dir = str(checkpoint_dir)
        self.policy = RetentionPolicy(max_to_keep=max_to_keep,
                                      keep_every_n_steps=keep_every_n_steps)
        self.async_save = bool(async_save)
        self._inflight = threading.Semaphore(max(1, int(max_in_flight)))
        self._validate = validate
        self._lock = threading.Lock()
        self._pending = []           # SaveHandles not yet collected
        self._queue = None
        self._thread = None
        self._device = None          # the card the writer thread sets
        self._program_bytes = (None, None)  # ((uid, version), bytes)
        self._closed = False
        _live_managers.add(self)

    # --------------------------------------------------------- capture --
    def save(self, step, program=None, scope=None, wait=False, extra=None,
             layout=None):
        """Snapshot full training state after step `step`. Returns a
        SaveHandle; with async_save the write happens on the background
        thread and this call only pays the capture (device-side clones
        and one event, host dicts; no host synchronization) — unless
        `max_in_flight` older saves are still writing, in which case it
        blocks until one drains. `layout` (a parallel.DeviceLayout,
        default the active one) is recorded as the cohort shape the
        snapshot was written under; per-value specs of sharded state are
        recorded either way, for restore(layout=)."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        if layout is not None and not hasattr(layout, "to_json"):
            raise TypeError("save(layout=...) records a "
                            "parallel.DeviceLayout, got %r" % (layout,))
        if self._validate is None and _validate_flag():
            _refuse_validate("CheckpointManager.save with "
                             "FLAGS_validate_program set")
        t0 = time.perf_counter()
        # capture span: the synchronous cost the training loop pays; the
        # background write has its own span on the writer thread
        csp = _otrace.span("checkpoint/capture", cat="checkpoint",
                           step=int(step))
        try:
            job = self._capture_job(step, program, scope, extra, layout)
        except BaseException as e:
            # a failed capture must not strand the span open
            csp.end(error=type(e).__name__)
            raise
        csp.end(values=len(job.values),
                sync=bool(wait or not self.async_save))
        job.handle.capture_seconds = time.perf_counter() - t0
        if wait or not self.async_save:
            # inline write: raises on failure (the sync contract). An
            # async save still writing the same step would share its tmp
            # directory (named by step and pid): drain the writer first
            with self._lock:
                same_step = any(h.step == job.handle.step and not h.done()
                                for h in self._pending)
            if same_step:
                self.wait()
            self._run_job(job, reraise=True)
            return job.handle
        with self._lock:
            # prune finished handles (a day-long run must not accumulate
            # one per save) and surface the first background failure HERE:
            # a trainer that ignores its SaveHandles must not run on
            # believing checkpoints exist while every write fails
            failed = [h for h in self._pending
                      if h.done() and h.exception() is not None
                      and not h._observed]
            self._pending = [h for h in self._pending if not h.done()]
            if not failed:
                self._pending.append(job.handle)
        if failed:
            # this save is NOT enqueued: checkpointing is broken and the
            # caller must know before trusting another interval to it
            raise failed[0].exception()
        self._inflight.acquire()  # bounded budget: backpressure here
        self._ensure_thread()
        self._queue.put(job)
        return job.handle

    def _capture_job(self, step, program, scope, extra, layout=None):
        """The synchronous capture half of save(): quiesce staged
        prefetches, snapshot every persistable + reader position + the
        seed cursor, and return the _SaveJob the writer publishes."""
        from ..core.dispatch import rollback_all_staged
        from ..core.executor import global_scope
        from ..core.framework import Parameter, default_main_program
        from ..core.readers import ReaderBase
        from ..io import _is_reader_var, _reader_var_names
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()

        # pipelined-dispatch quiesce: a prefetcher may hold a staged block
        # it popped for the NEXT run; those records have not trained, so
        # they are refunded before reader positions are read
        rollback_all_staged(scope)

        reader_names = _reader_var_names(program)
        acc_owner = getattr(program, "_accumulator_owner", {})
        # only OUTERMOST readers are recorded: an inner reader (one some
        # decorator wraps as its `_under`) replays THROUGH the decorator's
        # load_state_dict. Inner-ness is decided by live-object identity
        # (the creation ops live in the startup program).
        inner_reader_ids = set()
        for v in program.list_vars():
            if not v.persistable:
                continue
            under = getattr(scope.get(v.name), "_under", None)
            while under is not None:
                inner_reader_ids.add(id(under))
                under = getattr(under, "_under", None)
        values, reader_states = [], {}
        events = {}
        from ..core.sharded import ShardedValue
        for v in program.list_vars():
            if not v.persistable:
                continue
            raw = scope.get_raw(v.name)
            val = raw.assemble() if isinstance(raw, ShardedValue) else raw
            # io.save_vars' classification: live readers are runtime
            # plumbing, not tensor payload
            if isinstance(val, ReaderBase) or _is_reader_var(
                    v, reader_names):
                if hasattr(val, "state_dict") \
                        and id(val) not in inner_reader_ids:
                    reader_states[v.name] = val.state_dict()
                continue
            if val is None:
                raise RuntimeError(
                    "checkpoint save: persistable variable %r has no "
                    "value in the scope — the snapshot would silently "
                    "omit it and resume would leave it at init. Run the "
                    "startup program first." % v.name)
            entry = {"is_param": isinstance(v, Parameter)}
            if v.name in acc_owner:
                # optimizer accumulator: tie it to its owner param ("" =
                # optimizer-global state like the beta pows)
                entry["owner"] = acc_owner[v.name]
            if isinstance(raw, ShardedValue) and raw.spec:
                # the spec this value was split with on its source mesh:
                # what restore(layout=) adapts to the target
                entry["sharding"] = _spec_to_json(raw.spec)
            if not isinstance(val, torch.Tensor):
                val = torch.as_tensor(np.asarray(val))
            values.append((v.name, entry, val.detach().clone()))
            if val.device.type == "cuda" and val.device not in events:
                events[val.device] = None
        # one event a device, behind every clone enqueued on its stream
        for dev in events:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events[dev] = ev
            self._device = dev
        values = [(name, entry, _DeviceCopy(t, events.get(t.device)))
                  for name, entry, t in values]

        meta = {"seed_cursor": int(scope.seed_state()),
                "reader_states": reader_states,
                "program_version": int(getattr(program, "_version", 0)),
                "wall_time": time.time()}
        if layout is None:
            from ..parallel.distributed import active_layout
            layout = active_layout()
        if layout is not None:
            meta["device_layout"] = layout.to_json()
        if extra:
            meta["extra"] = dict(extra)
        return _SaveJob(int(step), values, meta, program, SaveHandle(step))

    def _serialized(self, program, version):
        """The program's core/program_desc bytes at `version`, serialized
        on the writer (a Transformer-base training program takes ~0.1 s,
        longer than a step) and reused while the version holds."""
        from ..core import program_desc as _pd
        key = (program._uid, version)
        if self._program_bytes[0] != key:
            data = _pd.program_to_bytes(program)
            if program._version != version:
                raise RuntimeError(
                    "checkpoint save: the program changed (version %d -> "
                    "%d) while its snapshot was being written"
                    % (version, program._version))
            self._program_bytes = (key, data)
        return self._program_bytes[1]

    # ----------------------------------------------------------- write --
    def _run_job(self, job, reraise=False):
        wsp = _otrace.span("checkpoint/write", cat="checkpoint",
                           step=job.step)
        reg = _obsreg.REGISTRY
        try:
            t0 = time.perf_counter()
            program_bytes = self._serialized(
                job.program, job.meta["program_version"])
            path = _snap.write_snapshot(
                self.checkpoint_dir, job.step, job.values, job.meta,
                program_bytes=program_bytes)
            apply_retention(self.checkpoint_dir, self.policy,
                            protect=(job.step,))
            job.handle.write_seconds = time.perf_counter() - t0
            job.handle.bytes_written = sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))
            job.handle._finish(path=path)
            wsp.end()
            # the save-latency surface /metrics reads: one observation per
            # published snapshot
            reg.histogram(
                "ptpu_checkpoint_save_seconds",
                "background snapshot write+hash+fsync latency"
            ).observe(job.handle.write_seconds)
            reg.counter("ptpu_checkpoint_saves_total",
                        "snapshot saves by outcome").inc(status="ok")
        except BaseException as e:  # surfaced via handle / wait()
            wsp.end(error=type(e).__name__)
            reg.counter("ptpu_checkpoint_saves_total",
                        "snapshot saves by outcome").inc(status="error")
            job.handle._finish(exc=e)
            if reraise:
                raise
        finally:
            job.values = None  # release the captured clones promptly
            job.program = None

    def _writer_loop(self):
        if self._device is not None:
            torch.cuda.set_device(self._device)
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run_job(job)
            finally:
                self._inflight.release()

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            import queue as _q
            self._queue = _q.Queue()
            self._thread = threading.Thread(target=self._writer_loop,
                                            daemon=True,
                                            name="ckpt-writer")
            self._thread.start()

    def wait(self, timeout=None):
        """Drain every in-flight save; re-raises the first failure. A
        handle still in flight when `timeout` expires goes BACK on the
        pending list, so its eventual failure surfaces at the next
        save()/wait()/close()."""
        with self._lock:
            handles, self._pending = self._pending, []
        first_exc = None
        unfinished = []
        for h in handles:
            try:
                h.result(timeout)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
                if not h.done():
                    unfinished.append(h)
        if unfinished:
            with self._lock:
                self._pending = unfinished + self._pending
        if first_exc is not None:
            raise first_exc
        return handles

    def close(self, timeout=30.0):
        """Drain pending saves and stop the writer thread."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait(timeout)
        finally:
            if self._thread is not None and self._thread.is_alive():
                self._queue.put(None)
                self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- restore --
    def latest_step(self, deep=True):
        found = _snap.find_valid_snapshot(self.checkpoint_dir, deep=deep)
        return None if found is None else found[0]

    def steps(self):
        """All published steps, oldest first (validity not checked)."""
        return [s for s, _ in _snap.list_steps(self.checkpoint_dir)]

    def restore(self, program=None, scope=None, executor=None, step=None,
                allow_missing=False, before=None, layout=None,
                skip_records=None):
        """Load the newest VALID snapshot (or `step`) into `scope`:
        persistable values, reader positions, seed cursor. Returns the
        restored step, or None when no snapshot exists at all. A snapshot
        whose hash tree fails verification is skipped and the next-newest
        one is used. A PINNED `step` that is missing or corrupt raises.

        Each value lands as a tensor on `executor`'s device, else on the
        device of the live value it replaces, else on the card
        (resolve_device()); its dtype is the one `program` declares, else
        the live value's, else the file's (a JAX snapshot written with x64
        off holds int64 counters as int32).

        `before=N` restricts to snapshots strictly older than step N.
        With `program`, every persistable the program declares (reader
        plumbing aside) must be in the manifest unless allow_missing, and
        every reader state the snapshot records must have a live reader in
        the scope (run the startup program first). `skip_records` (int, or
        {reader_name: int}) advances each restored reader PAST that many
        records after its position is replayed.

        `layout` (a parallel.DeviceLayout, a parallel.Mesh, a
        ShardingPlan or a device count) reshards: each value lands split
        over the target mesh per its recorded spec adapted to the mesh
        (a plan's own spec wins), as a ShardedValue (the scope's readers
        see the same global values a plain restore gives). A layout the
        process cannot satisfy raises before anything is read."""
        from ..core.dispatch import rollback_all_staged
        from ..core.executor import global_scope
        scope = scope if scope is not None else global_scope()
        target_mesh, target_plan = (None, None) if layout is None \
            else _resolve_layout_mesh(layout)
        # pipelined-dispatch quiesce BEFORE reader replay: a staged block
        # refunded after load_state_dict's reset+replay would prepend
        # stale records into the freshly restored stream
        rollback_all_staged(scope)
        # resume entry point: sweep dead writers' droppings first; this
        # also RECOVERS a step dir a killed same-step re-save left parked
        _snap.clean_stale_tmp(self.checkpoint_dir)
        declared = {}
        if program is not None:
            declared = {v.name: v for v in program.list_vars()
                        if v.persistable}
        for found_step, path in self._candidates(step):
            if before is not None and found_step >= before:
                continue
            # cheap structural probe; array payloads are verified below
            # AS they are read (one pass over the bytes)
            if _snap.verify_snapshot_light(path):
                continue
            manifest = _snap.load_manifest(path)
            meta = _snap.read_snapshot_meta(path)

            if program is not None and not allow_missing:
                from ..io import _is_reader_var, _reader_var_names
                reader_names = _reader_var_names(program)
                want = set(n for n, v in declared.items()
                           if not _is_reader_var(v, reader_names))
                absent = sorted(want - set(manifest))
                if absent:
                    raise RuntimeError(
                        "checkpoint restore: snapshot step_%d at %r does "
                        "not carry %d persistable variable(s) the program "
                        "needs: %s (allow_missing=True for a deliberate "
                        "partial restore)" % (found_step,
                                              self.checkpoint_dir,
                                              len(absent), absent))
            reader_states = ({} if meta.get("legacy")
                             else meta.get("reader_states") or {})
            if program is not None:
                # liveness BEFORE the first scope.set: raising after
                # params landed would leave a half-restored scope
                for rname in reader_states:
                    if not hasattr(scope.get(rname), "load_state_dict"):
                        raise RuntimeError(
                            "checkpoint restore: snapshot records reader "
                            "state for %r but the scope has no live "
                            "reader there — run the startup program "
                            "first, then restore" % rname)
            try:
                loaded = _snap.load_verified_arrays(path, manifest)
            except (OSError, ValueError):
                continue  # torn or bit-flipped arrays: walk back
            # placed as tensors before the first scope.set: a placement
            # failure must not leave the scope half-restored
            placed = {name: _placed(arr, scope.get_raw(name),
                                    declared.get(name), executor,
                                    target_mesh)
                      for name, arr in loaded.items()}
            if target_mesh is not None:
                placed = {name: _resharded(name, t, manifest, target_mesh,
                                           target_plan)
                          for name, t in placed.items()}
            for name, t in placed.items():
                scope.set(name, t)

            if not meta.get("legacy") and "seed_cursor" in meta:
                scope.set_seed_state(meta["seed_cursor"])
            for rname, rstate in reader_states.items():
                live = scope.get(rname)
                if hasattr(live, "load_state_dict"):
                    live.load_state_dict(rstate)
            if skip_records:
                skip_reader_records(scope, reader_states, skip_records)
            return found_step
        if step is not None:
            raise ValueError(
                "checkpoint restore: pinned step_%d under %r is missing "
                "or fails verification — refusing to silently start "
                "fresh (omit `step` to fall back to the newest valid "
                "snapshot)" % (int(step), self.checkpoint_dir))
        return None

    def _candidates(self, step=None):
        """Snapshot dirs to try, newest first (or the one pinned step)."""
        if step is not None:
            path = os.path.join(self.checkpoint_dir,
                                _snap.step_dir_name(step))
            return [(int(step), path)] if os.path.isdir(path) else []
        return list(reversed(_snap.list_steps(self.checkpoint_dir)))

    def load_program(self, step=None, before=None):
        """The training program recorded in the newest valid snapshot (or
        `step`), parsed: (program, step, snapshot_path). `before`
        restricts to steps strictly older — a caller that found the
        returned snapshot's ARRAYS corrupt walks back by retrying with
        before=<that step>."""
        from ..core import program_desc as _pd
        _snap.clean_stale_tmp(self.checkpoint_dir)
        for found_step, path in self._candidates(step):
            if before is not None and found_step >= before:
                continue
            # light verify covers everything this path reads (the
            # program's own hash included); callers loading arrays from
            # the returned path verify them as they read
            if _snap.verify_snapshot_light(path):
                continue
            meta = _snap.read_snapshot_meta(path)
            prog = meta.get("program")
            if not prog:
                raise ValueError(
                    "snapshot step_%d carries no recorded program "
                    "(legacy io.save_checkpoint layout?)" % found_step)
            with open(os.path.join(path, prog["file"]), "rb") as f:
                program = _pd.program_from_bytes(f.read())
            return program, found_step, path
        raise FileNotFoundError(
            "no valid snapshot under %r" % self.checkpoint_dir)


def _resharded(name, t, manifest, mesh, plan):
    """A restored global tensor split over `mesh` per its recorded spec
    (the plan's, when it has one) adapted to the mesh; a value the spec
    does not split stays one tensor on a mesh of one device, else one
    piece a replica."""
    from ..core.sharded import ShardedValue
    spec_json = manifest.get(name, {}).get("sharding")
    if plan is not None and plan.spec_for(name) is not None:
        spec_json = _spec_to_json(plan.spec_for(name))
    spec = _adapt_spec(spec_json, mesh, tuple(t.shape))
    if any(spec) or len(mesh.distinct_devices()) > 1:
        return ShardedValue.split(mesh, spec, t)
    return t


def _placed(arr, live, var, executor, mesh=None):
    """One restored array as a tensor: on the target mesh's first device,
    else the executor's, else the live value's, else the card; in the
    declared dtype, else the live value's, else the file's."""
    from ..core.executor import resolve_device, to_tensor
    from ..core.registry import torch_dtype
    from ..core.framework import convert_dtype
    from ..core.sharded import ShardedValue
    if isinstance(live, ShardedValue):
        live = live.pieces[0]
    live_t = live if isinstance(live, torch.Tensor) else None
    if not arr.flags.writeable:     # np.load over the verified bytes
        arr = arr.copy()
    if mesh is not None:
        device = mesh.devices.flat[0]
    elif executor is not None and hasattr(executor, "device"):
        device = executor.device
    elif live_t is not None:
        device = live_t.device
    else:
        device = resolve_device()
    t = to_tensor(arr, None, device)
    if var is not None and var.dtype is not None:
        dtype = torch_dtype(convert_dtype(var.dtype))
    elif live_t is not None:
        dtype = live_t.dtype
    else:
        dtype = t.dtype
    return t.to(dtype)


# Interpreter-exit safety: drain live managers so an in-flight async save
# finishes (or is abandoned at a kill point the atomic protocol already
# tolerates) instead of dying as a half-written tmp dir on clean exits.
_live_managers = weakref.WeakSet()


@atexit.register
def _drain_managers():
    for m in list(_live_managers):
        try:
            m.close(timeout=30.0)
        except Exception:
            pass
