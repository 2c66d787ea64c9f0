"""In-graph file readers: host-side reader state and staging to the card.

Parity: python/paddle/fluid/layers/io.py:262-366 (open_recordio_file,
open_files, create_shuffle_reader, create_double_buffer_reader,
create_multi_pass_reader, read_file), the C++ reader ops under
paddle/fluid/operators/reader/ and the JAX package's core/readers.py.

As in the JAX package, reader STATE is a host-side object stored in the
Scope under the reader variable's name, and the Executor runs the reader
ops in a host pre-pass (core/executor.run_host_io_prepass): `create_*` ops
build reader objects, and each `read` op pops the next record and injects
it as a feed of the step. The op-by-op interpreter never sees these ops.

DoubleBufferReader is the async input pipeline: a daemon thread pulls
records from the reader below it and, for a card, copies each field from
pinned host memory on a CUDA stream of its own, recording an event behind
the copies. The consumer's stream waits on that event (no host sync), so
the host-to-device copy of the next batch overlaps the current step, as
the reference's double_buffer reader overlapped it with CUDA streams.

Two resilience seams, as in the JAX package: the fault-injection hook
(`_fault_hook`, armed by resilience.FaultPlan) fires per record at each
source reader, keyed on that reader's own delivered-record counter, and
the fault listener (`set_fault_listener`, a Supervisor's) hears a worker
thread's error the moment the worker dies. A DoubleBufferReader's worker
pulls each record through the source's hook on the host, before its
pinned copy to the card: a poisoned record reaches the card poisoned.
"""
import atexit
import collections
import queue
import threading
import time
import weakref

import numpy as np
import torch

__all__ = ["EOFException", "HOST_IO_OPS", "run_host_io_op", "is_host_io_op",
           "ReaderBase", "IteratorReader", "RecordIOReader",
           "MultiFileReader", "ShuffleReader", "MultiPassReader",
           "DoubleBufferReader", "set_fault_listener"]


class EOFException(Exception):
    """Raised by a `read` op when the underlying reader is exhausted
    (parity: the reference reader's has_next() turning false;
    `reader.eof()` is the polite way to check first)."""


# Fault-injection seam (resilience/faults.py): None in production. An
# armed FaultPlan points it at its reader hook, which can stall, raise or
# poison a record at a chosen stream position, keyed on the reader's own
# delivered-record counter, so it stays deterministic while a
# DoubleBufferReader worker pre-stages ahead of the training loop.
_fault_hook = None

# Supervisor fault channel: a reader worker thread that hits an exception
# tells this listener at once (from the worker), instead of the error
# surfacing only at the next `read`.
_fault_listener = None


def set_fault_listener(fn):
    """Install `fn(reader, exc)` as the reader-worker fault channel;
    returns the previous listener (restore it when done). fn runs ON the
    worker thread and must be quick and exception-safe."""
    global _fault_listener
    old, _fault_listener = _fault_listener, fn
    return old


def _notify_fault(reader, exc):
    if _fault_listener is not None:
        try:
            _fault_listener(reader, exc)
        except Exception:
            pass  # a broken listener must not mask the real fault


# op types the Executor runs host-side instead of lowering
HOST_IO_OPS = frozenset({
    "create_recordio_file_reader", "open_files", "create_shuffle_reader",
    "create_double_buffer_reader", "create_multi_pass_reader", "read"})


def is_host_io_op(op_type):
    return op_type in HOST_IO_OPS


class ReaderBase(object):
    """Host-side reader state. next() returns one record (tuple of arrays)
    or raises EOFException; eof() peeks; reset() restarts; close() releases
    threads/files (called when a startup re-run displaces the state).
    Pushed-back records live in a deque, so a whole K-record block a
    multi-step run could not use returns intact (next_many).

    Checkpointing: `_consumed` counts records DELIVERED to the trainer
    (push_back refunds, so a failed multi-step K-block nets to zero and
    mid-K-block positions round-trip exactly). state_dict/load_state_dict
    snapshot/restore the position by deterministic replay: reset() the
    chain, then re-consume `_consumed` records. Exact for deterministic
    sources (recordio files, seeded shuffle, multi-pass); best-effort for
    MultiFileReader's thread-racy interleave."""

    def __init__(self):
        self._pending = collections.deque()
        self._consumed = 0

    def next(self):
        if _fault_hook is not None:
            # "read" phase: may sleep (injected stall) or raise (injected
            # reader error / early EOF) BEFORE the record pops, so the
            # stream position is untouched by the failure
            _fault_hook("read", self)
        if self._pending:
            rec = self._pending.popleft()
        else:
            rec = self._next()
        if _fault_hook is not None:
            # "record" phase: may poison the popped record (NaN, spike)
            rec = _fault_hook("record", self, record=rec) or rec
        self._consumed += 1
        return rec

    def push_back(self, record):
        """Return a just-popped record to the front of the stream (used by
        the executor prepass when a record fails validation, so the error
        doesn't consume it). Multiple push_backs stack LIFO, so pushing a
        block back newest-first restores the original order."""
        self._pending.appendleft(record)
        self._consumed -= 1

    def state_dict(self):
        """Snapshot of this reader's stream position (checkpoint
        payload). Cheap: a host dict, never tensor data."""
        return {"reader": type(self).__name__,
                "consumed": int(self._consumed)}

    def load_state_dict(self, state):
        """Restore a state_dict position by deterministic replay: reset
        the whole decorator chain (reseeding shuffle buffers, rewinding
        passes), then re-consume and discard the recorded number of
        records. After this, the next record delivered is exactly the one
        the checkpointed run would have read next."""
        self.reset()
        for _ in range(int(state.get("consumed", 0))):
            self.next()

    def next_many(self, k, validate=None):
        """Pop k records atomically (the multi-step executor's K-block).
        `validate(record)` vets each record as it is popped. If EOF or a
        validation failure hits before all k are accepted, EVERY popped
        record (including the offender) goes back on the stream in original
        order and the error propagates — a failed K-step run consumes
        nothing, so the caller can drain the remaining tail with steps=1
        or fix the offending record's feed path."""
        out = []
        try:
            for _ in range(k):
                out.append(self.next())
                if validate is not None:
                    validate(out[-1])
        except Exception:
            for rec in reversed(out):
                self.push_back(rec)
            raise
        return out

    def pin_place(self, device):
        """Tell the chain which device dispatches will run on (a
        torch.device), so an async-staging decorator below
        (DoubleBufferReader) stages to THAT device on its worker thread.
        Called by the executors' io prepass; an explicit
        double_buffer(place=...) always wins."""
        under = getattr(self, "_under", None)
        if under is not None and hasattr(under, "pin_place"):
            under.pin_place(device)

    def eof(self):
        if self._pending:
            return False
        try:
            self._pending.append(self._next())
            return False
        except EOFException:
            return True

    def reset(self):
        self._pending.clear()
        self._consumed = 0
        self._reset()

    def close(self):
        self._pending.clear()

    def _next(self):
        raise NotImplementedError

    def _reset(self):
        raise NotImplementedError


class IteratorReader(ReaderBase):
    """Reader over a restartable sample-iterator factory."""

    def __init__(self, creator):
        super(IteratorReader, self).__init__()
        self._creator = creator
        self._it = creator()

    def _next(self):
        try:
            return next(self._it)
        except StopIteration:
            raise EOFException()

    def _reset(self):
        self._it = self._creator()


class RecordIOReader(IteratorReader):
    def __init__(self, filename):
        from ..recordio_writer import recordio_reader
        super(RecordIOReader, self).__init__(recordio_reader(filename))


class MultiFileReader(ReaderBase):
    """thread_num threads scan the files concurrently into a shared queue;
    record order across files is nondeterministic, like the reference's
    open_files (open_files_op.cc uses a thread pool the same way)."""

    def __init__(self, filenames, thread_num=1, queue_capacity=64):
        super(MultiFileReader, self).__init__()
        self._filenames = list(filenames)
        self._thread_num = max(1, int(thread_num))
        self._capacity = queue_capacity
        self._gen = 0
        self._threads = []
        self._q = None
        self._died = None  # _ReaderError a worker died with (sticky)

    def _start(self):
        from ..recordio_writer import recordio_reader
        self._q = queue.Queue(self._capacity)
        self._pending_files = list(self._filenames)
        self._lock = threading.Lock()
        self._live = self._thread_num
        self._gen += 1
        gen, q, lock = self._gen, self._q, self._lock

        def worker():
            try:
                while gen == self._gen:
                    with lock:
                        if not self._pending_files:
                            break
                        fname = self._pending_files.pop(0)
                    for rec in recordio_reader(fname)():
                        q.put(rec)
                        if gen != self._gen:
                            return
            except Exception as e:  # bad/corrupt file: surface, don't hang
                _notify_fault(self, e)  # supervisor channel: immediately
                self._died = _ReaderError(e)  # sticky: dead != exhausted
                q.put(_ReaderError(e))
                return
            finally:
                with lock:
                    self._live -= 1
                    if self._live == 0 and gen == self._gen:
                        q.put(_EOF_SENTINEL)

        self._threads = [threading.Thread(target=worker, daemon=True)
                         for _ in range(self._thread_num)]
        for t in self._threads:
            t.start()

    def _next(self):
        if self._q is None:  # lazy start: no thread/file leak if displaced
            self._start()
        # poll with a liveness check: the EOF sentinel is one-shot, and a
        # next_many that hit it mid-block consumed it while pushing its
        # records back — once those drain, a plain q.get() would block
        # forever on the dead workers instead of raising EOF again. This
        # call's queue and threads are pinned in locals: a reset swaps
        # them, and a stale poller must not steal from the new stream
        q, threads = self._q, self._threads
        while True:
            try:
                item = q.get(timeout=0.05)
                break
            except queue.Empty:
                if not any(t.is_alive() for t in threads):
                    if self._died is not None:
                        # a stream killed by a worker ERROR is not
                        # exhausted: re-raise the death, sticky
                        self._died.reraise()
                    raise EOFException()
        if item is _EOF_SENTINEL:
            raise EOFException()
        if isinstance(item, _ReaderError):
            item.reraise()
        return item

    def _stop(self):
        # unblock workers parked on a full queue, then wait them out
        self._gen += 1
        while any(t.is_alive() for t in self._threads):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            for t in self._threads:
                t.join(timeout=0.05)
        self._threads = []
        self._q = None

    def _reset(self):
        if self._threads:
            self._stop()
        self._died = None  # a fresh scan gets a fresh verdict
        # lazy: the next read starts fresh threads

    def close(self):
        super(MultiFileReader, self).close()
        if self._threads:
            self._stop()
        self._died = None


_EOF_SENTINEL = object()


class ShuffleReader(ReaderBase):
    """Reservoir of buffer_size records, yielded in random order
    (parity: create_shuffle_reader_op.cc)."""

    def __init__(self, underlying, buffer_size, seed=0):
        super(ShuffleReader, self).__init__()
        self._under = underlying
        self._size = int(buffer_size)
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._buf = []

    def _fill(self):
        while len(self._buf) < self._size:
            try:
                self._buf.append(self._under.next())
            except EOFException:
                break
        self._rng.shuffle(self._buf)

    def _next(self):
        if not self._buf:
            self._fill()
        if not self._buf:
            raise EOFException()
        return self._buf.pop()

    def _reset(self):
        self._buf = []
        self._rng = np.random.RandomState(self._seed)
        self._under.reset()


class MultiPassReader(ReaderBase):
    """Replays the underlying reader pass_num times
    (parity: create_multi_pass_reader_op.cc)."""

    def __init__(self, underlying, pass_num):
        super(MultiPassReader, self).__init__()
        self._under = underlying
        self._pass_num = int(pass_num)
        self._pass = 0

    def _next(self):
        try:
            return self._under.next()
        except EOFException:
            self._pass += 1
            if self._pass >= self._pass_num:
                raise
            self._under.reset()
            return self._under.next()

    def _reset(self):
        self._pass = 0
        self._under.reset()


class _Staged(object):
    """A record staged on a card: its fields and the event recorded on the
    staging stream behind their copies."""

    __slots__ = ("fields", "event")

    def __init__(self, fields, event):
        self.fields = fields
        self.event = event


def _resolve_place(place):
    """A Place, device string or torch.device -> torch.device (None
    stays None)."""
    if place is None or isinstance(place, torch.device):
        return place
    from ..places import Place
    if isinstance(place, Place):
        place = place.torch_device()
    return torch.device(place)


class DoubleBufferReader(ReaderBase):
    """Async staging: a daemon thread pulls records from the underlying
    reader and parks up to `capacity` staged records in a queue. For a
    card, each field is copied from pinned host memory on the reader's
    own CUDA stream and an event is recorded behind the copies; the
    consumer's current stream waits on that event when it takes the
    record (no host sync), and each field is marked as used on that
    stream, so the staging stream's memory is not reused under it (parity:
    create_double_buffer_reader_op.cc's cudaStream prefetch). With no
    card to stage to (the CPU), records pass through as they are."""

    def __init__(self, underlying, capacity=2, place=None):
        super(DoubleBufferReader, self).__init__()
        self._under = underlying
        self._capacity = max(1, int(capacity))
        self._device = _resolve_place(place)
        self._stream = None
        self._gen = 0
        self._stashed_error = None
        self._died = None  # _ReaderError the worker died with (sticky)
        _live_double_buffers.add(self)
        self._start()

    def ensure_staging_depth(self, k, max_wait=30.0):
        """Grow the staged-record queue to at least k records (no-op when
        already that deep). The multi-step executor calls this with K so
        the worker can pre-stage a WHOLE next K-step block while the
        current block computes. Already-staged records are drained into
        the pending deque first, so nothing is lost or reordered across
        the restart."""
        k = int(k)
        if k <= self._capacity:
            return
        deadline = time.monotonic() + max_wait
        self._gen += 1
        staged = []

        def drain():
            try:
                while True:
                    staged.append(self._q.get_nowait())
            except queue.Empty:
                pass

        while True:
            drain()
            if not self._thread.is_alive():
                break
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                break  # wedged source read: restart anyway
        drain()  # a put completed between the last drain and the join
        for item in staged:
            if item is _EOF_SENTINEL:
                pass  # the restarted worker re-derives EOF from the source
            elif isinstance(item, _ReaderError):
                self._stashed_error = item
            else:
                self._pending.append(self._take(item))
        self._capacity = k
        self._start()

    def pin_place(self, device):
        """Executor io-prepass handoff: stage to the DISPATCH device on
        the worker thread. An explicit constructor place always wins; a
        pin lands on the very next staged record (the worker re-reads
        the target per record), no restart needed."""
        if self._device is None and device is not None:
            self._device = _resolve_place(device)

    def _stage(self, rec):
        dev = self._device
        if dev is None or dev.type != "cuda":
            return rec
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            fields = tuple(
                torch.from_numpy(np.ascontiguousarray(f)).pin_memory().to(
                    dev, non_blocking=True) for f in rec)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(fields, event)

    @staticmethod
    def _take(item):
        """A queue item as the consumer's record: a staged one's fields,
        after the consumer's stream waits on their copies."""
        if not isinstance(item, _Staged):
            return item
        dev = item.fields[0].device if item.fields else None
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(item.event)
            for f in item.fields:
                f.record_stream(stream)
        return item.fields

    def _start(self):
        self._q = queue.Queue(self._capacity)
        self._gen += 1
        gen, q = self._gen, self._q

        def worker():
            while gen == self._gen:
                try:
                    rec = self._under.next()
                except EOFException:
                    q.put(_EOF_SENTINEL)
                    return
                except Exception as e:  # propagate reader errors to next()
                    # the fault channel first: the supervisor hears of the
                    # dying pipeline now, not at the next read
                    _notify_fault(self, e)
                    self._died = _ReaderError(e)  # sticky: dead != EOF
                    q.put(_ReaderError(e))
                    return
                try:
                    item = self._stage(rec)
                except Exception as e:  # a staging failure is a reader
                    _notify_fault(self, e)         # error, not an EOF
                    self._died = _ReaderError(e)
                    q.put(_ReaderError(e))
                    return
                q.put(item)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _next(self):
        if self._stashed_error is not None:
            err, self._stashed_error = self._stashed_error, None
            err.reraise()
        # the same one-shot-sentinel hazard as MultiFileReader._next, and
        # the queue and thread pinned in locals for the same reason
        q, thread = self._q, self._thread
        while True:
            try:
                item = q.get(timeout=0.05)
                break
            except queue.Empty:
                if not thread.is_alive():
                    if self._died is not None:
                        self._died.reraise()
                    raise EOFException()
        if item is _EOF_SENTINEL:
            raise EOFException()
        if isinstance(item, _ReaderError):
            item.reraise()
        return self._take(item)

    def _stop(self, max_wait=None):
        """Stop the worker BEFORE touching the underlying reader: a worker
        blocked in q.put finishes its put once we drain, re-checks the
        generation and exits — so it can never steal a record from the
        freshly reset underlying stream. max_wait bounds the total wait
        (the atexit path must not spin on a worker parked in a blocking
        source read)."""
        deadline = None if max_wait is None else time.monotonic() + max_wait
        self._gen += 1
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if deadline is not None and time.monotonic() > deadline:
                return

    def state_dict(self):
        """Position + staging depth. `consumed` counts records the TRAINER
        got — records the worker pre-staged but nobody read are not
        consumed, so resume replays them instead of losing them."""
        d = super(DoubleBufferReader, self).state_dict()
        d["capacity"] = int(self._capacity)
        return d

    def load_state_dict(self, state):
        """Replay-restore, then re-grow staging to the recorded depth."""
        super(DoubleBufferReader, self).load_state_dict(state)
        self.ensure_staging_depth(int(state.get("capacity",
                                                self._capacity)))

    def _reset(self):
        self._stop()
        # an error ensure_staging_depth stashed belongs to the OLD stream
        self._stashed_error = None
        self._died = None
        self._under.reset()
        self._start()

    def close(self):
        super(DoubleBufferReader, self).close()
        self._stashed_error = None
        self._died = None
        self._stop()


class _ReaderError(object):
    """A worker-thread exception in transit to the consuming thread;
    `reraise` re-raises it WITH its traceback, so the callstack reaches
    into the worker (the frame that actually died). Tagged
    `_reader_fault` so a caller can classify the failure as a reader's
    without string matching."""

    def __init__(self, error):
        self.error = error
        try:
            error._reader_fault = True
        except Exception:
            pass  # exceptions with __slots__: classification degrades only

    def reraise(self):
        raise self.error.with_traceback(self.error.__traceback__)


# Interpreter exit: drain and join every live double buffer first, so no
# daemon worker is parked inside a copy or q.put while CPython tears down.
_live_double_buffers = weakref.WeakSet()


@atexit.register
def _shutdown_double_buffers():
    for r in list(_live_double_buffers):
        try:
            r._stop(max_wait=2.0)
        except Exception:
            pass


def run_host_io_op(op, scope, device=None):
    """Execute a reader-creation op host-side (Executor pre-pass). `read`
    ops are handled separately by the Executor (they inject feeds). A
    double buffer stages to its op's place, else to `device` (the device
    of the run that creates it), from its first record on."""
    out_name = op.outputs["Out"][0]
    if op.type == "create_recordio_file_reader":
        state = RecordIOReader(op.attrs["filename"])
    elif op.type == "open_files":
        state = MultiFileReader(op.attrs["file_names"],
                                op.attrs.get("thread_num", 1))
    else:
        under = scope.get(op.inputs["UnderlyingReader"][0])
        if under is None:
            raise RuntimeError(
                "underlying reader %r not created yet; run the startup "
                "program first" % op.inputs["UnderlyingReader"][0])
        if op.type == "create_shuffle_reader":
            state = ShuffleReader(under, op.attrs["buffer_size"],
                                  seed=op.attrs.get("seed", 0))
        elif op.type == "create_multi_pass_reader":
            state = MultiPassReader(under, op.attrs["pass_num"])
        elif op.type == "create_double_buffer_reader":
            state = DoubleBufferReader(
                under, capacity=op.attrs.get("capacity", 2),
                place=op.attrs.get("__place__") or device)
        else:
            raise KeyError("unknown host io op %r" % op.type)
    old = scope.get(out_name)
    if old is not None and hasattr(old, "close"):
        old.close()  # startup re-run: release the displaced reader's threads
    scope.set(out_name, state)
