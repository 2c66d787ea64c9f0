"""Reader decorators: composable python data pipelines.

Parity: python/paddle/v2/reader/decorator.py (map_readers, shuffle, chain,
compose, buffered, firstn, xmap_readers) + python/paddle/v2/minibatch.py
(batch), and the JAX package's reader module, copied here so that the
port imports none of it. A *reader creator* is a zero-arg callable
returning an iterable of samples; decorators wrap creators into new
creators. `batch` + `buffered` keep batches flowing to the feed while the
card runs the previous step.
"""
import itertools
import queue as _queue
import random
import threading

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "batch", "skip",
           "ComposeNotAligned"]


class ComposeNotAligned(ValueError):
    pass


class _ReaderError(object):
    """Exception captured on a worker thread, re-raised in the consumer."""

    def __init__(self, exc):
        self.exc = exc


def map_readers(func, *readers):
    """Creator yielding func(s1, s2, ...) over zipped samples of readers."""
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)
    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of buf_size samples."""
    def data_reader():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b
    return data_reader


def chain(*readers):
    """Concatenate readers back to back."""
    def reader():
        for r in readers:
            for s in r():
                yield s
    return reader


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a, (b, c)) -> (a, b, c).

    check_alignment (default True): raise ComposeNotAligned if the readers
    end at different lengths.
    """
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError("unexpected kwargs %r" % list(kwargs))

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
            return
        for outputs in itertools.zip_longest(*rs):
            if any(o is None for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def buffered(reader, size):
    """Prefetch up to `size` samples on a background thread (the host-side
    half of input/compute overlap; device double-buffering is in
    DataFeeder)."""
    end = object()

    def read_worker(r, q):
        try:
            for d in r:
                q.put(d)
            q.put(end)
        except BaseException as e:  # propagate to the consumer, don't truncate
            q.put(_ReaderError(e))

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            if isinstance(e, _ReaderError):
                raise e.exc
            yield e
            e = q.get()
    return data_reader


def firstn(reader, n):
    """Limit to the first n samples."""
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return firstn_reader


def skip(reader, n):
    """Drop the first n samples of the FIRST iteration only — the
    host-pipeline half of checkpoint resume. In-graph readers restore
    their position via `ReaderBase.load_state_dict` (deterministic
    replay); a host feeding loop resumes the same way by wrapping its
    creator in `skip(creator, batches_consumed)` so the post-resume
    stream starts exactly where the checkpointed run stopped.
    Deterministic creators (seeded shuffle, file readers) replay
    bit-identically. Later iterations (the NEXT epochs of a multi-pass
    loop) yield the full stream — only the resume epoch is partial."""
    state = {"pending": int(n)}

    def skip_reader():
        it = reader()
        pending, state["pending"] = state["pending"], 0
        for _ in range(pending):
            try:
                next(it)
            except StopIteration:
                return
        for item in it:
            yield item
    return skip_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply mapper over samples with process_num worker threads.

    order=True preserves input order (reference: order_read_worker path).
    """
    in_end = object()
    out_end = object()

    def read_worker(q):
        try:
            for i, s in enumerate(reader()):
                q.put((i, s))
        except BaseException as e:
            q.put(_ReaderError(e))
        finally:
            for _ in range(process_num):
                q.put(in_end)

    def handle_worker(in_q, out_q):
        try:
            item = in_q.get()
            while item is not in_end and not isinstance(item, _ReaderError):
                i, s = item
                out_q.put((i, mapper(s)))
                item = in_q.get()
            if isinstance(item, _ReaderError):
                out_q.put(item)
        except BaseException as e:
            out_q.put(_ReaderError(e))
        finally:
            out_q.put(out_end)

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        t = threading.Thread(target=read_worker, args=(in_q,))
        t.daemon = True
        t.start()
        workers = []
        for _ in range(process_num):
            w = threading.Thread(target=handle_worker, args=(in_q, out_q))
            w.daemon = True
            w.start()
            workers.append(w)
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is out_end:
                finished += 1
                continue
            if isinstance(item, _ReaderError):
                raise item.exc
            i, mapped = item
            if not order:
                yield mapped
                continue
            pending[i] = mapped
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
        # drain any stragglers kept for ordering
        for i in sorted(pending):
            yield pending[i]
    return xreader


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (paddle.batch parity)."""
    def batch_reader():
        b = []
        for s in reader():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader
