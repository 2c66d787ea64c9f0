"""Convert python readers to recordio files and back (the port's copy of
the JAX package's recordio_writer.py).

Parity: python/paddle/fluid/recordio_writer.py
(convert_reader_to_recordio_file). The reference serializes each sample as
feeded LoDTensor protos; here a sample (a tuple of arrays/scalars) is
serialized as a small self-describing binary record (count + per-field numpy
.npy payloads), which round-trips exactly and needs no proto dependency.
"""
import io

import numpy as np

from . import recordio

__all__ = ["convert_reader_to_recordio_file", "recordio_reader"]


def _serialize_sample(sample):
    buf = io.BytesIO()
    fields = sample if isinstance(sample, (tuple, list)) else (sample,)
    buf.write(np.uint32(len(fields)).tobytes())
    for f in fields:
        fbuf = io.BytesIO()
        np.save(fbuf, np.asarray(f), allow_pickle=False)
        raw = fbuf.getvalue()
        buf.write(np.uint32(len(raw)).tobytes())
        buf.write(raw)
    return buf.getvalue()


def _deserialize_sample(record):
    buf = io.BytesIO(record)
    (n,) = np.frombuffer(buf.read(4), dtype=np.uint32)
    fields = []
    for _ in range(int(n)):
        (sz,) = np.frombuffer(buf.read(4), dtype=np.uint32)
        fields.append(np.load(io.BytesIO(buf.read(int(sz))),
                              allow_pickle=False))
    return tuple(fields)


def convert_reader_to_recordio_file(
        filename, reader_creator, feeder=None,
        compressor=recordio.Compressor.Gzip, max_num_records=1000,
        feed_order=None):
    """Write every sample of reader_creator() into `filename`. Returns the
    record count.

    With a `feeder` (DataFeeder), each item from the reader is a minibatch
    (the reference's convert pattern: a paddle.batch-ed reader) and is run
    through feeder.feed() so every record holds one batched array per feed
    var, ordered by `feed_order` (defaults to the feeder's feed list). Dense
    vars only — sequence (lod_level>0) vars have no recordio layout here.
    Without a feeder, samples are serialized directly."""
    count = 0
    if feeder is not None and feed_order is None:
        feed_order = feeder.feed_names
    with recordio.Writer(filename, compressor=compressor,
                         max_num_records=max_num_records) as w:
        for sample in reader_creator():
            if feeder is not None:
                d = feeder.feed(sample)
                fields = []
                for name in feed_order:
                    val = d[name]
                    if not isinstance(val, np.ndarray):
                        raise NotImplementedError(
                            "recordio conversion supports dense feed vars "
                            "only; %r is a sequence (lod_level>0)" % name)
                    fields.append(val)
                sample = tuple(fields)
            w.write(_serialize_sample(sample))
            count += 1
    return count


def recordio_reader(filename):
    """A reader creator over a recordio file written by
    convert_reader_to_recordio_file (the open_recordio_file op equivalent;
    reference: operators/reader/create_recordio_file_reader_op.cc)."""
    def reader():
        with recordio.Scanner(filename) as s:
            for record in s:
                yield _deserialize_sample(record)
    return reader
