"""recordio: chunked record files for the data pipeline (the port's copy
of the JAX package's recordio/).

Parity: paddle/fluid/recordio/{writer,scanner,chunk,header} + the
python/paddle/fluid/recordio_writer.py surface. Wire format is identical to
the reference (see native/recordio.cc header comment). The fast path is the
C++ library via ctypes; the pure-Python implementation below produces
byte-identical files and is used when no toolchain is available — both are
covered by the same round-trip tests.

Compressor codes match the reference enum: 0 none, 1 snappy (not built),
2 gzip (zlib).
"""
import ctypes
import struct
import zlib

from ..native import load_library

__all__ = ["Writer", "Scanner", "Compressor", "write_records",
           "read_records"]

_MAGIC = 0x01020304


class Compressor(object):
    NoCompress = 0
    Snappy = 1
    Gzip = 2


def _native():
    lib = load_library("recordio")
    if lib is None:
        return None
    try:
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                        ctypes.c_uint32, ctypes.c_uint64]
        lib.rio_writer_write.restype = ctypes.c_int
        lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint32]
        lib.rio_writer_close.restype = ctypes.c_int
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_scanner_next.restype = ctypes.c_int
        lib.rio_scanner_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.rio_scanner_close.restype = None
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        return lib
    except Exception:
        return None


class Writer(object):
    """Append records (bytes) to a recordio file, chunked + checksummed."""

    def __init__(self, path, compressor=Compressor.NoCompress,
                 max_num_records=1000, max_chunk_bytes=1 << 20,
                 use_native=True):
        self._compressor = compressor
        self._lib = _native() if use_native else None
        if self._lib is not None:
            self._h = self._lib.rio_writer_open(
                path.encode(), compressor, max_num_records, max_chunk_bytes)
            if not self._h:
                raise IOError("cannot open %r for writing" % path)
        else:
            self._f = open(path, "wb")
            self._records = []
            self._nbytes = 0
            self._max_records = max_num_records
            self._max_bytes = max_chunk_bytes

    def write(self, record):
        if isinstance(record, str):
            record = record.encode("utf-8")
        if self._lib is not None:
            if self._lib.rio_writer_write(self._h, record,
                                          len(record)) != 0:
                raise IOError("recordio write failed")
            return
        self._records.append(bytes(record))
        # +4: count the length prefix too, exactly like the native writer,
        # so both implementations flush chunks at identical points
        self._nbytes += len(record) + 4
        if len(self._records) >= self._max_records or \
                self._nbytes >= self._max_bytes:
            self._flush()

    def _flush(self):
        if not self._records:
            return
        payload = b"".join(struct.pack("<I", len(r)) + r
                           for r in self._records)
        comp = self._compressor
        data = payload
        if comp == Compressor.Gzip:
            data = zlib.compress(payload)
        elif comp != Compressor.NoCompress:
            raise NotImplementedError("snappy not built")
        crc = zlib.crc32(data) & 0xFFFFFFFF
        self._f.write(struct.pack("<5I", _MAGIC, len(self._records), crc,
                                  comp, len(data)))
        self._f.write(data)
        self._records = []
        self._nbytes = 0

    def close(self):
        if self._lib is not None:
            if self._h is not None:
                if self._lib.rio_writer_close(self._h) != 0:
                    self._h = None
                    raise IOError("recordio close/flush failed")
                self._h = None
            return
        self._flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner(object):
    """Iterate records (bytes) of a recordio file; validates checksums."""

    def __init__(self, path, use_native=True):
        self._lib = _native() if use_native else None
        if self._lib is not None:
            self._h = self._lib.rio_scanner_open(path.encode())
            if not self._h:
                raise IOError("cannot open %r" % path)
        else:
            self._f = open(path, "rb")
            self._chunk = []
            self._idx = 0

    def __iter__(self):
        return self

    def _load_chunk_py(self):
        hdr = self._f.read(20)
        if len(hdr) == 0:
            return False
        if len(hdr) < 20:
            raise IOError("truncated recordio header")
        magic, num, crc, comp, size = struct.unpack("<5I", hdr)
        if magic != _MAGIC:
            raise IOError("bad recordio magic %x" % magic)
        data = self._f.read(size)
        if len(data) != size:
            raise IOError("truncated recordio chunk")
        if zlib.crc32(data) & 0xFFFFFFFF != crc:
            raise IOError("recordio checksum mismatch")
        if comp == Compressor.Gzip:
            data = zlib.decompress(data)
        elif comp != Compressor.NoCompress:
            raise NotImplementedError("compressor %d" % comp)
        self._chunk = []
        pos = 0
        for _ in range(num):
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            self._chunk.append(data[pos:pos + n])
            pos += n
        self._idx = 0
        return True

    def __next__(self):
        if self._lib is not None:
            data = ctypes.POINTER(ctypes.c_uint8)()
            n = ctypes.c_uint32()
            rc = self._lib.rio_scanner_next(self._h, ctypes.byref(data),
                                            ctypes.byref(n))
            if rc == 0:
                raise StopIteration
            if rc < 0:
                raise IOError("corrupt recordio file")
            return ctypes.string_at(data, n.value)
        while self._idx >= len(self._chunk):
            if not self._load_chunk_py():
                raise StopIteration
        r = self._chunk[self._idx]
        self._idx += 1
        return r

    next = __next__

    def close(self):
        if self._lib is not None:
            if self._h is not None:
                self._lib.rio_scanner_close(self._h)
                self._h = None
            return
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records, **kwargs):
    with Writer(path, **kwargs) as w:
        for r in records:
            w.write(r)


def read_records(path, **kwargs):
    with Scanner(path, **kwargs) as s:
        return list(s)
