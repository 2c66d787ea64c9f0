"""ctypes binding for liblodpack (a copy of the JAX package's
lodpack.py, less its unused unpack): the padded-dense LoD layout
conversion, native.

Not wired into the feed path yet: core/lod.py LoDTensor.to_padded pads
with its numpy loop, since no run has timed the padding at a real feed
size (PERF.md section 7). pack_into returns False when the native library
is unavailable or the arrays aren't native-packable.
"""
import ctypes

import numpy as np

from . import load_library

__all__ = ["available", "pack_into"]


def _lib():
    lib = load_library("lodpack")
    if lib is None:
        return None
    if not getattr(lib, "_lodpack_ready", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ptpu_lod_pack.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
        lib.ptpu_lod_pack.restype = ctypes.c_int
        lib._lodpack_ready = True
    return lib


def available():
    return _lib() is not None


def pack_into(data, offs, out):
    """Pack flat ragged `data` (row offsets `offs`, len n_seqs+1) into the
    pre-zeroed padded array `out` [n_seqs, max_len, *feat]. Returns True
    when the native path ran; False -> caller must use its fallback."""
    lib = _lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    if not out.flags["C_CONTIGUOUS"] or data.dtype != out.dtype \
            or out.dtype.hasobject:
        return False  # object dtypes hold PyObject*; memcpy would corrupt
    n_seqs, max_len = out.shape[0], out.shape[1]
    row_bytes = int(np.prod(out.shape[2:], dtype=np.int64)) * out.itemsize
    offs_arr = np.ascontiguousarray(np.asarray(offs, dtype=np.int64))
    if offs_arr.shape != (n_seqs + 1,):
        return False  # C loop indexes offs[0..n_seqs]; never read past it
    rc = lib.ptpu_lod_pack(
        data.ctypes.data_as(ctypes.c_char_p),
        offs_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_seqs), ctypes.c_int64(data.shape[0]),
        ctypes.c_int64(max_len),
        ctypes.c_int64(row_bytes), out.ctypes.data_as(ctypes.c_char_p))
    return rc == 0
