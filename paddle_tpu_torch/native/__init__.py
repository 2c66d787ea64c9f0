"""Native (C++) host pieces of the data path, loaded with ctypes.

Parity: the reference keeps its data path native (paddle/fluid/recordio/
*.cc), and so does the JAX package (its native/). The port keeps its own
copies of recordio.cc and lodpack.cc here. Each builds at first use with
one `g++ -shared` call into `paddle_tpu_torch/_build/` (named by a digest
of its source, written under a temporary name and renamed, so concurrent
processes never load half a file). The recordio reader and writer keep
the JAX package's pure-Python path beside it, byte for byte the same,
used when no toolchain is available; lodpack has no caller yet
(native/lodpack.py).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["load_library"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# library name -> (source, extra link flags)
_SOURCES = {"recordio": ("recordio.cc", ("-lz",)),
            "lodpack": ("lodpack.cc", ())}
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIBS = {}
_lock = threading.Lock()


def _library_path(name):
    """Where lib<name> is (or will be) built: `_build/lib<name>_<digest of
    its source and flags>.so`."""
    src, ldflags = _SOURCES[name]
    h = hashlib.sha256(" ".join(CXXFLAGS + ldflags).encode())
    with open(os.path.join(_DIR, src), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name,
                                                     h.hexdigest()[:16]))


def _build(name, path):
    src, ldflags = _SOURCES[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS,
                        os.path.join(_DIR, src), "-o", tmp, *ldflags],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library(name):
    """dlopen lib<name> (building it first when missing). Returns None on
    any failure: the caller then takes its pure-Python path."""
    with _lock:
        if name in _LIBS:
            return _LIBS[name]
        path = _library_path(name)
        lib = None
        try:
            if not os.path.exists(path):
                _build(name, path)
            lib = ctypes.CDLL(path)
        except Exception:
            lib = None
        _LIBS[name] = lib
        return lib
