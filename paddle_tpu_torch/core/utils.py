"""Durability primitives shared by the checkpoint writer, the cluster plan
and the heartbeats.

Parity: the JAX package's core/utils.py (`fsync_dir`, `write_bytes_fsync`,
`atomic_write_json`); the port keeps its own copy.
"""
import json
import os

__all__ = ["fsync_dir", "write_bytes_fsync", "atomic_write_json"]


def fsync_dir(path):
    """fsync a directory: the step that makes a just-renamed entry durable
    against power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_bytes_fsync(path, data):
    """Write, flush and fsync one file."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def atomic_write_json(path, obj, fsync=False, **dump_kw):
    """Publish a JSON document atomically: serialize, write to a
    pid-suffixed tmp sibling, one os.replace. Readers never see a torn
    document. fsync=True adds the write_bytes_fsync durability step for
    documents that must survive power loss (the cluster plan); liveness
    signals (heartbeats, fired every fraction of a second) skip it. The
    bytes are the JAX package's for the same arguments, so a directory
    written by either package reads in the other."""
    data = json.dumps(obj, **dump_kw).encode("utf-8")
    tmp = "%s.tmp.%d" % (path, os.getpid())
    if fsync:
        write_bytes_fsync(tmp, data)
    else:
        with open(tmp, "wb") as f:
            f.write(data)
    os.replace(tmp, path)
