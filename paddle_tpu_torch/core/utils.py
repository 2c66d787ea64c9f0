"""Durability primitives shared by the checkpoint writer.

Parity: the JAX package's core/utils.py (`fsync_dir`, `write_bytes_fsync`);
the port keeps its own copy.
"""
import os

__all__ = ["fsync_dir", "write_bytes_fsync"]


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
