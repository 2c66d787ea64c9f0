"""Device meshes over torch devices.

Parity: the JAX package's parallel/mesh.py (make_mesh, data_parallel_mesh,
replicated, batch_sharded), whose Mesh is a jax.sharding.Mesh. Here a Mesh
is an n-d array of torch.devices with named axes, and a device may appear
more than once: make_mesh({"dp": 2}, ["cuda:0", "cuda:0"]) is a mesh of two
replicas that share one card (and ["cpu"] * 8 the CPU tests' 8-replica
mesh, the counterpart of the JAX tests' virtual devices). The replicas of
a mesh are its positions; the ParallelExecutor runs the step on each of
them and combines their values with torch ops on a shared device, or with
single-process NCCL (torch.cuda.nccl) across cards.

Axis conventions, as in the JAX package:
  dp — data parallel (batch dim)
  tp / mp — tensor parallel (weight dims)
  sp — sequence parallel (fused_attention's ring or Ulysses exchange)
  zero — a dedicated weight-update sharding axis (ShardingPlan.shard_axis)
"""
import collections
import numbers

import numpy as np
import torch

__all__ = ["make_mesh", "data_parallel_mesh", "replicated", "batch_sharded",
           "default_devices", "Mesh", "NamedSharding", "P"]


class P(tuple):
    """A PartitionSpec: one entry per leading dim, None (not split), an axis
    name, or a tuple of axis names (parity: jax.sharding.PartitionSpec)."""

    def __new__(cls, *parts):
        return super(P, cls).__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self)
                                    if len(self) != 1
                                    else "(%r,)" % (self[0],))


class Mesh(object):
    """Named axes over an n-d array of torch.devices (parity:
    jax.sharding.Mesh's surface: `devices`, `axis_names`, `shape`)."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        for i, d in enumerate(flat):
            arr.flat[i] = d
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError("mesh of rank %d with axes %r"
                             % (arr.ndim, self.axis_names))

    @property
    def shape(self):
        return collections.OrderedDict(
            (a, int(s)) for a, s in zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def distinct_devices(self):
        """The mesh's devices, each once, in first-appearance order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __eq__(self, other):
        return isinstance(other, Mesh) and \
            self.axis_names == other.axis_names and \
            self.devices.shape == other.devices.shape and \
            all(a == b for a, b in zip(self.devices.flat,
                                       other.devices.flat))

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat)))

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (dict(self.shape),
                                         [str(d) for d in self.devices.flat])


class NamedSharding(object):
    """A spec over a mesh (parity: jax.sharding.NamedSharding)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*tuple(spec or ()))

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            self.mesh == other.mesh and self.spec == other.spec

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (dict(self.mesh.shape), self.spec)


def default_devices():
    """Every local CUDA device; raises when there is none (the CPU is
    asked for explicitly: devices=["cpu"] * n)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch meshes span the CUDA devices unless given "
            "devices=, and torch.cuda.is_available() is False here; pass "
            "devices=['cpu'] * n for an n-replica mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes, devices=None):
    """axes: dict axis_name -> size (use -1 once for 'remaining devices').
    devices: a list of torch devices (or their names), a device repeated
    for replicas that share it; default every local CUDA device."""
    devices = list(devices) if devices is not None else default_devices()
    try:
        sizes = {k: int(v) for k, v in dict(axes).items()
                 if isinstance(v, numbers.Integral)}
        ok = len(sizes) == len(dict(axes))
    except (TypeError, ValueError):
        ok = False
    if not ok:
        raise TypeError(
            "make_mesh expects {axis_name: size} (e.g. {'dp': -1} or "
            "{'dp': 4, 'mp': 2}), got %r" % (axes,))
    if any(s < 1 and s != -1 for s in sizes.values()) \
            or list(sizes.values()).count(-1) > 1:
        raise ValueError("make_mesh: axis sizes must be positive, with at "
                         "most one -1 wildcard; got %r" % (axes,))
    known = int(np.prod([s for s in sizes.values() if s != -1]))
    if any(v == -1 for v in sizes.values()) and known > len(devices):
        raise ValueError(
            "make_mesh: fixed axes in %r already need %d devices but only "
            "%d are available, leaving none for the -1 wildcard"
            % (axes, known, len(devices)))
    for k, v in sizes.items():
        if v == -1:
            sizes[k] = len(devices) // known
    names = tuple(sizes)
    shape = tuple(sizes[n] for n in names)
    total = int(np.prod(shape))
    if any(s < 1 for s in shape) or len(devices) < total:
        raise ValueError(
            "make_mesh: axes %r need %d devices but only %d are available "
            "(list a device more than once for replicas that share it, "
            "e.g. devices=['cpu'] * %d)"
            % (dict(zip(names, shape)), total, len(devices), total))
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(shape), names)


def data_parallel_mesh(num_devices=None, devices=None):
    devices = list(devices) if devices is not None else default_devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return make_mesh({"dp": len(devices)}, devices)


def replicated(mesh):
    return NamedSharding(mesh, P())


def batch_sharded(mesh, ndim, axis_name="dp", batch_dim=0):
    spec = [None] * ndim
    spec[batch_dim] = axis_name
    return NamedSharding(mesh, P(*spec))
