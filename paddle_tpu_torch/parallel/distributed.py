"""Multi-process glue: torch.distributed over the reference's cluster
environment contract, and DeviceLayout, the description of one cohort.

Parity: the JAX package's parallel/distributed.py, which forms the
jax.distributed process group from the same environment. Env contract
(reference names first, torch-standard fallbacks):
  TRAINERS / WORLD_SIZE          — number of processes in the job
  TRAINER_ID / RANK              — this process's rank
  PADDLE_COORDINATOR / MASTER_ADDR:MASTER_PORT — "host:port" of rank 0

A world of one needs no process group: init_distributed() is then a
no-op, as the JAX one is. A ParallelExecutor is one controller over the
mesh of its own process's devices; the process group is what a job of
several such controllers rendezvouses on.

`DeviceLayout` is one cohort shape (process count, rank, local device
count, mesh axes, the weight-update sharding axis): it round-trips JSON
(checkpoint metadata) and `local_mesh()` builds the mesh this process
trains on, the target `CheckpointManager.restore(layout=)` and
`Supervisor(restore_layout=)` reshard onto.
"""
import os

import torch

from .mesh import default_devices, make_mesh

__all__ = ["init_distributed", "is_initialized", "shutdown_distributed",
           "global_mesh", "process_count", "process_index",
           "local_device_count", "global_device_count",
           "DeviceLayout", "active_layout", "set_active_layout"]

# _noop: a single-process init_distributed() ran (nothing to rendezvous).
# _client: torch.distributed.init_process_group joined a process group.
_noop = False
_client = False
# the process's current cohort shape; shutdown_distributed drops it
_layout = None


def _local_devices():
    """This process's devices: every CUDA device, else the CPU once."""
    if torch.cuda.is_available():
        return default_devices()
    return [torch.device("cpu")]


class DeviceLayout(object):
    """One cohort shape: `num_processes` processes, this one at
    `process_index`, each using `local_device_count` devices with
    `mesh_axes` laid over them. `shard_axis` names the mesh axis the
    ShardingPlan splits the weight update over (None: the batch axis).
    `skip_local_devices` lists local device indices not to use.

    `devices` (not serialized) lists the devices `local_mesh()` draws
    from, a device repeated for replicas that share it; default every
    local CUDA device, else the CPU once."""

    __slots__ = ("num_processes", "process_index", "local_device_count",
                 "mesh_axes", "batch_axis", "shard_axis",
                 "skip_local_devices", "devices")

    def __init__(self, num_processes=1, process_index=0,
                 local_device_count=None, mesh_axes=None, batch_axis="dp",
                 shard_axis=None, skip_local_devices=None, devices=None):
        self.num_processes = int(num_processes)
        self.process_index = int(process_index)
        if not (0 <= self.process_index < self.num_processes):
            raise ValueError(
                "process_index %d outside [0, %d)" % (self.process_index,
                                                      self.num_processes))
        self.local_device_count = (None if local_device_count is None
                                   else int(local_device_count))
        self.mesh_axes = dict(mesh_axes) if mesh_axes else {batch_axis: -1}
        self.batch_axis = batch_axis
        if shard_axis is not None and shard_axis not in self.mesh_axes:
            raise ValueError(
                "shard_axis %r is not one of the layout's mesh axes %r"
                % (shard_axis, sorted(self.mesh_axes)))
        self.shard_axis = shard_axis
        self.skip_local_devices = tuple(
            sorted(set(int(i) for i in (skip_local_devices or ()))))
        self.devices = None if devices is None else list(devices)

    @property
    def total_device_count(self):
        if self.local_device_count is None:
            return None
        return self.num_processes * self.local_device_count

    def resolved_local_device_count(self):
        return (self.local_device_count if self.local_device_count
                is not None
                else len(self._all_devices()) - len(self.skip_local_devices))

    def _all_devices(self):
        return self.devices if self.devices is not None \
            else _local_devices()

    def local_devices(self):
        """This process's usable devices in index order: every device
        minus the quarantined indices."""
        skip = set(self.skip_local_devices)
        return [d for i, d in enumerate(self._all_devices())
                if i not in skip]

    def local_mesh(self):
        """The Mesh over this process's devices. With fewer usable devices
        than the layout asks for, raises: a silently smaller mesh would
        break the cohort's divisibility contract."""
        want = self.resolved_local_device_count()
        devices = self.local_devices()
        if len(devices) < want or want < 1:
            raise ValueError(
                "DeviceLayout wants %d local devices but only %d usable "
                "(%d quarantined) (pass DeviceLayout(devices=[d] * n) for "
                "replicas that share a device)"
                % (want, len(devices), len(self.skip_local_devices)))
        return make_mesh(self.mesh_axes, devices[:want])

    def resolved_shard_axis(self):
        return self.shard_axis if self.shard_axis is not None \
            else self.batch_axis

    def to_json(self):
        out = {"num_processes": self.num_processes,
               "process_index": self.process_index,
               "local_device_count": self.local_device_count,
               "mesh_axes": dict(self.mesh_axes),
               "batch_axis": self.batch_axis,
               "shard_axis": self.shard_axis}
        if self.skip_local_devices:
            out["skip_local_devices"] = list(self.skip_local_devices)
        return out

    @classmethod
    def from_json(cls, d, devices=None):
        return cls(num_processes=d.get("num_processes", 1),
                   process_index=d.get("process_index", 0),
                   local_device_count=d.get("local_device_count"),
                   mesh_axes=d.get("mesh_axes"),
                   batch_axis=d.get("batch_axis", "dp"),
                   shard_axis=d.get("shard_axis"),
                   skip_local_devices=d.get("skip_local_devices"),
                   devices=devices)

    def __eq__(self, other):
        return isinstance(other, DeviceLayout) \
            and self.to_json() == other.to_json()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return ("DeviceLayout(procs=%d, rank=%d, local_devices=%s, "
                "axes=%r%s%s)" % (
                    self.num_processes, self.process_index,
                    self.local_device_count, self.mesh_axes,
                    ", shard_axis=%r" % self.shard_axis
                    if self.shard_axis is not None else "",
                    ", quarantined=%r" % list(self.skip_local_devices)
                    if self.skip_local_devices else ""))


def active_layout():
    """The cohort shape this process trains under, or None."""
    return _layout


def set_active_layout(layout):
    """Install `layout` (a DeviceLayout or None); returns the previous."""
    global _layout
    if layout is not None and not isinstance(layout, DeviceLayout):
        raise TypeError("set_active_layout wants a DeviceLayout or None, "
                        "got %r" % (layout,))
    old = _layout
    _layout = layout
    return old


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _env_coordinator():
    addr = os.environ.get("PADDLE_COORDINATOR")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return "%s:%s" % (host, port) if host and port else None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Join the multi-process group (no-op for a world of one).

    Arguments fall back to the env contract above. The group forms over
    torch.distributed.init_process_group("tcp://<coordinator>"), with
    the NCCL backend when this process has a CUDA device, else gloo.
    Returns True when a group was joined. After shutdown_distributed()
    a fresh call joins a new group; a call while one is live is a no-op
    returning False."""
    global _noop, _client
    if _client:
        return False
    coordinator_address = coordinator_address or _env_coordinator()
    num_processes = num_processes if num_processes is not None else \
        _env_int("TRAINERS", "WORLD_SIZE")
    process_id = process_id if process_id is not None else \
        _env_int("TRAINER_ID", "RANK")
    if not coordinator_address and num_processes in (None, 1):
        _noop = True
        return False
    if not coordinator_address:
        raise ValueError(
            "multi-process job (TRAINERS=%r) needs a coordinator: set "
            "PADDLE_COORDINATOR=host:port of rank 0 (or pass "
            "coordinator_address)" % (num_processes,))
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes if num_processes is not None else 1),
        rank=int(process_id or 0))
    _client = True
    return True


def is_initialized():
    return _noop or _client


def shutdown_distributed():
    """Leave the process group and drop the active DeviceLayout.
    Idempotent."""
    global _noop, _client, _layout
    if _client:
        import torch.distributed as dist
        dist.destroy_process_group()
        _client = False
    _noop = False
    _layout = None


def process_count():
    if _client:
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


def process_index():
    if _client:
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def local_device_count():
    return len(_local_devices())


def global_device_count():
    return process_count() * local_device_count()


def global_mesh(axes=None, devices=None):
    """A Mesh over this process's devices (default {'dp': -1})."""
    axes = axes or {"dp": -1}
    devices = list(devices) if devices is not None else _local_devices()
    return make_mesh(axes, devices)
