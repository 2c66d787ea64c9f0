"""Sharded values: one variable held as per-replica pieces over a mesh.

A ParallelExecutor (parallel/parallel_executor.py) keeps the state its
ShardingPlan splits (ZeRO-style update state, tensor-parallel weights) as
pieces, one per mesh replica, plus the PartitionSpec that cut them: the
counterpart of a jax.Array committed to a NamedSharding. The Scope stores
a ShardedValue as it is and hands every reader (fetch_var, Executor runs,
checkpoint saves, io.save_*, the guards) the global value, assembled on
the first replica's device.

A spec is a tuple with one entry per leading dim: None (not split), an
axis name, or a tuple of axis names (split over their product, the first
axis outermost). Dims past the spec's length are not split. Replicas
whose coordinates agree on every axis the spec names hold the same piece.
"""
import itertools

import torch


def spec_axes(spec):
    """Per-dim tuples of axis names of `spec`."""
    out = []
    for ent in tuple(spec or ()):
        if ent is None:
            out.append(())
        elif isinstance(ent, (list, tuple)):
            out.append(tuple(ent))
        else:
            out.append((ent,))
    return out


def spec_is_sharded(spec):
    return any(spec_axes(spec))


def mesh_coords(mesh):
    """The coordinates ({axis: index}) of each replica, in the mesh's flat
    (row-major) order."""
    names = tuple(mesh.axis_names)
    sizes = [int(mesh.shape[a]) for a in names]
    return [dict(zip(names, c)) for c in itertools.product(
        *[range(s) for s in sizes])]


def piece_index(spec, coords, mesh):
    """(chunk, count) per split dim of the piece a replica at `coords`
    holds under `spec`."""
    idx = []
    for axes in spec_axes(spec):
        chunk, count = 0, 1
        for a in axes:
            n = int(mesh.shape.get(a, 1))
            chunk = chunk * n + int(coords.get(a, 0))
            count *= n
        idx.append((chunk, count))
    return tuple(idx)


def take_piece(full, index):
    """The piece of `full` at `index` (piece_index's form): a view."""
    out = full
    for d, (chunk, count) in enumerate(index):
        if count == 1:
            continue
        size = full.shape[d]
        if size % count:
            raise ValueError(
                "dim %d of size %d does not split evenly %d ways"
                % (d, size, count))
        step = size // count
        out = out.narrow(d, chunk * step, step)
    return out


def assemble_pieces(pieces_by_index, device=None):
    """The global tensor from one piece per distinct index ({index:
    tensor}), concatenated dim by dim, on `device` (default: the first
    piece's)."""
    items = sorted(pieces_by_index.items())
    first = items[0][1]
    device = first.device if device is None else device
    if len(items) == 1:
        return first.to(device)
    ndims = len(items[0][0])

    def build(prefix, d):
        if d == ndims:
            return pieces_by_index[tuple(prefix)].to(device)
        count = items[0][0][d][1]
        parts = [build(prefix + [(c, count)], d + 1) for c in range(count)]
        return parts[0] if count == 1 else torch.cat(parts, dim=d)
    return build([], 0)


class ShardedValue(object):
    """A variable as per-replica pieces: `pieces[i]` is what mesh replica i
    (flat order) holds, on its device; replicas holding the same piece on
    one device share the tensor. `shape` / `dtype` are the global value's.
    """

    __slots__ = ("mesh", "spec", "pieces", "shape", "dtype")

    def __init__(self, mesh, spec, pieces, shape):
        self.mesh = mesh
        self.spec = tuple(spec or ())
        self.pieces = list(pieces)
        self.shape = torch.Size(shape)
        self.dtype = self.pieces[0].dtype

    @classmethod
    def split(cls, mesh, spec, full, devices=None):
        """Cut the global tensor `full` into the pieces of `spec`, each
        moved to its replica's device (`devices`: one per replica, flat
        order; default the mesh's)."""
        devices = list(mesh.devices.flat) if devices is None else devices
        made = {}
        pieces = []
        for coords, dev in zip(mesh_coords(mesh), devices):
            idx = piece_index(spec, coords, mesh)
            key = (idx, str(dev))
            if key not in made:
                piece = take_piece(full, idx)
                # a piece owns its storage: a view would keep the whole
                # global tensor alive beside the pieces
                made[key] = piece.clone() if piece.device == torch.device(
                    dev) else piece.to(dev).contiguous()
            pieces.append(made[key])
        return cls(mesh, spec, pieces, full.shape)

    def by_index(self):
        """{piece index: the first replica's tensor of that index}."""
        out = {}
        for coords, p in zip(mesh_coords(self.mesh), self.pieces):
            out.setdefault(piece_index(self.spec, coords, self.mesh), p)
        return out

    def assemble(self, device=None):
        """The global value (a new tensor unless unsplit), on `device`
        (default: replica 0's)."""
        return assemble_pieces(self.by_index(),
                               self.pieces[0].device if device is None
                               else device)

    def __repr__(self):
        return "ShardedValue(shape=%s, spec=%r, %d replicas)" % (
            tuple(self.shape), self.spec, len(self.pieces))
