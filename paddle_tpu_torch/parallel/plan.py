"""ShardingPlan: the distribution of a Program's state over a mesh as
one compile-time object.

Parity: the JAX package's parallel/plan.py, whose partitioner this module
copies rule for rule, so the two packages build byte-identical plans
(`to_json()`, `digest()`) for the same program bytes and mesh axes. Every
param, gradient and optimizer accumulator gets a PartitionSpec; the port's
ParallelExecutor realizes them with collectives written by hand where the
JAX package lets GSPMD insert them: a sharded var lives as per-replica
pieces between steps (core/sharded.py), a ZeRO-placed param is
all-gathered at the step's entry, its gradient summed over the batch axis
and cut to the owner's shard, and its update run on the shard
(arXiv:2004.13336); a tensor-parallel "gather"-placed param and its
accumulators are gathered at entry, every contraction and the update run
on full arrays (bit-identical to the replicated run), and the new values
cut back to their shards at the step's end.

The partitioner rule: shard dim 0 of a value over `shard_axis` when the
axis size divides it (and the value has at least axis-size elements),
else replicate with the reason logged. Accumulators follow their owner
param (program._accumulator_owner first, the longest-name pattern as the
fallback). Precedence per var: explicit overrides (`param_shardings`) >
ParamAttr(mesh_axes=) > the tensor-parallel per-family rule (tp_axis=,
by the param's consumer ops: the matmul family column- then row-parallel,
embeddings vocab-parallel, convs output-channel-parallel) > the ZeRO rule
(shard_update=True) > replicated. Under `tp_placement="compute"`
(Megatron partial products) a tensor-parallel param and its accumulators
stay on their pieces through the step: the products that read it run a
piece at a time and its update runs on the pieces.
"""
import hashlib
import json
import logging

import numpy as np

from .mesh import NamedSharding, P

__all__ = ["ShardingPlan", "VarPlan", "PLAN_FORMAT_VERSION"]

log = logging.getLogger("paddle_tpu_torch.parallel.plan")

# v2: intra-layer tensor-parallel specs (tp_axis in the JSON form, 2D
# specs from the per-family auto rule); the JAX package's version
PLAN_FORMAT_VERSION = 2

TP_PLACEMENTS = ("gather", "compute")

# entry kinds
PARAM = "param"
ACCUMULATOR = "accumulator"
OPTIMIZER_GLOBAL = "optimizer_global"
GRADIENT = "gradient"


def _match_accumulator_param(vname, params_by_len_desc):
    """Fallback accumulator->param attribution by the naming convention
    "<acc>_<param>_<n>" when program._accumulator_owner has no entry.
    params_by_len_desc must be sorted longest-first so `fc.w` never claims
    `my_fc.w`'s accumulator."""
    import re
    return next(
        (p for p in params_by_len_desc
         if re.search(r"(^|_)%s(_\d+)?$" % re.escape(p), vname)),
        None)


# The known op set the auto tensor-parallel rule covers, in precedence
# order (a param consumed by several families takes the first match):
# (family, {(op_type, input slot), ...}) — the slot is where the WEIGHT
# rides, so an activation feeding a matmul's "X" never matches.
_TP_FAMILIES = (
    ("matmul", frozenset({("mul", "Y"), ("matmul", "Y")})),
    ("embedding", frozenset({("lookup_table", "W")})),
    ("conv", frozenset({("conv2d", "Filter"),
                        ("depthwise_conv2d", "Filter"),
                        ("conv2d_transpose", "Filter")})),
)


def _param_consumers(program):
    """{var name: set of (op_type, input_slot)} over every forward op of
    every block. grad_of ops are skipped: they replay the forward's
    inputs, and double-counting them could not change a family match."""
    cons = {}
    for block in program.blocks:
        for op in block.ops:
            if op.type == "grad_of":
                continue
            for slot, names in op.inputs.items():
                for n in names:
                    if n:
                        cons.setdefault(n, set()).add((op.type, slot))
    return cons


def _auto_tp_spec(name, shape, consumers, tp_axis, n_tp):
    """The per-family tensor-parallel assignment for one param, or
    (None, reason) when no family rule places it (caller falls through
    to the ZeRO rule / replicated). Pure function of
    (name, shape, consumer set, axis, size) — deterministic, so the
    plan digest is restart-stable like the rest of the partitioner."""
    shape = tuple(shape or ())
    uses = consumers.get(name, ())
    family = next((fam for fam, sigs in _TP_FAMILIES
                   if any(u in sigs for u in uses)), None)
    if family is None:
        return None, "no tensor-parallel family consumes it"
    if any(d is None or d < 0 for d in shape):
        return None, "%s family but no concrete shape" % family

    def divides(d):
        return d % n_tp == 0

    if family == "matmul" and len(shape) == 2:
        if divides(shape[1]):
            return P(None, tp_axis), ("column-parallel: matmul out dim "
                                      "%d / %d over %r"
                                      % (shape[1], n_tp, tp_axis))
        if divides(shape[0]):
            return P(tp_axis, None), ("row-parallel: matmul in dim "
                                      "%d / %d over %r"
                                      % (shape[0], n_tp, tp_axis))
        return None, ("matmul dims %r: %d divides neither -> replicated"
                      % (shape, n_tp))
    if family == "embedding" and len(shape) == 2:
        if divides(shape[0]):
            return P(tp_axis, None), ("vocab-parallel: embedding dim0 "
                                      "%d / %d over %r"
                                      % (shape[0], n_tp, tp_axis))
        if divides(shape[1]):
            return P(None, tp_axis), ("embedding-dim-parallel: dim1 "
                                      "%d / %d over %r"
                                      % (shape[1], n_tp, tp_axis))
        return None, ("embedding dims %r: %d divides neither -> "
                      "replicated" % (shape, n_tp))
    if family == "conv" and len(shape) == 4:
        if divides(shape[0]):
            return P(tp_axis, None, None, None), (
                "output-channel-parallel: conv out_c %d / %d over %r"
                % (shape[0], n_tp, tp_axis))
        return None, ("conv out_c %d %% %d != 0 -> replicated"
                      % (shape[0], n_tp))
    return None, ("%s family but unexpected rank %d -> replicated"
                  % (family, len(shape)))


def _spec_to_json(spec):
    """PartitionSpec -> JSON list (str | [str, ...] | None per dim)."""
    out = []
    for p in tuple(spec):
        if isinstance(p, (list, tuple)):
            out.append([str(a) for a in p])
        else:
            out.append(None if p is None else str(p))
    return out


def _spec_from_json(spec):
    """Inverse of _spec_to_json: JSON list -> plain per-dim tuple of axis
    names / axis tuples / None. Deliberately NOT a PartitionSpec — this
    feeds analysis.PlanView, which must work on machines that cannot
    build the plan's mesh (linting an 8-chip plan on a 1-CPU box)."""
    out = []
    for p in spec:
        if isinstance(p, (list, tuple)):
            out.append(tuple(str(a) for a in p))
        else:
            out.append(None if p is None else str(p))
    return tuple(out)


def _spec_shard_factor(spec, mesh):
    """How many ways `spec` splits a value over `mesh` (the per-chip
    memory divisor): product of the sizes of every mesh axis the spec
    uses."""
    factor = 1
    for ent in tuple(spec):
        axes = ent if isinstance(ent, (list, tuple)) else (
            () if ent is None else (ent,))
        for a in axes:
            factor *= int(mesh.shape.get(a, 1))
    return factor


def _dtype_bytes(dtype):
    try:
        from ..core.framework import convert_dtype
        return int(np.dtype(convert_dtype(dtype)).itemsize)
    except Exception:  # noqa: BLE001 — unknown dtype prices as f32
        return 4


class VarPlan(object):
    """One variable's assignment: its PartitionSpec over the mesh, what
    kind of state it is, which param owns it (accumulators), whether the
    caller pinned it (override), and WHY the partitioner chose this
    spec."""

    __slots__ = ("name", "spec", "kind", "owner", "override", "reason",
                 "shape", "dtype")

    def __init__(self, name, spec, kind, owner=None, override=False,
                 reason="", shape=None, dtype=None):
        self.name = name
        self.spec = spec
        self.kind = kind
        self.owner = owner
        self.override = bool(override)
        self.reason = reason
        self.shape = None if shape is None else tuple(shape)
        self.dtype = dtype

    @property
    def sharded(self):
        return any(p is not None for p in tuple(self.spec))

    def to_json(self):
        d = {"spec": _spec_to_json(self.spec), "kind": self.kind}
        if self.owner is not None:
            d["owner"] = self.owner
        if self.override:
            d["override"] = True
        if self.reason:
            d["reason"] = self.reason
        return d

    def __repr__(self):
        return "VarPlan(%r, %r, %s%s)" % (
            self.name, tuple(self.spec), self.kind,
            ", override" if self.override else "")


class ShardingPlan(object):
    """The explicit compile-time distribution plan one ParallelExecutor
    dispatch runs under. Build with `ShardingPlan.build(program, mesh)`
    (the deterministic partitioner) or construct directly from entries.

    `batch_axis` shards activations (feeds split on their batch dim);
    `shard_axis` shards the weight update — params, grads and optimizer
    accumulators split dim 0 over it (ZeRO-style). They default to the
    same mesh axis ('dp'): reduce-scatter lands each gradient shard on
    the replica that owns the matching param shard."""

    def __init__(self, mesh, entries=(), batch_axis="dp", shard_axis=None,
                 tp_axis=None, tp_placement="gather"):
        self.mesh = mesh
        self.batch_axis = batch_axis
        # an EXPLICIT shard_axis/tp_axis must name a real mesh axis — a
        # typo would silently partition nothing (size-1 default) and the
        # user would discover the full replicated footprint at OOM. The
        # batch-axis fallback stays lenient: a mesh without the batch
        # axis legitimately means "no update sharding here" (size 1).
        if shard_axis is not None and shard_axis not in mesh.axis_names:
            raise ValueError(
                "shard_axis %r is not an axis of mesh %r"
                % (shard_axis, dict(mesh.shape)))
        if tp_axis is not None and tp_axis not in mesh.axis_names:
            raise ValueError(
                "tp_axis %r is not an axis of mesh %r"
                % (tp_axis, dict(mesh.shape)))
        if tp_placement not in TP_PLACEMENTS:
            raise ValueError("tp_placement must be one of %r, got %r"
                             % (TP_PLACEMENTS, tp_placement))
        self.shard_axis = shard_axis if shard_axis is not None \
            else batch_axis
        self.tp_axis = tp_axis
        self.tp_placement = tp_placement
        self.entries = {}
        for e in entries:
            self.entries[e.name] = e

    # ------------------------------------------------------------ build --
    @classmethod
    def build(cls, program, mesh, batch_axis="dp", shard_axis=None,
              shard_update=False, overrides=None, tp_axis=None,
              tp_placement="gather"):
        """Deterministic partitioner over `program`'s persistable state.

        Precedence per var: explicit `overrides` (any var name ->
        PartitionSpec — the executor's `param_shardings` arg) >
        `ParamAttr(mesh_axes=...)` annotations (accumulators follow their
        annotated owner) > the automatic tensor-parallel per-family rule
        (only with `tp_axis=` set — see _auto_tp_spec) > the automatic
        ZeRO assignment (only with `shard_update=True`) > replicated.
        Params are walked in sorted-name order and every decision
        depends only on (name, shape, consumer ops, mesh axes), so the
        plan — and with it its digest — is identical across
        process restarts (see the canonical-order contract in
        optimizer.py / core/backward.py for why the program bytes are
        too).

        A param no rule can split evenly falls back to replicated with
        a logged reason — never an error: the plan must accept any
        program, partial sharding is still a win.
        """
        if shard_axis is not None and shard_axis not in mesh.axis_names:
            # same guard as __init__: an explicit axis must exist
            raise ValueError(
                "shard_axis %r is not an axis of mesh %r"
                % (shard_axis, dict(mesh.shape)))
        if tp_axis is not None and tp_axis not in mesh.axis_names:
            raise ValueError(
                "tp_axis %r is not an axis of mesh %r"
                % (tp_axis, dict(mesh.shape)))
        shard_axis = shard_axis if shard_axis is not None else batch_axis
        overrides = dict(overrides or {})
        n_shard = int(mesh.shape.get(shard_axis, 1))
        n_tp = int(mesh.shape.get(tp_axis, 1)) if tp_axis else 1
        consumers = _param_consumers(program) if tp_axis else {}
        entries = []
        taken = set()

        params = {p.name: p for p in
                  program.global_block().all_parameters()}

        def _annotation_spec(p):
            axes = getattr(p, "mesh_axes", None)
            if not axes:
                return None
            resolved = [a if a in mesh.axis_names else None for a in axes]
            if all(a is None for a in resolved):
                # annotation names no axis of THIS mesh: a no-op, the
                # same model definition reused on a dp-only mesh keeps
                # its ZeRO sharding instead of degrading to replication
                return None
            return P(*resolved)

        def _auto_spec(name, shape):
            tp_reason = ""
            if tp_axis is not None and n_tp > 1:
                spec, tp_reason = _auto_tp_spec(name, shape, consumers,
                                                tp_axis, n_tp)
                if spec is not None:
                    return spec, tp_reason
                log.info("sharding plan: %s not tensor-parallel: %s",
                         name, tp_reason)
                # fall through: the ZeRO dim-0 rule (below) may still
                # shard the update of a param the TP rule passed on
            elif tp_axis is not None and not shard_update:
                return P(), "mesh axis %r has size 1" % tp_axis
            if not shard_update:
                return P(), tp_reason
            if n_shard <= 1:
                return P(), "mesh axis %r has size 1" % shard_axis
            shape = tuple(shape or ())
            if not shape or shape[0] is None:
                return P(), "no concrete leading dim"
            if shape[0] % n_shard != 0:
                reason = ("dim0 %d %% %d (%r) != 0 -> replicated"
                          % (shape[0], n_shard, shard_axis))
                log.info("sharding plan: %s stays replicated: %s",
                         name, reason)
                return P(), reason
            if int(np.prod(shape)) < n_shard:
                reason = ("%d elements < %d-way %r axis -> replicated"
                          % (int(np.prod(shape)), n_shard, shard_axis))
                log.info("sharding plan: %s stays replicated: %s",
                         name, reason)
                return P(), reason
            return P(shard_axis), "dim0 %d / %d over %r" % (
                shape[0], n_shard, shard_axis)

        # params, sorted-name order (restart-stable walk)
        follow = {}   # param -> spec its accumulators follow
        for name in sorted(params):
            p = params[name]
            taken.add(name)
            if name in overrides:
                spec = overrides[name]
                entries.append(VarPlan(name, spec, PARAM, override=True,
                                       reason="explicit override",
                                       shape=p.shape, dtype=p.dtype))
                # explicit overrides do NOT cascade to accumulators (the
                # caller pinned exactly one var); annotations do
                continue
            ann = _annotation_spec(p)
            if ann is not None:
                entries.append(VarPlan(name, ann, PARAM,
                                       reason="ParamAttr mesh_axes",
                                       shape=p.shape, dtype=p.dtype))
                follow[name] = ann
                continue
            spec, reason = _auto_spec(name, p.shape)
            entries.append(VarPlan(name, spec, PARAM, reason=reason,
                                   shape=p.shape, dtype=p.dtype))
            if spec != P():
                follow[name] = spec

        # optimizer accumulators follow their owner param. Resolution
        # goes through the exact program._accumulator_owner map; the
        # name-pattern fallback (longest param name wins) only covers
        # programs deserialized without optimizer metadata.
        acc_owner = getattr(program, "_accumulator_owner", {})
        by_len = sorted(params, key=len, reverse=True)
        for vname in sorted(program.global_block().vars):
            v = program.global_block().vars[vname]
            if vname in taken or not getattr(v, "persistable", False):
                continue
            owner = acc_owner.get(vname)
            if owner is None:
                owner = _match_accumulator_param(vname, by_len)
            if owner == "":
                # optimizer-global state (beta pows, counters): [1]
                # scalars — nothing to shard, and the "" owner mark
                # guarantees no param can claim them
                if vname in overrides:
                    entries.append(VarPlan(
                        vname, overrides[vname], OPTIMIZER_GLOBAL,
                        owner="", override=True,
                        reason="explicit override",
                        shape=v.shape, dtype=v.dtype))
                else:
                    entries.append(VarPlan(
                        vname, P(), OPTIMIZER_GLOBAL, owner="",
                        reason="optimizer-global scalar",
                        shape=v.shape, dtype=v.dtype))
                continue
            if owner is None or owner not in params:
                continue  # not optimizer state — plain persistable
            if vname in overrides:
                entries.append(VarPlan(
                    vname, overrides[vname], ACCUMULATOR, owner=owner,
                    override=True, reason="explicit override",
                    shape=v.shape, dtype=v.dtype))
                continue
            ospec = follow.get(owner)
            same_shape = tuple(v.shape or ()) == tuple(
                params[owner].shape or ())
            if ospec is not None and same_shape:
                entries.append(VarPlan(
                    vname, ospec, ACCUMULATOR, owner=owner,
                    reason="follows owner %r" % owner,
                    shape=v.shape, dtype=v.dtype))
            else:
                reason = ("owner %r replicated" % owner
                          if ospec is None else
                          "shape differs from owner %r -> replicated"
                          % owner)
                entries.append(VarPlan(
                    vname, P(), ACCUMULATOR, owner=owner, reason=reason,
                    shape=v.shape, dtype=v.dtype))

        # any override naming a var the walk didn't classify (fetch-only
        # persistables, caller-known state) still lands in the plan
        for vname in sorted(set(overrides) -
                            {e.name for e in entries}):
            from ..core.framework import find_var
            v = find_var(program, vname)
            entries.append(VarPlan(
                vname, overrides[vname], PARAM, override=True,
                reason="explicit override",
                shape=getattr(v, "shape", None),
                dtype=getattr(v, "dtype", None)))

        # gradients mirror their param's spec: the reduce-scatter target.
        # Only sharded params get one — a replicated param's grad is the
        # plain all-reduce over the batch axis.
        from ..core.framework import GRAD_SUFFIX
        for e in [e for e in entries if e.kind == PARAM and e.sharded]:
            entries.append(VarPlan(
                e.name + GRAD_SUFFIX, e.spec, GRADIENT, owner=e.name,
                reason="reduce-scatter onto owner's shard",
                shape=e.shape, dtype=e.dtype))

        return cls(mesh, entries, batch_axis=batch_axis,
                   shard_axis=shard_axis, tp_axis=tp_axis,
                   tp_placement=tp_placement)

    # ----------------------------------------------------------- query --
    def spec_for(self, name):
        """The PartitionSpec assigned to `name`, or None when the plan
        has no entry for it (callers treat that as replicated)."""
        e = self.entries.get(name)
        return None if e is None else e.spec

    def sharding_for(self, name):
        """NamedSharding for `name` (replicated when unplanned) — what
        the executor device_puts state with and what
        CheckpointManager.restore(layout=plan) re-splits onto."""
        spec = self.spec_for(name)
        return NamedSharding(self.mesh, spec if spec is not None else P())

    def spec_map(self):
        """{name: PartitionSpec} for every non-gradient entry that is
        sharded or explicitly overridden — the executor's
        `_param_shardings` view (replicated auto entries are implied)."""
        return {e.name: e.spec for e in self.entries.values()
                if e.kind != GRADIENT and (e.sharded or e.override)}

    def grad_constraints(self):
        """{grad_name: NamedSharding}: each sharded param's gradient lands
        on its owner's shard (summed over the batch axis, then cut), so a
        replica receives only the slice its update needs. Gather-placed
        tensor-parallel params are exempt: their step runs replicated end
        to end (the placement's bit-exactness contract) and their grads
        land on the shard with the new state at the step's end."""
        skip = frozenset(self.param_gather_constraints())
        return {e.name: NamedSharding(self.mesh, e.spec)
                for e in self.entries.values()
                if e.kind == GRADIENT and e.owner not in skip}

    def _spec_uses_tp(self, spec):
        for ent in tuple(spec):
            axes = ent if isinstance(ent, (list, tuple)) else (
                () if ent is None else (ent,))
            if self.tp_axis in axes:
                return True
        return False

    def param_gather_constraints(self):
        """{param name: replicated NamedSharding} for every
        tensor-parallel param, and every accumulator riding a TP owner,
        under tp_placement="gather": the executor gathers each at the
        step's entry, so the value lives 1/tp-sharded at rest while every
        contraction and the update see the full array (bit-identical to
        the replicated run). Empty for tp_placement="compute" and for
        plans with no tp axis (the ZeRO dim-0 case gathers its params at
        entry and updates its accumulators on the shard)."""
        if not self.tp_axis or self.tp_placement != "gather":
            return {}
        rep = NamedSharding(self.mesh, P())
        return {e.name: rep for e in self.entries.values()
                if e.kind in (PARAM, ACCUMULATOR)
                and self._spec_uses_tp(e.spec)}

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(sorted(self.entries.values(), key=lambda e: e.name))

    # ------------------------------------------------------- serialize --
    def to_json(self):
        """Canonical JSON form, the JAX package's (so `digest()` agrees
        across the two packages for the same program and mesh axes).
        Deterministic: vars sorted, mesh axes in mesh order."""
        return {
            "version": PLAN_FORMAT_VERSION,
            "mesh_axes": [[a, int(s)] for a, s in self.mesh.shape.items()],
            "batch_axis": self.batch_axis,
            "shard_axis": self.shard_axis,
            "tp_axis": self.tp_axis,
            "tp_placement": self.tp_placement,
            "vars": {n: self.entries[n].to_json()
                     for n in sorted(self.entries)},
        }

    def digest(self):
        blob = json.dumps(self.to_json(), sort_keys=True).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()

    # ------------------------------------------------------ accounting --
    def memory_report(self):
        """Per-chip memory accounting for the state the plan places —
        the number the ZeRO sharding exists to move. For each entry:
        global bytes (shape x dtype) and per-chip bytes (global /
        shard factor). `update_state` covers optimizer accumulators +
        optimizer-global scalars — the footprint the replicated
        reference design pays N times over; `params` is priced the same
        way (sharded-at-rest params all-gather on use). Gradient
        entries are transient (not resident state) and excluded."""
        n = int(self.mesh.devices.size)
        rep = {"params": {"global_bytes": 0, "per_chip_bytes": 0,
                          "replicated_per_chip_bytes": 0},
               "update_state": {"global_bytes": 0, "per_chip_bytes": 0,
                                "replicated_per_chip_bytes": 0}}
        sharded_vars, replicated_vars = [], []
        for e in self.entries.values():
            if e.kind == GRADIENT or e.shape is None:
                continue
            shape = [d for d in e.shape if d is not None and d >= 0]
            nbytes = int(np.prod(shape or [1])) * _dtype_bytes(e.dtype)
            bucket = rep["params" if e.kind == PARAM else "update_state"]
            factor = _spec_shard_factor(e.spec, self.mesh)
            bucket["global_bytes"] += nbytes
            bucket["per_chip_bytes"] += nbytes // factor
            bucket["replicated_per_chip_bytes"] += nbytes
            (sharded_vars if factor > 1 else replicated_vars).append(
                e.name)
        return {"num_devices": n,
                "shard_axis": self.shard_axis,
                "shard_axis_size": int(self.mesh.shape.get(
                    self.shard_axis, 1)),
                "tp_axis": self.tp_axis,
                "tp_axis_size": int(self.mesh.shape.get(
                    self.tp_axis, 1)) if self.tp_axis else 1,
                "params": rep["params"],
                "update_state": rep["update_state"],
                "sharded_vars": sorted(sharded_vars),
                "replicated_vars": sorted(replicated_vars)}

    def describe(self):
        """Human-readable plan table (one line per var + the memory
        footer) — what `print(pexe.plan.describe())` shows."""
        lines = ["ShardingPlan over %s (batch=%r, shard=%r%s)"
                 % (dict(self.mesh.shape), self.batch_axis,
                    self.shard_axis,
                    ", tp=%r" % self.tp_axis if self.tp_axis else "")]
        for e in self:
            lines.append("  %-40s %-12s %-18s %s" % (
                e.name, e.kind, str(tuple(e.spec)),
                e.reason + (" [override]" if e.override else "")))
        m = self.memory_report()
        lines.append(
            "  update state/chip: %d B (replicated would be %d B)"
            % (m["update_state"]["per_chip_bytes"],
               m["update_state"]["replicated_per_chip_bytes"]))
        return "\n".join(lines)

    def __repr__(self):
        n_sharded = sum(1 for e in self.entries.values()
                        if e.kind != GRADIENT and e.sharded)
        return ("ShardingPlan(mesh=%s, %d vars, %d sharded, shard_axis=%r)"
                % (dict(self.mesh.shape),
                   sum(1 for e in self.entries.values()
                       if e.kind != GRADIENT),
                   n_sharded, self.shard_axis))
