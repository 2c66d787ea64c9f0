"""ParallelExecutor: training over a device mesh from one controller.

Parity: python/paddle/fluid/parallel_executor.py (the NCCL all-reduce SSA
graph) and the JAX package's parallel/parallel_executor.py, whose contract
this keeps: ONE process calls run(feed=<the global batch>), the global
program runs with its batch-leading feeds split over the mesh's batch
axis ('dp'), state is placed by a ShardingPlan (plan.py), the fetched
loss is the global batch's, and the state after a step matches the
single-device Executor's. The JAX package gets the collectives from
GSPMD; here they are written by hand at the points GSPMD inserts them.

How a step runs. A mesh is an array of torch devices, a device possibly
repeated (replicas that share it). The step walks the program's global
block once; each op runs in one of four ways:
  * local — an op whose batch-sharded inputs and outputs all carry the
    batch on dim 0 and which mixes no rows (the dual batch-sentinel shape
    inference says so, core/registry.py): it runs on each dp shard, rows
    [i*B/N, (i+1)*B/N) of replica i, as P('dp') lays them out;
  * global — an op that is not batch-local (mean, batch_norm, accuracy,
    auc, gather, a reduction over dim 0, an axis attr naming dim 0, any
    random op, whose draw must be the single-device one): its unchanged
    rule runs on the all-gathered inputs, and its batch-leading outputs
    are cut back to the shards;
  * replicated — an op with no batch-sharded input (the optimizer, the
    LR schedule): it runs once per device, its outputs shared by the
    replicas on that device;
  * sharded update — an optimizer rule over a ZeRO-placed param (or a
    "compute"-placed tensor-parallel one): it runs on each owner's shard
    of the param, its gradient and accumulators;
  * piece-wise product — under tp_placement="compute", a mul / matmul
    whose weight the plan splits over the tp axis: it runs once a piece
    of the weight (column-parallel: output columns, concatenated;
    row-parallel: partial products over the input's slice, summed over
    tp), and the weight's gradient lands on its pieces.
A replicated input's gradient from a local op is a partial sum; it is
summed over the batch axis only (never averaged: `mean` is global), where
GSPMD would insert the all-reduce, when something reads it. An op the
analysis cannot place (a control-flow op reading batch-sharded vars)
raises at construction, naming it. A `pipeline` op is batch-local when
every op of its stage is (each batch shard then runs its own microbatch
schedule); a `moe` op is global (its capacity counts the whole batch).

Transport. Replicas that share a device combine with torch ops (cat,
add, narrow). Distinct cards, and the size-1 mesh on a card, combine
through single-process NCCL (torch.cuda.nccl) in eager runs. A captured
run(steps=K) needs every replica on one device: it captures the whole
multi-replica step into one CUDA graph (core/lowering.MultiStepRunner);
over distinct cards it raises GraphCaptureError. Sequence parallelism
('sp', fused_attention's ring or Ulysses exchange) reproduces the JAX
package's semantics on replicas that share a device; over distinct cards
it raises, since nothing would be split between them yet, and so do 'pp'
and 'ep' axes and "compute" tensor parallelism.

State. The scope holds a var the plan splits as a core/sharded.
ShardedValue (per-replica pieces plus the spec); every reader of the
scope sees the global value.
"""
import collections
import copy

import torch

from ..core import registry
from ..core.dispatch import (dispatch_with_deadline, run_step_traced)
from ..core import dispatch as _dispatch
from ..core.executor import (_feed_signature, _feed_to_device,
                             _jit_cache_capacity, _cache_put_lru,
                             _nan_inf_enabled, array_safety_enabled,
                             convert_feeds, global_scope, to_numpy,
                             to_tensor)
from ..core.framework import GRAD_SUFFIX, default_main_program, find_var
from ..core.lowering import (FETCH_REDUCE_POLICIES, ARRAY_OVERFLOW,
                             PROGRAM_ERR, SUB_BLOCK_OVERFLOW, Env,
                             GraphCaptureError, LowerCtx, MultiStepRunner,
                             _StepCtx, _apply_amp, analyze_state,
                             fold_error, lower_op, unread_outputs)
from ..core.readers import HOST_IO_OPS
from ..core.sharded import (ShardedValue, mesh_coords, piece_index,
                            spec_axes, spec_is_sharded, take_piece)
from .mesh import data_parallel_mesh
from .plan import ShardingPlan

__all__ = ["ParallelExecutor", "analyze_batch_placement"]

# update rules over (Param, Grad, accumulators): elementwise in the param,
# so a ZeRO owner runs them on its shard
UPDATE_OPS = frozenset([
    "sgd", "momentum", "adagrad", "adam", "adamax", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad"])

# rules that mix rows of the batch while keeping a batch-leading output
# (the shape analysis cannot see it), or whose outputs are statistics of
# the whole batch: they run on the gathered batch
GLOBAL_OPS = frozenset([
    "mean", "batch_norm", "accuracy", "auc", "chunk_eval", "gather",
    "scatter", "precision_recall", "positive_negative_pair",
    # the expert capacity and each token's place in its expert's queue
    # count every token of the batch: per-shard routing keeps and drops
    # other tokens
    "moe"])

# the ops "compute" tensor parallelism runs on a parameter's tp pieces
# (their Y input): column-parallel (outputs concatenated) or
# row-parallel (partial products summed over tp)
TP_PRODUCT_OPS = frozenset(["mul", "matmul"])

# attrs that name a dim of the op's input: one naming dim 0 of a
# batch-sharded input makes the op global
_AXIS_ATTRS = ("axis", "dim", "axes", "dims", "begin_norm_axis")

_SENTINELS = (registry.BATCH_SENTINEL, registry.BATCH_SENTINEL_B)


def _var_batch_leading(v):
    """True iff a feed var shards over the batch axis: its declared shape
    has a -1 (dynamic batch) leading dim. Fixed-leading-dim vars (record
    metadata, lookup tables) replicate instead (the JAX package's rule)."""
    shape = tuple(getattr(v, "shape", None) or ()) if v is not None else ()
    return not shape or shape[0] in (-1, None)


def _lead_batch(var):
    """Whether `var`'s dim 0 is a multiple of the batch (True), is not
    batch-derived (False), or cannot be told (None: no shape). From the
    dual batch-sentinel shapes the build-time inference recorded, else
    from a declared -1."""
    if var is None or var.shape is None:
        return None
    shape = tuple(var.shape)
    if not shape:
        return False
    rec = getattr(var, "_abstract_shapes", None)
    if rec is not None and rec[2] == shape and rec[0] and rec[1]:
        a, b = int(rec[0][0]), int(rec[1][0])
        if a == b:
            return False
        return a % _SENTINELS[0] == 0 and b % _SENTINELS[1] == 0 or None
    return shape[0] == -1


def _sub_block_reads(program, op):
    """Names the sub-blocks of a control-flow op read."""
    out = []
    for key in ("sub_block", "step_block", "true_block", "false_block"):
        idx = op.attrs.get(key)
        if isinstance(idx, int) and 0 < idx < len(program.blocks):
            for sop in program.blocks[idx].ops:
                out.extend(n for n in sop.all_input_vars() if n)
                out.extend(_sub_block_reads(program, sop))
    return out


def _axis_hits_batch(op, rank):
    """Does an axis-naming attr of `op` name dim 0 of an input of rank
    `rank` (None: unknown, negatives not normalized)?"""
    if op.type.startswith("elementwise_"):
        return False   # its `axis` aligns Y within X, not a reduction dim
    attrs = op.attrs
    if attrs.get("reduce_all"):
        return True
    perm = attrs.get("perm") or attrs.get("axis") if op.type in (
        "transpose", "transpose2") else None
    if perm is not None:
        return list(perm)[:1] != [0]
    times = attrs.get("expand_times")
    if times and int(times[0]) != 1:
        return True
    for key in ("paddings", "offsets"):
        v = attrs.get(key)
        if v and any(int(x) for x in list(v)[:2 if key == "paddings"
                                             else 1]):
            return True
    for key in _AXIS_ATTRS:
        if key not in attrs or attrs[key] is None:
            continue
        v = attrs[key]
        vals = list(v) if isinstance(v, (list, tuple)) else [v]
        for a in vals:
            try:
                a = int(a)
            except (TypeError, ValueError):
                continue
            if a < 0 and rank is not None:
                a += rank
            if a == 0:
                return True
    return False


class ParallelPlacementError(NotImplementedError):
    """The batch analysis cannot place an op on the mesh."""


def _classify(program, op, sharded, dp, lead):
    """'local' or 'global' for an op reading the batch-sharded `sharded`
    vars on a dp-way batch axis; raises for an op it cannot place."""
    if dp == 1:
        return "local"
    od = registry.get(op.type)
    ins = [n for n in op.all_input_vars() if n]
    if op.type == "pipeline" and not _stages_local(program, op, dp, lead):
        return "global"
    if od.special:
        reads = set(ins) | set(_sub_block_reads(program, op))
        raise ParallelPlacementError(
            "ParallelExecutor cannot place op %r (uid %d) on a mesh with a "
            "%d-way batch axis: it is a control-flow op, and it reads the "
            "batch-sharded var(s) %s, which its body would see one shard "
            "at a time. Run it on a mesh whose batch axis has size 1"
            % (op.type, op.uid, dp, sorted(reads & sharded)))
    if op.type in GLOBAL_OPS or od.uses_rng:
        return "global"
    first = next((n for n in ins if n in sharded), None)
    v = find_var(program, first) if first is not None else None
    rank = len(v.shape) if v is not None and v.shape is not None else None
    if _axis_hits_batch(op, rank):
        return "global"
    for n in ins:
        lb = lead(n)
        if (n in sharded and lb is not True) or \
                (n not in sharded and lb is not False):
            return "global"
    for n in op.all_output_vars():
        if n and lead(n) is not True:
            return "global"
    return "local"


def _stages_local(program, op, dp, lead):
    """Whether a `pipeline` op can run on each batch shard apart (its
    microbatches then split the shard's rows, as the JAX package's
    batch_axis='dp' splits each microbatch): every op of its template
    stage that reads the stage input, or a value made from it, is
    batch-local."""
    sub = program.blocks[op.attrs["sub_block"]]
    sharded = {op.attrs["in_name"]}
    for sop in sub.ops:
        od = registry.get(sop.type)
        reads = set(n for n in sop.all_input_vars() if n)
        if od.special:
            reads |= set(_sub_block_reads(program, sop))
        if not reads & sharded:
            continue
        if od.special or \
                _classify(program, sop, sharded, dp, lead) != "local":
            return False
        for n in sop.all_output_vars():
            if n and lead(n) is True:
                sharded.add(n)
    return True


def analyze_batch_placement(program, dp, sharded_feeds):
    """The batch analysis of `program`'s global block on a dp-way batch
    axis with the batch-sharded feeds `sharded_feeds`: ({op uid: 'local'
    | 'global'} for every forward op reading a batch-sharded var, the
    lead-batch lookup). Raises ParallelPlacementError naming an op it
    cannot place."""
    cache = {}

    def lead(name):
        if name not in cache:
            cache[name] = _lead_batch(find_var(program, name))
        return cache[name]

    sharded = set(sharded_feeds)
    for op in program.global_block().ops:
        if op.type == "read":
            sharded.update(n for n in op.outputs.get("Out", ())
                           if lead(n))
    kinds = {}
    for op in program.global_block().ops:
        if op.type in HOST_IO_OPS or op.type == "grad_of":
            continue
        reads = set(n for n in op.all_input_vars() if n)
        if registry.is_registered(op.type) and \
                registry.get(op.type).special:
            reads |= set(_sub_block_reads(program, op))
        if not reads & sharded:
            for n in op.all_output_vars():
                sharded.discard(n)
            continue
        kind = _classify(program, op, sharded, dp, lead)
        kinds[op.uid] = kind
        for n in op.all_output_vars():
            if not n:
                continue
            if lead(n) is True:
                sharded.add(n)
            else:
                sharded.discard(n)
    return kinds, lead


class _Lane(object):
    """One place the step runs batch-local work: a dp shard on a device.
    `rep` is the index of the lane that runs replicated work for its
    device, `group` the lanes that combine with it (same coordinates off
    the batch axis)."""

    __slots__ = ("index", "dp", "device", "rep", "group")

    def __init__(self, index, dp, device):
        self.index, self.dp, self.device = index, dp, device
        self.rep, self.group = index, None


class _ParallelStep(object):
    """One step of a program over a mesh: the lanes, the placements and
    the collectives (see the module docstring). Built once per program
    version, plan and set of batch-sharded feeds; run() is one step."""

    def __init__(self, program, mesh, plan, batch_axis, kinds, lead):
        self.program = program
        self.mesh = mesh
        self.plan = plan
        self.batch_axis = batch_axis
        self.kinds = kinds
        self.lead = lead
        self.dp = int(mesh.shape.get(batch_axis, 1))
        self.coords = mesh_coords(mesh)
        devs = list(mesh.devices.flat)
        self.single_device = len(set(str(d) for d in devs)) == 1
        if not self.single_device and \
                len(set(str(d) for d in devs)) != len(devs):
            raise NotImplementedError(
                "ParallelExecutor: a mesh that puts some of its replicas on "
                "a shared device and others apart is not supported; list "
                "one device for every replica, or every replica on one")
        if not self.single_device and int(mesh.shape.get("sp", 1)) > 1 \
                and any(op.type == "fused_attention"
                        for blk in program.blocks for op in blk.ops):
            # fused_attention's exchange runs on the full sequence of the
            # lane that holds it: over distinct cards each sp replica
            # would attend the whole sequence again
            raise NotImplementedError(
                "ParallelExecutor: sequence parallelism over distinct "
                "cards (%s) is not distributed yet: each sp replica would "
                "attend the whole sequence on its own card (the open item "
                "of ROADMAP A10's second half); put every replica of the "
                "'sp' axis on one device"
                % [str(d) for d in mesh.distinct_devices()])
        for axis, op_type, what in (("pp", "pipeline", "pipeline stages"),
                                    ("ep", "moe", "expert groups")):
            if not self.single_device and \
                    int(mesh.shape.get(axis, 1)) > 1 and \
                    any(op.type == op_type for blk in program.blocks
                        for op in blk.ops):
                raise NotImplementedError(
                    "ParallelExecutor: a %r axis over distinct cards (%s) "
                    "is not distributed yet: its %s would each run on "
                    "every card (ROADMAP §A item 5); put every replica "
                    "of the %r axis on one device"
                    % (axis, [str(d) for d in mesh.distinct_devices()],
                       what, axis))
        if self.single_device:
            self.lanes = [_Lane(i, i, devs[0]) for i in range(self.dp)]
            self.lane_of_replica = [c.get(batch_axis, 0)
                                    for c in self.coords]
            for ln in self.lanes:
                ln.rep, ln.group = 0, 0
        else:
            self.lanes = []
            self.lane_of_replica = []
            for r, (c, d) in enumerate(zip(self.coords, devs)):
                ln = _Lane(r, c.get(batch_axis, 0), d)
                ln.group = tuple(sorted((a, i) for a, i in c.items()
                                        if a != batch_axis))
                self.lanes.append(ln)
                self.lane_of_replica.append(r)
        self.rep_lanes = sorted(set(ln.rep for ln in self.lanes))
        groups = collections.OrderedDict()
        for ln in self.lanes:
            groups.setdefault(ln.group, []).append(ln)
        self.groups = [sorted(g, key=lambda ln: ln.dp)
                       for g in groups.values()]
        gather = plan.param_gather_constraints()
        self.sharded_specs = {}
        for e in plan.entries.values():
            if e.kind != "gradient" and spec_is_sharded(e.spec):
                self.sharded_specs[e.name] = tuple(e.spec)
        # gathered at the step's entry: sharded params, and accumulators
        # of gather-placed tensor-parallel owners
        self.entry_gather = set(
            n for n, e in plan.entries.items()
            if n in self.sharded_specs and (e.kind == "param"
                                            or n in gather))
        self.nccl_calls = 0     # the newest run's NCCL calls
        self.last_ran = {}
        # "compute" tensor parallelism: its params stay on their tp
        # pieces (no gather at entry), the products that read them run
        # a piece at a time (TP_PRODUCT_OPS), and their update runs on
        # the pieces
        self.tp_params = set()
        tp_axis = plan.tp_axis
        if tp_axis and plan.tp_placement == "compute" and \
                int(mesh.shape.get(tp_axis, 1)) > 1:
            if not self.single_device:
                raise NotImplementedError(
                    "ParallelExecutor: tp_placement='compute' over distinct "
                    "cards (%s) is not distributed yet (ROADMAP §A item "
                    "5); put every replica on one device, or build the "
                    "plan with tp_placement='gather'"
                    % [str(d) for d in mesh.distinct_devices()])
            self.tp_params = set(
                n for n, e in plan.entries.items()
                if e.kind == "param" and n in self.sharded_specs
                and plan._spec_uses_tp(e.spec))
            self.entry_gather -= self.tp_params
        # params whose update runs on the owner's shard
        self.zero_params = set(
            n for n in self.entry_gather
            if plan.entries[n].kind == "param" and n not in gather) \
            | self.tp_params

    # ----------------------------------------------------------- state --
    def load_state(self, scope, name):
        """The scope's value of `name` as the step takes it: a
        ShardedValue in the plan's spec for a var the plan splits (the
        scope's own when it already is one), else one tensor (a
        ShardedValue of spec () over distinct cards)."""
        raw = scope.get_raw(name)
        if raw is None:
            raise RuntimeError(
                "persistable var %r not initialized; run the startup "
                "program with Executor first" % name)
        spec = self.sharded_specs.get(name)
        if spec is not None:
            if isinstance(raw, ShardedValue) and raw.spec == spec and \
                    raw.mesh == self.mesh:
                return raw
            full = raw.assemble() if isinstance(raw, ShardedValue) else raw
            sv = ShardedValue.split(self.mesh, spec, full)
            scope.set(name, sv)
            return sv
        if isinstance(raw, ShardedValue):
            if not raw.spec and raw.mesh == self.mesh:
                return raw if not self.single_device else raw.pieces[0]
            raw = raw.assemble()
        return raw

    # ----------------------------------------------------- collectives --
    def _nccl_call(self, fn, ins, outs):
        from torch.cuda import nccl
        if not nccl.is_available(ins):
            raise RuntimeError(
                "ParallelExecutor: torch.cuda.nccl cannot take these "
                "tensors (%s); NCCL is how this mesh's cards combine"
                % [(str(t.device), t.dtype) for t in ins])
        fn(ins, outs)
        self.nccl_calls += 1

    def _all_reduce(self, vals):
        """Per-lane partial sums -> per-lane totals (summed over the batch
        axis only)."""
        if self.nccl:
            from torch.cuda import nccl
            out = [None] * len(self.lanes)
            for grp in self.groups:
                ins = [vals[ln.index].contiguous() for ln in grp]
                outs = [torch.empty_like(t) for t in ins]
                self._nccl_call(nccl.all_reduce, ins, outs)
                for ln, o in zip(grp, outs):
                    out[ln.index] = o
            return out
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return [total] * len(vals)

    def _reduce_piece(self, vals, idx):
        """Piece `idx` of per-lane partial sums, summed over the batch
        axis: the owner's part of a reduce-scatter (lanes that share a
        device)."""
        total = None
        for v in vals:
            piece = take_piece(v, idx)
            total = piece if total is None else total + piece
        return total

    def _gather_rows(self, vals):
        """Per-lane row shards -> per-lane full batch (shard order)."""
        if self.nccl:
            from torch.cuda import nccl
            out = [None] * len(self.lanes)
            for grp in self.groups:
                ins = [vals[ln.index].contiguous() for ln in grp]
                shape = (ins[0].shape[0] * len(ins),) + tuple(
                    ins[0].shape[1:])
                outs = [torch.empty(shape, dtype=t.dtype, device=t.device)
                        for t in ins]
                self._nccl_call(nccl.all_gather, ins, outs)
                for ln, o in zip(grp, outs):
                    out[ln.index] = o
            return out
        full = vals[0] if len(vals) == 1 else torch.cat(vals, 0)
        return [full] * len(vals)

    def _rows(self, full, lane):
        """Lane `lane`'s rows of a full batch tensor."""
        if self.dp == 1:
            return full
        n = full.shape[0]
        if n % self.dp:
            raise ValueError(
                "a batch-leading value of %d rows does not divide evenly "
                "across the %d-way %r axis" % (n, self.dp, self.batch_axis))
        b = n // self.dp
        return full.narrow(0, lane.dp * b, b)

    # ------------------------------------------------------ placements --
    def _vals(self, name):
        return [env.values[name] for env in self.envs]

    def _set_shared(self, name, per_rep):
        """Set a replicated value from {rep lane index: tensor}."""
        for ln, env in zip(self.lanes, self.envs):
            env.values[name] = per_rep[ln.rep]
        self.place[name] = "R"

    def _assemble_z(self, name, device):
        sv = ShardedValue(self.mesh, self.zspec[name], self.zv[name],
                          self.zshape[name])
        return sv.assemble(device)

    def _to_R(self, name):
        p = self.place.get(name)
        if p == "P":
            for env, v in zip(self.envs, self._all_reduce(self._vals(name))):
                env.values[name] = v
            self.place[name] = "R"
        elif p == "Z":
            self._set_shared(name, {
                r: self._assemble_z(name, self.lanes[r].device)
                for r in self.rep_lanes})
            del self.zv[name]
        elif p == "S":
            full = self._gather_rows(self._vals(name))
            for env, v in zip(self.envs, full):
                env.values[name] = v
            self.place[name] = "R"

    def _full(self, name, rep):
        """The full batch of S var `name` on rep lane `rep`'s device,
        gathered once a version of its shards."""
        vals = self._vals(name)
        key = tuple(id(v) for v in vals)
        hit = self.gcache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, self._gather_rows(vals))
            self.gcache[name] = hit
        return hit[1][rep]

    def _r_to_p(self, name):
        """A replicated value as partial sums: the dp-0 lanes keep it,
        every other lane holds zeros."""
        for ln, env in zip(self.lanes, self.envs):
            if ln.dp != 0:
                env.values[name] = torch.zeros_like(env.values[name])
        self.place[name] = "P"

    def _merge_replicated_grad(self, g, per_rep):
        """Fold a replicated gradient contribution ({rep: tensor}) into
        grad var `g`: added to a replicated total per device, or to the
        dp-0 lanes of a partial one (so the sum over the batch axis counts
        it once)."""
        cur = self.place.get(g)
        if cur == "P":
            base = self._vals(g)
            for ln, env in zip(self.lanes, self.envs):
                env.values[g] = base[ln.index] + per_rep[ln.rep] \
                    if ln.dp == 0 else base[ln.index]
            self.place[g] = "P"
        elif cur == "R" and g in self.envs[0].values:
            self._set_shared(g, {r: self.envs[r].values[g] + per_rep[r]
                                 for r in self.rep_lanes})
        else:
            self._set_shared(g, per_rep)

    # ------------------------------------------------------------- ops --
    def _exec_op(self, op):
        if op.type in HOST_IO_OPS:
            return
        if op.type == "grad_of":
            self._exec_grad(op)
            return
        mode = self._tp_mode(op)
        if mode is not None:
            self._exec_tp(op, mode)
            return
        names = [n for n in op.all_input_vars() if n]
        zup = op.type in UPDATE_OPS and \
            (op.inputs.get("Param") or [None])[0] in self.zero_params
        for n in names:
            p = self.place.get(n)
            if p == "P" and not zup:
                self._to_R(n)
            elif p == "Z" and not (zup and self.zspec.get(n) ==
                                   self.sharded_specs[op.inputs["Param"][0]]):
                self._to_R(n)
        if zup:
            self._exec_zupdate(op)
            return
        if not any(self.place.get(n) == "S" for n in names):
            self._exec_rep(op)
            return
        kind = self.kinds.get(op.uid)
        if kind is None:
            sharded = set(n for n, p in self.place.items() if p == "S")
            kind = _classify(self.program, op, sharded, self.dp, self.lead)
        self.ran[op.uid] = kind
        if kind == "local":
            for ln, ctx, env in zip(self.lanes, self.ctxs, self.envs):
                lower_op(ctx, op, env)
            for n in op.all_output_vars():
                if n:
                    self.place[n] = "S"
        else:
            self._exec_global(op)

    def _exec_rep(self, op):
        self.ran[op.uid] = "rep"
        for r in self.rep_lanes:
            lower_op(self.ctxs[r], op, self.envs[r])
        outs = [n for n in op.all_output_vars() if n]
        for ln, env in zip(self.lanes, self.envs):
            if ln.rep != ln.index:
                src = self.envs[ln.rep].values
                for n in outs:
                    if n in src:
                        env.values[n] = src[n]
        for n in outs:
            self.place[n] = "R"

    def _exec_global(self, op):
        outs = [n for n in op.all_output_vars() if n]
        for r in self.rep_lanes:
            tenv = Env(None, (), self.lanes[r].device)
            for n in op.all_input_vars():
                if not n:
                    continue
                if self.place.get(n) == "S":
                    tenv.values[n] = self._full(n, r)
                elif n in self.envs[r].values:
                    tenv.values[n] = self.envs[r].values[n]
            lower_op(self.ctxs[r], op, tenv)
            for n in outs:
                v = tenv.values.get(n)
                if v is None:
                    continue
                rows = self.lead(n) is True
                for ln, env in zip(self.lanes, self.envs):
                    if ln.rep == r:
                        env.values[n] = self._rows(v, ln) if rows else v
        for n in outs:
            self.place[n] = "S" if self.lead(n) is True else "R"

    # ------------------------------------------- "compute" tensor par --
    def _tp_mode(self, op):
        """'col' or 'row' when `op` is a product over a "compute"-placed
        tensor-parallel weight it can run a piece at a time, else None."""
        if op.type not in TP_PRODUCT_OPS or not self.tp_params:
            return None
        y = (op.inputs.get("Y") or [None])[0]
        if y not in self.tp_params or self.place.get(y) != "Z" or \
                len(op.inputs.get("X") or ()) != 1:
            return None
        if op.type == "matmul" and (op.attrs.get("transpose_X") or
                                    op.attrs.get("transpose_Y")):
            return None
        if op.type == "mul" and int(op.attrs.get("y_num_col_dims", 1)) != 1:
            return None
        if len(self.zshape[y]) != 2:
            return None
        axes = (spec_axes(self.zspec[y]) + [(), ()])[:2]
        tp = (self.plan.tp_axis,)
        return {((), tp): "col", (tp, ()): "row"}.get(tuple(axes))

    def _tp_pieces(self, y):
        """The distinct pieces of Z-placed `y` in order along its split
        dim: [(piece index, replicas holding it, tensor)]."""
        units = sorted(self._units(self.zspec[y]), key=lambda u: u[0])
        return [(idx, reps, self.zv[y][reps[0]]) for idx, _, reps in units]

    @staticmethod
    def _row_part(op, x, j, n):
        """Piece j of n of x's contracted dim (the dims the op flattens
        into the product's K)."""
        k = int(op.attrs.get("x_num_col_dims", 1)) if op.type == "mul" \
            else x.dim() - 1
        lead = tuple(x.shape[:k])
        flat = x.reshape(lead + (-1,))
        step = flat.shape[-1] // n
        return flat.narrow(-1, j * step, step)

    def _exec_tp(self, op, mode):
        """A product over a "compute"-placed weight: each tp piece of the
        weight with the whole input (column-parallel: the output's
        columns, concatenated) or with the matching slice of the input's
        contracted dim (row-parallel: partial products, summed over tp in
        piece order, the Megatron all-reduce). A differentiated product
        keeps (input, pieces, output) a lane for its grad_of."""
        x = op.inputs["X"][0]
        y = op.inputs["Y"][0]
        out = op.outputs["Out"][0]
        if self.place.get(x) in ("P", "Z"):
            self._to_R(x)
        local = self.place.get(x) == "S"
        pieces = [p for _, _, p in self._tp_pieces(y)]
        od = registry.get(op.type)
        lanes = [ln.index for ln in self.lanes] if local else self.rep_lanes
        for li in lanes:
            ctx, env = self.ctxs[li], self.envs[li]
            stop = ctx.grad_stop.get(op.uid)
            xv = env.values[x]
            ctx.begin_op(op.uid, op.outputs)
            keep = stop is not None
            if keep:
                if xv.is_floating_point() and x not in stop:
                    xv = xv.detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(y not in stop)
                      for p in pieces]
            else:
                ps = pieces
            with torch.enable_grad() if keep else torch.no_grad():
                parts = []
                for j, p in enumerate(ps):
                    xin = xv if mode == "col" else \
                        self._row_part(op, xv, j, len(ps))
                    ins = {"X": [xin], "Y": [p]}
                    if ctx.amp:
                        ins = _apply_amp(op.type, ins)
                    parts.append(od.lower(ctx, ins, op.attrs)["Out"][0])
                if mode == "col":
                    val = torch.cat(parts, -1)
                else:
                    val = parts[0]
                    for part in parts[1:]:
                        val = val + part
            if keep:
                self.tp_saved[(li, op.uid)] = (xv, ps, val)
            env.values[out] = val.detach()
        if local:
            self.place[out] = "S"
        else:
            for ln, env in zip(self.lanes, self.envs):
                env.values[out] = self.envs[ln.rep].values[out]
            self.place[out] = "R"
        self.ran[op.uid] = "tp_local" if local else "tp_rep"

    def _exec_tp_grad(self, op, kind):
        """The grad_of of a piece-wise product: its input's gradient as a
        local (or replicated) op's, the weight's as Z pieces summed over
        the batch axis (each piece on the replicas that hold it)."""
        uid = op.attrs["fwd_uid"]
        x = op.attrs["fwd_inputs"]["X"][0]
        y = op.attrs["fwd_inputs"]["Y"][0]
        out = op.attrs["fwd_outputs"]["Out"][0]
        go = out + GRAD_SUFFIX
        if go not in self.envs[0].values:
            return
        local = kind == "tp_local"
        if self.place.get(go) in ("P", "Z") or (
                not local and self.place.get(go) == "S"):
            self._to_R(go)
        v = self.envs[0].values[go]
        if local and self.place.get(go) == "R" and v.dim() and \
                v.shape[0] > 1:
            for ln, env in zip(self.lanes, self.envs):
                env.values[go] = self._rows(env.values[go], ln)
            self.place[go] = "S"
        gx, gy = x + GRAD_SUFFIX, y + GRAD_SUFFIX
        if local and self.place.get(x) != "S" and self.place.get(gx) == "R":
            self._r_to_p(gx)
        lanes = [ln.index for ln in self.lanes] if local else self.rep_lanes
        piece_sums, xgrads = None, {}
        for li in lanes:
            xv, ps, val = self.tp_saved.pop((li, uid))
            g = self.envs[li].values[go].to(val.dtype)
            if g.shape != val.shape:
                g = g.broadcast_to(val.shape)
            targets = ([xv] if xv.requires_grad else []) + \
                [p for p in ps if p.requires_grad]
            grads = list(torch.autograd.grad(val, targets, g,
                                             allow_unused=True))
            if xv.requires_grad:
                gv = grads.pop(0)
                xgrads[li] = gv if gv is not None else torch.zeros_like(xv)
            if grads:
                grads = [gp if gp is not None else torch.zeros_like(p)
                         for gp, p in zip(grads, ps)]
                piece_sums = grads if piece_sums is None else \
                    [a + b for a, b in zip(piece_sums, grads)]
        if xgrads:
            if local:
                for li, gv in xgrads.items():
                    self.envs[li].accumulate(gx, gv)
                self.place[gx] = "S" if self.place.get(x) == "S" else "P"
            else:
                self._merge_replicated_grad(gx, xgrads)
        if piece_sums is not None:
            self._add_z_grad(gy, y, piece_sums)

    def _add_z_grad(self, gy, y, piece_sums):
        """Add per-piece gradients (in _tp_pieces order) into `gy`, which
        lands on `y`'s pieces (Z)."""
        units = self._tp_pieces(y)
        cur = self.place.get(gy)
        if cur == "P":      # the weight also feeds a product run whole
            self._to_R(gy)
            cur = "R"
        if cur == "R":
            full = self.envs[0].values[gy]
            piece_sums = [g + take_piece(full, idx).to(g.dtype)
                          for (idx, _, _), g in zip(units, piece_sums)]
        elif cur == "Z":
            piece_sums = [g + self.zv[gy][reps[0]]
                          for (_, reps, _), g in zip(units, piece_sums)]
        pieces = [None] * len(self.coords)
        for (_, reps, _), g in zip(units, piece_sums):
            for r in reps:
                pieces[r] = g
        self.zv[gy] = pieces
        self.zspec[gy] = self.zspec[y]
        self.zshape[gy] = self.zshape[y]
        self.place[gy] = "Z"
        for env in self.envs:
            env.values.pop(gy, None)

    def _exec_grad(self, op):
        uid = op.attrs["fwd_uid"]
        kind = self.ran.get(uid)
        if kind is None:
            raise RuntimeError("grad_of %r (fwd uid %d): the forward op "
                               "did not run in this step"
                               % (op.attrs["fwd_type"], uid))
        if kind in ("tp_local", "tp_rep"):
            self._exec_tp_grad(op, kind)
            return
        ins = [n for ns in op.attrs["fwd_inputs"].values() for n in ns
               if n]
        outs = [n for ns in op.attrs["fwd_outputs"].values() for n in ns
                if n]
        gouts = [y + GRAD_SUFFIX for y in outs
                 if y + GRAD_SUFFIX in self.envs[0].values]
        if kind == "local":
            for y in gouts:
                if self.place.get(y) in ("P", "Z"):
                    self._to_R(y)
                v = self.envs[0].values[y]
                if self.place.get(y) == "R" and v.dim() and v.shape[0] > 1:
                    # a full cotangent of a batch-sharded output: its rows
                    # (a broadcast one, [1, ...] or 0-d, stays whole)
                    for ln, env in zip(self.lanes, self.envs):
                        env.values[y] = self._rows(env.values[y], ln)
                    self.place[y] = "S"
            for x in ins:
                g = x + GRAD_SUFFIX
                if self.place.get(x) != "S" and self.place.get(g) == "R":
                    self._r_to_p(g)
            for ctx, env in zip(self.ctxs, self.envs):
                lower_op(ctx, op, env)
            for x in ins:
                g = x + GRAD_SUFFIX
                if g in self.envs[0].values:
                    self.place[g] = "S" if self.place.get(x) == "S" \
                        else "P"
            return
        for y in gouts:
            if self.place.get(y) in ("P", "Z") or (
                    kind == "rep" and self.place.get(y) == "S"):
                self._to_R(y)
        contrib = collections.OrderedDict()
        for r in self.rep_lanes:
            tenv = Env(None, (), self.lanes[r].device)
            for y in gouts:
                tenv.values[y] = self._full(y, r) \
                    if self.place.get(y) == "S" else self.envs[r].values[y]
            lower_op(self.ctxs[r], op, tenv)
            for x in ins:
                g = x + GRAD_SUFFIX
                if g in tenv.values:
                    contrib.setdefault(g, {})[r] = tenv.values[g]
        for g, per_rep in contrib.items():
            if self.place.get(g[:-len(GRAD_SUFFIX)]) == "S":
                for ln, env in zip(self.lanes, self.envs):
                    env.accumulate(g, self._rows(per_rep[ln.rep], ln))
                self.place[g] = "S"
            else:
                self._merge_replicated_grad(g, per_rep)

    def _units(self, spec):
        """The distinct pieces of `spec`: [(piece index, lane index,
        replicas holding it)]."""
        units = collections.OrderedDict()
        for r, c in enumerate(self.coords):
            idx = piece_index(spec, c, self.mesh)
            lane = self.lanes[self.lane_of_replica[r]]
            key = (idx, lane.rep)
            units.setdefault(key, []).append(r)
        return [(idx, rep, reps) for (idx, rep), reps in units.items()]

    def _exec_zupdate(self, op):
        """An update rule on the owners' shards of a ZeRO-placed param:
        each piece of the param, its gradient (summed over the batch
        axis on the piece only) and its accumulators at rest."""
        self.ran[op.uid] = "zupdate"
        pname = op.inputs["Param"][0]
        spec = self.sharded_specs[pname]
        gshape = tuple(self.envs[0].values[pname].shape) \
            if self.place.get(pname) != "Z" else tuple(self.zshape[pname])
        units = self._units(spec)
        outs_by_unit = []
        for idx, rep, reps in units:
            lane = self.lanes[rep]
            tenv = Env(None, (), lane.device)
            for n in op.all_input_vars():
                if not n:
                    continue
                p = self.place.get(n)
                if p == "Z":
                    tenv.values[n] = self.zv[n][reps[0]]
                    continue
                shape = tuple(self.envs[0].values[n].shape)
                if shape != gshape:
                    if p == "P":
                        self._to_R(n)
                    tenv.values[n] = self.envs[rep].values[n]
                elif p == "P" and not self.nccl:
                    tenv.values[n] = self._reduce_piece(self._vals(n), idx)
                else:
                    if p == "P":
                        self._to_R(n)
                    tenv.values[n] = take_piece(self.envs[rep].values[n],
                                                idx)
            lower_op(self.ctxs[rep], op, tenv)
            outs_by_unit.append((idx, rep, reps, tenv))
        for n in op.all_output_vars():
            if not n:
                continue
            first = outs_by_unit[0][3].values.get(n)
            if first is None:
                continue
            if tuple(first.shape) != gshape and first.dim() == len(gshape) \
                    and n in self.sharded_specs:
                pieces = [None] * len(self.coords)
                for idx, rep, reps, tenv in outs_by_unit:
                    for r in reps:
                        pieces[r] = tenv.values[n]
                self.zv[n] = pieces
                self.zspec[n] = spec
                self.zshape[n] = gshape
                self.place[n] = "Z"
            else:
                self._set_shared(n, {rep: tenv.values[n]
                                     for _, rep, _, tenv in outs_by_unit})

    # ------------------------------------------------------------ step --
    def fetch(self, name):
        """The global value of `name` on the first lane's device."""
        p = self.place.get(name)
        if p == "Z":
            return self._assemble_z(name, self.lanes[0].device)
        if p == "S":
            return self._full(name, 0)
        if p == "P":
            self._to_R(name)
        return self.envs[0].read(name)

    def _final_state(self, name):
        """The new value of persistable `name`: a ShardedValue for a var
        the plan splits (or one held per card), else a tensor."""
        spec = self.sharded_specs.get(name)
        p = self.place.get(name)
        if p in ("S", "P"):
            self._to_R(name)
        if spec is not None:
            if self.place.get(name) == "Z" and self.zspec[name] == spec:
                return ShardedValue(self.mesh, spec, self.zv[name],
                                    self.zshape[name])
            if self.place.get(name) == "Z":
                self._to_R(name)
            made = {}
            pieces = []
            for r, c in enumerate(self.coords):
                lane = self.lanes[self.lane_of_replica[r]]
                idx = piece_index(spec, c, self.mesh)
                key = (idx, lane.rep)
                if key not in made:
                    made[key] = take_piece(
                        self.envs[lane.rep].values[name], idx).clone()
                pieces.append(made[key])
            return ShardedValue(self.mesh, spec, pieces,
                                self.envs[0].values[name].shape)
        if self.place.get(name) == "Z":
            self._to_R(name)
        v = self.envs[0].values[name]
        if self.single_device:
            return v
        pieces = [self.envs[self.lanes[self.lane_of_replica[r]].rep]
                  .values[name] for r in range(len(self.coords))]
        return ShardedValue(self.mesh, (), pieces, v.shape)

    def run(self, ctxs, feeds, state, fetch_names, out_names, nccl=False,
            sharded_feeds=()):
        """One step. `feeds`: {name: global tensor} (batch-leading ones in
        `sharded_feeds` split over the batch axis, the others replicate);
        `state`: {name: tensor or ShardedValue} (load_state's);
        returns (fetches, {name: new state}, {message: flag}). The step's
        values live on a copy of this object, so a run a watchdog
        abandoned cannot touch the next one's."""
        st = copy.copy(self)
        out = st._run(ctxs, feeds, state, fetch_names, out_names, nccl,
                      sharded_feeds)
        self.nccl_calls = st.nccl_calls
        # how each forward op of the newest run ran (local, global, rep,
        # zupdate, tp_local, tp_rep), by uid
        self.last_ran = st.ran
        return out

    def _run(self, ctxs, feeds, state, fetch_names, out_names, nccl,
             sharded_feeds):
        self.nccl = nccl
        self.nccl_calls = 0
        self.ctxs = ctxs
        self.envs = [Env(None, (), ln.device) for ln in self.lanes]
        self.place = {}
        self.zv, self.zspec, self.zshape = {}, {}, {}
        self.gcache = {}
        self.ran = {}
        self.tp_saved = {}
        grad_stop = {op.attrs["fwd_uid"]:
                     frozenset(op.attrs.get("no_grad_names", ()))
                     for op in self.program.global_block().ops
                     if op.type == "grad_of"}
        for ctx in ctxs:
            ctx.grad_stop = grad_stop
            ctx.mesh = self.mesh
        for name, full in feeds.items():
            if name in sharded_feeds:
                for ln, env in zip(self.lanes, self.envs):
                    env.values[name] = _feed_to_device(
                        self._rows(full, ln), ln.device)
                self.place[name] = "S"
            else:
                per = {r: _feed_to_device(full, self.lanes[r].device)
                       for r in self.rep_lanes}
                self._set_shared(name, per)
        for name, val in state.items():
            if isinstance(val, ShardedValue) and val.spec:
                if name in self.entry_gather:
                    self._set_shared(name, {
                        r: val.assemble(self.lanes[r].device)
                        for r in self.rep_lanes})
                else:
                    self.zv[name] = list(val.pieces)
                    self.zspec[name] = val.spec
                    self.zshape[name] = tuple(val.shape)
                    self.place[name] = "Z"
            elif isinstance(val, ShardedValue):
                self._set_shared(name, {
                    ln.rep: val.pieces[r] for r, ln in
                    enumerate(self.lanes[i] for i in self.lane_of_replica)})
            else:
                self._set_shared(name, {
                    r: val if val.device == self.lanes[r].device
                    else val.to(self.lanes[r].device)
                    for r in self.rep_lanes})
        for op in self.program.global_block().ops:
            self._exec_op(op)
        self._epilogue()
        fetches = [self.fetch(n) for n in fetch_names]
        new_state = {n: self._final_state(n) for n in out_names
                     if n in self.envs[0].values or n in self.zv}
        errors = {}
        dev0 = self.lanes[0].device
        for ctx in ctxs:
            for m, f in ctx.op_errors.items():
                errors[m] = fold_error(m, errors.get(m), f.to(dev0))
        return fetches, new_state, errors

    def _epilogue(self):
        """lower_block's end, on each lane: a tensor array left in the Env
        and the sub-blocks' overflow flag become assertions."""
        from ..ops.control_ops import TensorArray
        for ctx, env in zip(self.ctxs, self.envs):
            for name, v in list(env.values.items()):
                if isinstance(v, TensorArray):
                    ctx.add_error(ARRAY_OVERFLOW % (name, v.buffer.shape[0]),
                                  v.overflow)
            sub_err = env.values.get(PROGRAM_ERR)
            if sub_err is not None:
                ctx.add_error(SUB_BLOCK_OVERFLOW, sub_err)


def _flat_key(name, i):
    return "%s\x00%d" % (name, i)


class _LaneGroupCtx(object):
    """The per-lane _StepCtx of one captured parallel step, seen by
    MultiStepRunner as one context: the lanes share one list of random
    streams (a random op runs on one lane a device, as on one device)."""

    def __init__(self, lanes):
        self.lanes = lanes
        self.specs = lanes[0].specs
        for ctx in lanes[1:]:
            ctx.specs = self.specs
        self.op_errors = {}
        self.while_loops = []

    @property
    def op(self):
        return next((c.op for c in self.lanes if c.op is not None), None)


class _ParallelMultiStepRunner(MultiStepRunner):
    """MultiStepRunner over a _ParallelStep: the buffers hold the feeds'
    global batch and the state as the scope holds it (a split var as one
    buffer a distinct piece, named var\\x00i), and one captured step runs
    every lane, so a replay runs the whole multi-replica step with no
    host sync. Only for meshes whose replicas share one device."""

    def __init__(self, pstep, state_names, program, device, feed_names,
                 fetch_names, state_rw, state_ro, state_out, steps,
                 fetch_reduce, unread, stacked_names, sharded_feeds):
        super(_ParallelMultiStepRunner, self).__init__(
            program, device, feed_names, fetch_names, state_rw, state_ro,
            state_out, steps, fetch_reduce=fetch_reduce, unread=unread,
            stacked_names=stacked_names)
        self.pstep = pstep
        self.sharded_feeds = frozenset(sharded_feeds)
        self.state_names = list(state_names)
        self.plain_out = list(self.out_names)
        # split var -> (spec, shape, [piece number of each replica])
        self._pieces = {}
        self._lane_consts = [{} for _ in pstep.lanes]
        self._lane_while = [{} for _ in pstep.lanes]
        self.in_names = []
        self._scope_names = {}

    def _flatten(self, name, val):
        if isinstance(val, ShardedValue):
            order, seen = [], {}
            for p in val.pieces:
                if id(p) not in seen:
                    seen[id(p)] = len(order)
                    order.append(p)
            self._pieces[name] = (val.spec, tuple(val.shape),
                                  [seen[id(p)] for p in val.pieces])
            return [(_flat_key(name, i), p) for i, p in enumerate(order)]
        return [(name, val)]

    def _read_scope(self, scope):
        vals = collections.OrderedDict()
        for n in self.state_names:
            for k, v in self._flatten(n, self.pstep.load_state(scope, n)):
                vals[k] = v
        if not self.in_names:
            self.in_names = list(vals)
        return vals

    def fits(self, scope):
        if not self._built:
            return True
        for k, v in self._read_scope(scope).items():
            buf = self._bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                return False
        return True

    def _ctx(self, run_seed, gens=None):
        lanes = []
        for i, ln in enumerate(self.pstep.lanes):
            ctx = _StepCtx(self.program, self.device, run_seed, self.unread,
                           gens, while_state=self._lane_while[i],
                           constants=self._lane_consts[i])
            lanes.append(ctx)
        return _LaneGroupCtx(lanes)

    def _state_from_bufs(self):
        state = {}
        for n in self.state_names:
            if n in self._pieces:
                spec, shape, order = self._pieces[n]
                state[n] = ShardedValue(
                    self.pstep.mesh, spec,
                    [self._bufs[_flat_key(n, i)] for i in order], shape)
            else:
                state[n] = self._bufs[n]
        return state

    def _step(self, ctx, copy_back):
        feeds = {n: self._feed_bufs[n] for n in self.feed_names}
        fetches, new, errors = self.pstep.run(
            ctx.lanes, feeds, self._state_from_bufs(), self.fetch_names,
            self.plain_out, nccl=False, sharded_feeds=self.sharded_feeds)
        if any(c.while_loops for c in ctx.lanes):
            raise GraphCaptureError(
                "ParallelExecutor.run(steps=K) does not capture a While "
                "loop; run the program with steps=1")
        ctx.op_errors = errors
        flat = collections.OrderedDict()
        for n, v in new.items():
            for k, t in self._flatten(n, v):
                flat[k] = t
        if not copy_back:
            self.out_names = list(flat)
        if copy_back:
            self._copy_back(flat)
            self._fold_errors(errors)
        return fetches, flat

    def unflatten(self, flat):
        """The runner's new state as the scope takes it."""
        out = {}
        for n in self.plain_out:
            if n in self._pieces:
                spec, shape, order = self._pieces[n]
                out[n] = ShardedValue(
                    self.pstep.mesh, spec,
                    [flat[_flat_key(n, i)] for i in order], shape)
            elif n in flat:
                out[n] = flat[n]
        return out


class ParallelExecutor(object):
    """Data-parallel (and ZeRO, tensor-parallel "gather" and "compute",
    sequence-, pipeline- and expert-parallel) training over a device
    mesh, from one controller.

    use_cuda (default True) takes every local CUDA device; use_cuda=False
    or devices=["cpu"] * n the CPU (one replica, or n). `mesh` (a
    parallel.Mesh) overrides both. `param_shardings`, `sharded_weight_
    update`, `shard_axis`, `tp_axis` and `plan` configure the
    ShardingPlan as in the JAX package; `check_nan_inf` sweeps every
    run's fetches and new state (FLAGS_check_nan_inf by default).
    num_threads and allow_op_delay are accepted and ignored."""

    def __init__(self, use_cuda=None, loss_name=None, main_program=None,
                 num_threads=None, allow_op_delay=False, share_vars_from=None,
                 use_tpu=None, devices=None, mesh=None, param_shardings=None,
                 batch_axis=None, check_nan_inf=None,
                 sharded_weight_update=False, plan=None, shard_axis=None,
                 tp_axis=None):
        self._program = main_program if main_program is not None \
            else default_main_program()
        self.loss_name = loss_name
        if plan is not None:
            if mesh is not None and mesh != plan.mesh:
                raise ValueError(
                    "plan= was built over mesh %r but mesh= is %r — "
                    "pass one or the other"
                    % (dict(plan.mesh.shape), dict(mesh.shape)))
            if param_shardings or sharded_weight_update \
                    or shard_axis is not None or tp_axis is not None:
                raise ValueError(
                    "plan= already decides param_shardings / "
                    "sharded_weight_update / shard_axis / tp_axis; "
                    "build the plan with those (ShardingPlan.build) "
                    "instead of passing both")
            if batch_axis is not None and batch_axis != plan.batch_axis:
                raise ValueError(
                    "plan= was built with batch_axis=%r but "
                    "batch_axis=%r was passed — the plan decides"
                    % (plan.batch_axis, batch_axis))
            mesh = plan.mesh
        if mesh is None:
            if devices is None and use_cuda is False:
                devices = ["cpu"]
            mesh = data_parallel_mesh(devices=devices)
        self.mesh = mesh
        self._batch_axis = plan.batch_axis if plan is not None \
            else (batch_axis if batch_axis is not None else "dp")
        if plan is None:
            if shard_axis is None:
                from .distributed import active_layout
                lay = active_layout()
                shard_axis = getattr(lay, "shard_axis", None) \
                    if lay is not None else None
                if shard_axis is not None \
                        and shard_axis not in self.mesh.axis_names:
                    shard_axis = None
            plan = ShardingPlan.build(
                self._program, self.mesh, batch_axis=self._batch_axis,
                shard_axis=shard_axis, shard_update=sharded_weight_update,
                overrides=param_shardings, tp_axis=tp_axis)
        self.plan = plan
        self._param_shardings = plan.spec_map()
        self._check_nan_inf = _nan_inf_enabled(check_nan_inf)
        self._array_safety = array_safety_enabled()
        self.flag_reads = 0
        self.last_stats = {}
        self._scope = global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self._prefetcher = None
        self._has_read = {}
        self._has_host_io = {}
        self._steps = {}           # analysis key -> _ParallelStep
        self._cache = collections.OrderedDict()   # multi-step runners
        self._unread = {}
        self._state_names = {}   # (program, fetches, feeds) -> state
        # the transport each collective of the newest run went through
        self.last_transport = None
        self.last_nccl_calls = 0
        feeds = [v.name for v in self._program.list_vars()
                 if getattr(v, "is_data", False) and _var_batch_leading(v)]
        self._step_for(self._program, frozenset(feeds))

    @property
    def device_count(self):
        return self.mesh.size

    @property
    def lead_device(self):
        return self.mesh.devices.flat[0]

    def _step_for(self, program, sharded_feeds):
        key = (program._uid, program._version, sharded_feeds)
        st = self._steps.get(key)
        if st is None:
            dp = int(self.mesh.shape.get(self._batch_axis, 1))
            kinds, lead = analyze_batch_placement(program, dp,
                                                  sharded_feeds)
            st = _ParallelStep(program, self.mesh, self.plan,
                               self._batch_axis, kinds, lead)
            self._steps[key] = st
        return st

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            steps=1, fetch_reduce="stack", timeout=None, prefetch=False):
        """One global step (or steps=K of them) over the mesh. The batch-
        leading feeds split over the batch axis (their batch must divide
        evenly across it), the others replicate. Returns the fetches'
        global values. timeout=SECONDS runs the call under the watchdog
        (DispatchTimeoutError past the deadline); prefetch=True stages
        the next call's reader records while this call's work runs, as
        Executor.run does."""
        args = (fetch_list, feed if feed is not None else (feed_dict or {}),
                return_numpy, steps, fetch_reduce, prefetch)
        if timeout is None:
            return self._run_impl(*args)
        return dispatch_with_deadline(
            lambda cancelled, info: self._run_impl(
                *args, cancelled=cancelled, info=info),
            timeout, "ParallelExecutor.run dispatch")

    def _run_impl(self, fetch_list, feed, return_numpy, steps, fetch_reduce,
                  prefetch, cancelled=None, info=None):
        return run_step_traced(
            "pexe", cancelled,
            lambda tspan: self._run_traced(
                fetch_list, feed, return_numpy, steps, fetch_reduce,
                prefetch, cancelled, info, tspan),
            devices=int(self.mesh.size))

    def _run_traced(self, fetch_list, feed, return_numpy, steps,
                    fetch_reduce, prefetch, cancelled, info, tspan):
        program = self._program
        scope = self._scope
        steps = int(steps)
        if steps < 1:
            raise ValueError("steps must be >= 1, got %r" % (steps,))
        if fetch_reduce not in FETCH_REDUCE_POLICIES:
            raise ValueError("fetch_reduce must be one of %r, got %r"
                             % (FETCH_REDUCE_POLICIES, fetch_reduce))
        tspan.set(program=str(program._uid), version=int(program._version),
                  steps=steps)
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        feeds = {}
        for name, value in convert_feeds(program, feed).items():
            var = find_var(program, name)
            feeds[name] = to_tensor(value,
                                    var.dtype if var is not None else None)
        _dispatch.run_dispatch_hooks(program, steps, feeds,
                                     prefetcher=self._prefetcher,
                                     cancelled=cancelled)
        if cancelled is not None and cancelled.is_set():
            return None
        dp = int(self.mesh.shape.get(self._batch_axis, 1))

        def _batch_leading(name, t, stacked):
            return _var_batch_leading(find_var(program, name)) and \
                t.dim() >= (2 if stacked else 1)

        for name, t in feeds.items():
            if _batch_leading(name, t, False) and t.shape[0] % dp:
                raise ValueError(
                    "batch size %d of feed %r must divide evenly across the "
                    "%d-way %r axis" % (t.shape[0], name, dp,
                                        self._batch_axis))
        stacked = set()
        if _dispatch.has_host_io_ops(program, self._has_host_io) or (
                self._prefetcher is not None and
                self._prefetcher.has_work()):
            staged = _dispatch.consume_host_io(
                self, program, scope, steps, cancelled, feeds, stacked,
                tspan, device=self.lead_device)
            if staged is _dispatch.CANCELLED or (
                    cancelled is not None and cancelled.is_set()):
                return None
        sharded = set()
        for name, t in feeds.items():
            st = name in stacked
            if _batch_leading(name, t, st):
                rows = t.shape[1] if st else t.shape[0]
                if rows % dp:
                    raise ValueError(
                        "batch size %d of reader record field %r must "
                        "divide evenly across the %d-way %r axis"
                        % (rows, name, dp, self._batch_axis))
                sharded.add(name)
        pstep = self._step_for(program, frozenset(sharded))
        key = (program._uid, program._version, _feed_signature(feeds),
               tuple(fetch_names), steps,
               fetch_reduce if steps > 1 else None, bool(program._amp),
               tuple(sorted(stacked)))
        if info is not None:
            info["cache_key"] = key
        ukey = (program._uid, program._version, tuple(fetch_names))
        if ukey not in self._unread:
            self._unread[ukey] = unread_outputs(program, fetch_names)
        unread = self._unread[ukey]
        skey = ukey + (tuple(sorted(feeds)),)
        if skey not in self._state_names:
            rw, ro, out = analyze_state(program, list(feeds), fetch_names)
            glob = {n for op in program.global_block().ops
                    if op.type not in HOST_IO_OPS
                    for n in op.all_output_vars() if n}
            self._state_names[skey] = (rw, ro, out,
                                       [n for n in out if n in glob])
        state_rw, state_ro, state_out, out_names = self._state_names[skey]
        if steps == 1:
            seed = scope.next_seed()
            state = {n: pstep.load_state(scope, n)
                     for n in state_rw + state_ro}
            ctxs = [LowerCtx(program, ln.device, run_seed=seed,
                             unread=unread) for ln in pstep.lanes]
            nccl = pstep.lanes[0].device.type == "cuda" and (
                not pstep.single_device or self.mesh.size == 1)
            with torch.no_grad():
                fetches, new_state, errors = pstep.run(
                    ctxs, feeds, state, fetch_names, out_names, nccl=nccl,
                    sharded_feeds=sharded)
            self.last_transport = "nccl" if nccl else "torch"
            self.last_nccl_calls = pstep.nccl_calls
        else:
            if not pstep.single_device:
                raise GraphCaptureError(
                    "ParallelExecutor.run(steps=%d) over distinct cards "
                    "(%s) is not captured yet: the captured multi-replica "
                    "step needs every replica on one device (the open item "
                    "of ROADMAP A10's second half); run steps=1"
                    % (steps, [str(d) for d in
                               self.mesh.distinct_devices()]))
            runner = self._runner(key, pstep, program, scope, feeds,
                                  fetch_names, steps, fetch_reduce, unread,
                                  stacked, sharded,
                                  (state_rw, state_ro, state_out))
            fetches, flat, errors = runner(
                scope, feeds, scope.next_seed_block(steps))
            new_state = runner.unflatten(flat)
            self.last_transport = "torch"
            self.last_nccl_calls = 0
        if cancelled is not None:
            dev = self.lead_device
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                done.synchronize()
            if cancelled.is_set():
                return None
        for name, value in new_state.items():
            scope.set(name, value)
        if prefetch:
            _dispatch.kick_next_prepass(self, program, scope, steps,
                                        cancelled, "pexe",
                                        device=self.lead_device)
        check = {}
        for n, v in new_state.items():
            if isinstance(v, ShardedValue):
                for i, p in enumerate(v.pieces):
                    check["%s[replica %d]" % (n, i)] = p
            else:
                check[n] = v
        _dispatch.run_post_dispatch_checks(self, errors, fetches,
                                           fetch_names, check,
                                           "ParallelExecutor.run",
                                           cancelled)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def _runner(self, key, pstep, program, scope, feeds, fetch_names, steps,
                fetch_reduce, unread, stacked, sharded, state):
        runner = self._cache.get(key)
        if runner is not None and runner.fits(scope):
            self._cache.move_to_end(key)
            return runner
        state_rw, state_ro, state_out = state
        runner = _ParallelMultiStepRunner(
            pstep, state_rw + state_ro, program, self.lead_device,
            sorted(feeds), fetch_names, state_rw, state_ro, state_out,
            steps, fetch_reduce, unread, stacked, sharded)
        _cache_put_lru(self._cache, key, runner, _jit_cache_capacity())
        return runner
