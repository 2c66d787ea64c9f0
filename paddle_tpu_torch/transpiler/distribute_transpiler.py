"""DistributeTranspiler: parameter-server distribution over a mesh.

Parity: python/paddle/fluid/distribute_transpiler.py (VarBlock,
split_dense_variable, DistributeTranspiler.transpile/get_trainer_program/
get_pserver_program/get_startup_program) + distributed_spliter.py, and
the JAX package's transpiler/distribute_transpiler.py, whose programs this
builds byte for byte.

The reference rewrites the program into trainer programs that `send`
gradient blocks to pserver processes, where per-block optimizer ops update
parameter slices (`listen_and_serv`). The same contract runs here as
sharded-optimizer data parallelism: parameter blocks map to shards of a
mesh axis (`parameter_shardings()`), and a ParallelExecutor sums each
gradient over the batch axis onto the owner's shard, runs the update on
the shard and gathers the param at the next step. The program-rewriting
API is kept whole (block splitting, placement policies, per-endpoint
pserver programs that really execute): it defines the semantics and lets
tests hold the sharded update to the monolithic one.
"""
import numpy as np

from ..core.framework import Program, default_main_program
from ..core.registry import register
from . import distributed_spliter

__all__ = ["VarBlock", "split_dense_variable", "DistributeTranspiler",
           "same_or_split_var"]

# op types that update a parameter in place (inputs Param+Grad)
_UPDATE_OP_TYPES = frozenset([
    "sgd", "momentum", "adagrad", "adam", "adamax", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl",
])
# per-update-op companion ops that touch only optimizer-global state
_OPT_COMPANION_TYPES = frozenset(["adam_beta_pow_update"])


@register("send")
def _send(ctx, ins, attrs):
    """Marker op. The reference's send_op ships gradient blocks over gRPC
    (operators/send_op.cc); under a ParallelExecutor the gradient exchange
    is its batch-axis sum onto the owner's shard, so running it does
    nothing."""
    return {}


def _recv_special(ctx, op, env):
    """Placement marker (reference operators/recv_op.cc): the 'fetched'
    parameters are already device-resident state, so running it checks
    they exist."""
    for n in op.outputs.get("Out", ()):
        if n not in env.values and not (
                env._scope is not None and n in env._persistable and
                env._scope.get_raw(n) is not None):
            raise ValueError(
                "recv of %r: variable has no value — parameters must be "
                "initialized (startup program) before a recv marker" % n)


register("recv", _recv_special, special=True)


@register("listen_and_serv")
def _listen_and_serv(ctx, ins, attrs):
    """Marker op (operators/listen_and_serv_op.cc). No server loop: the
    pserver program's optimize block runs directly."""
    return {}


def _host(value):
    """A scope value (a tensor on any device, or a host array) as numpy."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class VarBlock(object):
    """A contiguous slice of a flattened variable: (varname, offset, size)."""

    def __init__(self, varname, offset, size):
        self.varname = varname
        self.offset = offset
        self.size = size

    def __str__(self):
        return "%s:%d:%d" % (self.varname, self.offset, self.size)


def split_dense_variable(var_list, service_count, min_block_size=1024):
    """Split each variable into roughly service_count aligned blocks.

    Same contract as the reference's split_dense_variable: variables smaller
    than min_block_size stay whole; otherwise aim for one block per service,
    each a multiple of the trailing-dim size so slices stay row-aligned.
    (The reference's max_block_size cap is dropped: blocks here are sharding
    metadata, not RPC payloads, so there is no upper size constraint.)
    """
    blocks = []
    for var in var_list:
        numel = int(np.prod(var.shape))
        split_count = service_count
        block_size = (numel + split_count - 1) // split_count
        # never split below min_block_size (fewer, larger blocks instead)
        block_size = max(block_size, min_block_size)
        # align to whole rows so optimizer slices keep row semantics
        if len(var.shape) >= 2:
            dim1 = int(np.prod(var.shape[1:]))
            remains = block_size % dim1
            if remains != 0:
                block_size += dim1 - remains
        if numel <= min_block_size:
            block_size = numel
        block_size = min(block_size, numel)
        split_count = (numel + block_size - 1) // block_size
        for block_id in range(split_count):
            curr = min(block_size, numel - block_id * block_size)
            blocks.append(VarBlock(var.name, block_id * block_size, curr))
    return blocks


def same_or_split_var(p_name, var_name):
    return p_name == var_name or p_name.startswith(var_name + ".block")


def _block_var_name(varname, block_id):
    return "%s.block%d" % (varname, block_id)


class DistributeTranspiler(object):
    """Rewrites a trained Program for parameter-server execution.

    Usage (same call sequence as the reference):
        t = DistributeTranspiler()
        t.transpile(trainer_id, program=main, pservers="ep0,ep1", trainers=2)
        trainer_prog = t.get_trainer_program()
        pserver_prog = t.get_pserver_program("ep0")
        startup = t.get_startup_program("ep0", pserver_prog)
    Mesh execution: ParallelExecutor(param_shardings=
        t.parameter_shardings(mesh)) — see the module docstring.
    """

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, split_method=distributed_spliter.round_robin):
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.program = program if program is not None \
            else default_main_program()
        self.pserver_endpoints = [ep.strip() for ep in pservers.split(",")]

        block0 = self.program.global_block()
        self.update_ops = [op for op in block0.ops
                           if op.type in _UPDATE_OP_TYPES]
        self.companion_ops = [op for op in block0.ops
                              if op.type in _OPT_COMPANION_TYPES]
        self.param_grad_map = {}   # param name -> grad name
        self.param_update_op = {}  # param name -> update op
        for op in self.update_ops:
            p = op.input("Param")[0]
            self.param_grad_map[p] = op.input("Grad")[0]
            self.param_update_op[p] = op

        params = [block0.var(p) for p in self.param_grad_map]
        self.param_blocks = split_dense_variable(
            params, len(self.pserver_endpoints))
        # endpoint per block, chosen by the placement policy
        self.eplist = split_method(
            [str(b) for b in self.param_blocks], self.pserver_endpoints)
        # per-param ordered blocks with ids
        self.blocks_of = {}
        for blk, ep in zip(self.param_blocks, self.eplist):
            self.blocks_of.setdefault(blk.varname, []).append((blk, ep))
        return self

    # ----------------------------------------------------------------- trainer
    def get_trainer_program(self):
        """The forward+backward program: update ops replaced by one `send`
        marker carrying the grad→endpoint placement (epmap)."""
        prog = self.program.clone()
        block = prog.global_block()
        drop = _UPDATE_OP_TYPES | _OPT_COMPANION_TYPES
        block.ops = [op for op in block.ops if op.type not in drop]
        epmap = {}
        for blk, ep in zip(self.param_blocks, self.eplist):
            epmap.setdefault(self.param_grad_map[blk.varname], []).append(ep)
        block.append_op(
            type="send",
            inputs={"X": sorted(self.param_grad_map.values())},
            outputs={},
            attrs={"endpoints": self.pserver_endpoints,
                   "epmap": {k: list(v) for k, v in epmap.items()},
                   "sync_mode": True},
            infer_shape=False)
        prog._bump_version()
        return prog

    # ----------------------------------------------------------------- pserver
    def _slice_accumulator_inputs(self, op, param_shape):
        """Input/output slots of an update op holding per-param state
        (Velocity/Moment/…): these must be sliced like the param itself.

        Per-param accumulators are identified by NAME (Optimizer
        ._add_accumulator embeds the param name in the accumulator's name),
        not by numel — a numel match would misclassify scalar optimizer
        state (Beta1Pow/LearningRate) for size-1 parameters and freeze it
        in a never-updated block copy."""
        pname = op.input("Param")[0]
        sliced = set()
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad", "LearningRate"):
                continue
            if any(pname in n for n in names):
                sliced.add(slot)
        return sliced

    def get_pserver_program(self, endpoint):
        """A Program holding this endpoint's parameter blocks and the
        optimizer ops that update them (operating on 1-D slices — every
        update rule is shape-polymorphic, reference
        _append_pserver_ops reshapes the same way)."""
        prog = Program()
        block = prog.global_block()
        block0 = self.program.global_block()

        # optimizer-global scalars (lr, beta pows) are replicated on every
        # pserver, like the reference clones them per pserver program
        copied_scalars = {}

        def _copy_scalar_var(name):
            if name in copied_scalars:
                return copied_scalars[name]
            src = block0.var(name)
            v = block.create_var(name=name, shape=src.shape, dtype=src.dtype,
                                 persistable=True)
            copied_scalars[name] = v
            return v

        my_blocks = []
        for blk, ep, bid in self._numbered_blocks():
            if ep != endpoint:
                continue
            my_blocks.append((blk, bid))
            param = block0.var(blk.varname)
            op = self.param_update_op[blk.varname]
            sliced_slots = self._slice_accumulator_inputs(op, param.shape)

            def blockvar(name, base=blk, b=bid):
                return block.create_var(
                    name=_block_var_name(name, b), shape=[base.size],
                    dtype="float32", persistable=True)

            pvar = blockvar(blk.varname)
            gvar = block.create_var(
                name=_block_var_name(self.param_grad_map[blk.varname], bid),
                shape=[blk.size], dtype="float32", persistable=False)
            ins, outs = {}, {}
            for slot, names in op.inputs.items():
                if slot == "Param":
                    ins[slot] = [pvar]
                elif slot == "Grad":
                    ins[slot] = [gvar]
                elif slot in sliced_slots:
                    ins[slot] = [blockvar(names[0])]
                else:
                    ins[slot] = [_copy_scalar_var(n) for n in names]
            for slot, names in op.outputs.items():
                if slot == "ParamOut":
                    outs[slot] = [pvar]
                elif slot in ("LearningRateOut",):
                    outs[slot] = [_copy_scalar_var(names[0])]
                else:
                    # accumulator out slot ↔ its (sliced) input var
                    bname = _block_var_name(names[0], bid)
                    outs[slot] = [block.vars[bname] if bname in block.vars
                                  else _copy_scalar_var(names[0])]
            block.append_op(type=op.type, inputs=ins, outputs=outs,
                            attrs=dict(op.attrs), infer_shape=False)

        # companion ops (adam beta-pow bump) run once per pserver
        for op in self.companion_ops:
            ins = {s: [_copy_scalar_var(n) for n in ns]
                   for s, ns in op.inputs.items()}
            outs = {s: [_copy_scalar_var(n) for n in ns]
                    for s, ns in op.outputs.items()}
            block.append_op(type=op.type, inputs=ins, outputs=outs,
                            attrs=dict(op.attrs), infer_shape=False)

        block.append_op(
            type="listen_and_serv", inputs={}, outputs={},
            attrs={"endpoint": endpoint,
                   "ParamList": [_block_var_name(b.varname, i)
                                 for b, i in my_blocks],
                   "GradList": [_block_var_name(
                       self.param_grad_map[b.varname], i)
                       for b, i in my_blocks],
                   "Fanin": self.trainer_num},
            infer_shape=False)
        return prog

    def _numbered_blocks(self):
        """Yield (VarBlock, endpoint, global block id within its param)."""
        counters = {}
        for blk, ep in zip(self.param_blocks, self.eplist):
            bid = counters.get(blk.varname, 0)
            counters[blk.varname] = bid + 1
            yield blk, ep, bid

    def get_startup_program(self, endpoint, pserver_program):
        """Init program for one pserver: fill each owned block (+sliced
        accumulators) and the replicated scalars with zeros; real values are
        scattered from the trainer-side startup scope (see scatter_scope)."""
        prog = Program()
        block = prog.global_block()
        for name, var in pserver_program.global_block().vars.items():
            if not var.persistable:
                continue
            block.create_var(name=name, shape=var.shape, dtype=var.dtype,
                             persistable=True)
            block.append_op(
                type="fill_constant",
                inputs={},
                outputs={"Out": [block.vars[name]]},
                attrs={"shape": list(var.shape or [1]), "value": 0.0,
                       "dtype": var.dtype},
                infer_shape=False)
        return prog

    # ------------------------------------------------------- mesh placement
    def parameter_shardings(self, mesh, axis=None):
        """PartitionSpecs implementing the pserver placement on a mesh:
        every split parameter (and its param-shaped optimizer state)
        shards dim 0 over `axis`; a ParallelExecutor sums gradients onto
        the owning shard and gathers params for the forward — the pserver
        dataflow, between the replicas."""
        from ..parallel.mesh import P
        axis = axis or mesh.axis_names[0]
        n = mesh.shape[axis]
        block0 = self.program.global_block()
        shardings = {}
        for pname in self.param_grad_map:
            var = block0.var(pname)
            if not var.shape or var.shape[0] % n != 0 or \
                    len(self.blocks_of.get(pname, [])) <= 1:
                continue  # unsplit params stay replicated, like 1-block vars
            spec = P(*([axis] + [None] * (len(var.shape) - 1)))
            shardings[pname] = spec
            op = self.param_update_op[pname]
            for slot in self._slice_accumulator_inputs(op, var.shape):
                shardings[op.input(slot)[0]] = spec
        return shardings

    # ----------------------------------------------------- simulation helpers
    def scatter_scope(self, trainer_scope, pserver_scope, endpoint,
                      pserver_program):
        """Copy this endpoint's param/accumulator slices (and scalars) from a
        fully-initialized trainer scope into a pserver scope."""
        for name, var in pserver_program.global_block().vars.items():
            if not var.persistable:
                continue
            if ".block" in name:
                base, bid = name.rsplit(".block", 1)
                # locate the VarBlock by (base varname, block id); accumulator
                # vars share their param's block geometry
                b = next(b for b, _, i in self._numbered_blocks_for(base)
                         if i == int(bid))
                flat = _host(trainer_scope.get(base)).reshape(-1)
                pserver_scope.set(name, flat[b.offset:b.offset + b.size])
            else:
                pserver_scope.set(name, _host(trainer_scope.get(name)))

    def _numbered_blocks_for(self, varname):
        """(VarBlock, endpoint, id) for a param, its grad, OR its accumulator
        (grads/accumulators share their param's block geometry)."""
        base = None
        for p in self.param_grad_map:
            op = self.param_update_op[p]
            names = [n for ns in op.inputs.values() for n in ns] + \
                    [n for ns in op.outputs.values() for n in ns]
            if varname == p or varname in names:
                base = p
                break
        if base is None:
            base = varname
        for blk, ep, bid in self._numbered_blocks():
            if blk.varname == base:
                yield blk, ep, bid

    def gather_scope(self, pserver_scopes, trainer_scope):
        """Reassemble updated params from pserver scopes back into the
        trainer scope (the reference's recv/get path)."""
        block0 = self.program.global_block()
        for pname in self.param_grad_map:
            flat = _host(trainer_scope.get(pname)).reshape(-1).copy()
            for blk, ep, bid in self._numbered_blocks():
                if blk.varname != pname:
                    continue
                src = pserver_scopes[ep].get(_block_var_name(pname, bid))
                flat[blk.offset:blk.offset + blk.size] = _host(src)
            trainer_scope.set(
                pname, flat.reshape(block0.var(pname).shape))
