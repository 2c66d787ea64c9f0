"""Program interpreter: runs a Block op by op over torch tensors.

Parity: the reference's op-by-op interpreter (paddle/fluid/framework/
executor.cc: Executor::RunPreparedContext walks the BlockDesc and launches
a kernel per OpDesc). The JAX package traces the whole Program into one XLA
computation instead (its core/lowering.py); PyTorch runs eagerly, so here
each op's rule is called in program order and its outputs land in an Env —
the same names, the same rules, no trace.

Gradients: core/backward.py appends one `grad_of` op per differentiated
forward op, as in the JAX package. There the grad op replays the forward
rule inside `jax.vjp` and XLA's CSE removes the duplicate forward; eager
PyTorch has no CSE, so replaying would run every forward op (and launch
every kernel) twice. Instead, a forward op that some `grad_of` of the run
names by `fwd_uid` runs its rule under autograd, on detached float inputs
that require grad, and keeps (those leaf inputs, its outputs); its
`grad_of` calls `torch.autograd.grad` on them once and drops them. Every
other op, and every run without `grad_of` ops (inference), runs under
`torch.no_grad()`.

Sub-blocks: a control-flow op (rnn_scan, ops/control_ops.py) runs its
body through `lower_sub_block`, inside its own rule. The body's ops are
part of that one op: they run under whatever grad mode the op runs in,
keep no graphs of their own, and leave the run's `grad_of` table alone.
"""
import torch

from . import registry
from .framework import GRAD_SUFFIX


class LowerCtx(object):
    """Per-run context handed to op rules: the run's device, a seeded
    random generator per op, and which outputs of the running op some op,
    fetch or the scope reads (`output_read`)."""

    is_abstract = False

    def __init__(self, program, device, run_seed=0, is_startup=False,
                 unread=frozenset()):
        self.program = program
        self.device = device
        self.run_seed = int(run_seed)
        self.is_startup = is_startup
        # names of global-block outputs nothing reads (unread_outputs)
        self.unread = unread
        self._op_salt = 0
        self._op_calls = 0
        self._op_outputs = None
        # the iteration index of each enclosing loop (rnn_scan pushes its
        # step), folded into every random op's seed
        self._loop_iters = []
        # the forward ops some grad_of of this run differentiates (uid ->
        # that grad_of's no_grad_names), and their kept local graphs: uid ->
        # ({(slot, i): leaf input}, {name: output}), from the forward op's
        # run until its grad_of
        self.grad_stop = {}
        self.saved = {}

    def begin_op(self, salt, outputs=None):
        self._op_salt = salt
        self._op_calls = 0
        self._op_outputs = outputs

    def output_read(self, slot):
        """Whether the running op's `slot` output is read by some op, a
        fetch or the scope. False only when every name of the slot is in
        `unread`; True for a rule run outside an op (no names known)."""
        names = (self._op_outputs or {}).get(slot)
        if names is None:
            return True
        return any(n and n not in self.unread for n in names)

    def rng(self, salt=0, seed=0):
        """A torch.Generator on the run's device, seeded from (program
        seed, run seed, op uid, call index within the op). A nonzero user
        `seed` (the op's seed attr — fluid's reproducibility contract)
        pins the stream independent of the run counter. Inside a loop
        body each enclosing loop's iteration is folded in after that, the
        user seed too (as the JAX package's rng folds its loop stack), so
        a random op in an RNN step draws anew at every step. The streams
        are the port's own: they do not reproduce the JAX package's
        bits."""
        self._op_calls += 1
        if seed:
            base = int(seed)
        else:
            base = int(getattr(self.program, "random_seed", 0) or 0) \
                * 1000003 + self.run_seed
        mask = 0x7FFFFFFFFFFFFFFF
        s = (base * 1000003 + self._op_salt * 97 + self._op_calls * 7
             + salt) & mask
        for it in self._loop_iters:
            s = (s * 1000003 + it + 1) & mask
        g = torch.Generator(device=self.device)
        g.manual_seed(s)
        return g


class EnvReadError(KeyError):
    """Env.read miss: a variable read before anything wrote it."""


class Env(object):
    """Name -> tensor mapping for one run. A persistable var that no op of
    this run has written yet reads through to the Scope (parameters), moved
    to the run's device."""

    def __init__(self, scope=None, persistable=(), device=None):
        self.values = {}
        self._scope = scope
        self._persistable = persistable
        self._device = device

    def read(self, name):
        if name in self.values:
            return self.values[name]
        if self._scope is not None and name in self._persistable:
            v = self._scope.get(name)
            if v is not None:
                v = v.to(self._device)
                self.values[name] = v
                return v
        raise EnvReadError("variable %r read before it was written; "
                           "is it fed / initialized?" % name)

    def write(self, name, value):
        self.values[name] = value

    def accumulate(self, name, value):
        """values[name] += value, into a new tensor: a kept graph may still
        read the old one."""
        cur = self.values.get(name)
        self.values[name] = value if cur is None else cur + value


def unread_outputs(program, fetch_names=()):
    """The outputs of `program`'s global-block ops that nothing reads in a
    run fetching `fetch_names`: no op of any block lists them as an input,
    no grad_of reads their gradient (it differentiates a forward output
    through that output when its <out>@GRAD is among its inputs), no fetch
    names them and they are not persistable. A rule may skip building them
    (the JAX package leaves that to XLA's dead-code elimination)."""
    read = set(fetch_names)
    for blk in program.blocks:
        for op in blk.ops:
            names = op.all_input_vars()
            read.update(names)
            if op.type == "grad_of":
                grads = set(names)
                read.update(n for outs in op.attrs["fwd_outputs"].values()
                            for n in outs if n + GRAD_SUFFIX in grads)
    read.update(v.name for v in program.list_vars() if v.persistable)
    return frozenset(n for op in program.global_block().ops
                     for n in op.all_output_vars() if n and n not in read)


def lower_block(ctx, block, env):
    """Run a program's global block: its `grad_of` ops name the forward
    ops that keep their local graphs in this run."""
    ctx.grad_stop = {op.attrs["fwd_uid"]:
                     frozenset(op.attrs.get("no_grad_names", ()))
                     for op in block.ops if op.type == "grad_of"}
    lower_sub_block(ctx, block, env)


def lower_sub_block(ctx, block, env):
    """Run `block`'s ops in order in `env`. A control-flow op runs its body
    through this, not lower_block: the run's grad_of table (ctx.grad_stop)
    belongs to the global block and must outlive the body, or every
    forward op after the control-flow op would keep no graph."""
    for op in block.ops:
        lower_op(ctx, op, env)


def lower_op(ctx, op, env):
    try:
        _lower_op_inner(ctx, op, env)
    except EnvReadError as e:
        raise RuntimeError("%s\n  [while running op %r (uid %d)]"
                           % (e.args[0], op.type, op.uid)) from e
    except Exception as e:
        if e.args and isinstance(e.args[0], str):
            e.args = (e.args[0] + "\n  [while running op %r (uid %d)]"
                      % (op.type, op.uid),) + e.args[1:]
        raise


def _lower_op_inner(ctx, op, env):
    if op.type == "grad_of":
        _lower_grad_of(ctx, op, env)
        return
    od = registry.get(op.type)
    ins = {slot: [env.read(n) for n in names]
           for slot, names in op.inputs.items()}
    ctx.begin_op(op.uid, op.outputs)
    stop = ctx.grad_stop.get(op.uid)
    if stop is None:
        _write_outputs(op, od.lower(ctx, ins, op.attrs), env)
        return
    # keep this op's local graph for its grad_of: leaves are the float
    # inputs the gradient may reach (not the program's no-grad names)
    leaves = {}
    for slot, names in op.inputs.items():
        for i, name in enumerate(names):
            v = ins[slot][i]
            if v.is_floating_point() and name not in stop:
                leaves[(slot, i)] = ins[slot][i] = \
                    v.detach().requires_grad_(True)
    with torch.enable_grad():
        outs = od.lower(ctx, ins, op.attrs)
    kept = {}
    for slot, names in op.outputs.items():
        for name, val in zip(names, outs.get(slot) or ()):
            if name and val is not None and val.requires_grad:
                kept[name] = val
    ctx.saved[op.uid] = (leaves, kept)
    _write_outputs(op, {slot: [v.detach() if v is not None else v
                               for v in vals]
                        for slot, vals in outs.items()}, env)


def _write_outputs(op, outs, env):
    acc = op.attrs.get("__accumulate_outputs__", False)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if not name:
                continue
            if acc:
                env.accumulate(name, val)
            else:
                env.write(name, val)


# Forward op types whose gradient is hand-written rather than autograd's
# (parity: the JAX package's SPECIAL_GRADS, whose one entry is a LoD op
# the port does not have yet). backward.py reads the same table.
SPECIAL_GRADS = {}


def _lower_grad_of(ctx, op, env):
    """Input gradients of one forward op, from its kept local graph.

    The JAX contract (its core/lowering.py _lower_grad_of): the cotangent
    of each forward output is <out>@GRAD, broadcast to the output's shape
    (an output with no such var contributes nothing, as a zero cotangent
    would); only float inputs are differentiated; inputs named in
    no_grad_names get nothing; every other input's gradient is ADDED to
    <in>@GRAD (backward.py emits grad ops in reverse topological order,
    so fan-out sums)."""
    fwd_type = op.attrs["fwd_type"]
    if fwd_type in SPECIAL_GRADS:
        SPECIAL_GRADS[fwd_type]["fn"](ctx, op, env)
        return
    uid = op.attrs["fwd_uid"]
    if uid not in ctx.saved:
        raise RuntimeError("grad_of %r (fwd uid %d): the forward op kept no "
                           "graph in this run" % (fwd_type, uid))
    leaves, kept = ctx.saved.pop(uid)
    fwd_inputs = op.attrs["fwd_inputs"]
    outs, cots = [], []
    for slot, names in sorted(op.attrs["fwd_outputs"].items()):
        for name in names:
            g = env.values.get(name + GRAD_SUFFIX) if name else None
            p = kept.get(name)
            if g is None or p is None:
                continue
            g = g.to(p.dtype)
            if g.shape != p.shape:
                g = g.broadcast_to(p.shape)
            outs.append(p)
            cots.append(g)
    keys = list(leaves)
    grads = [None] * len(keys)
    if outs and keys:
        grads = torch.autograd.grad(outs, [leaves[k] for k in keys], cots,
                                    allow_unused=True)
    # the leaves are the forward op's float inputs outside no_grad_names
    for (slot, i), g in zip(keys, grads):
        if g is None:
            g = torch.zeros_like(leaves[(slot, i)])
        env.accumulate(fwd_inputs[slot][i] + GRAD_SUFFIX, g)
