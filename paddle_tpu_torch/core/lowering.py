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
import time
import weakref

import numpy as np
import torch

from . import registry
from .framework import GRAD_SUFFIX
from .readers import HOST_IO_OPS

# bf16 mixed precision (Program.enable_mixed_precision), the JAX package's
# tables (its core/lowering.py): the contractions take bf16 operands (f32
# accumulation: cuBLAS and cuDNN accumulate bf16 products in f32) and
# return bf16, which then flows through the elementwise and norm ops
# between them (batch_norm and layer_norm keep f32 statistics whatever
# their input); the numerically sensitive ops take their float inputs
# back up to f32, so the loss path never rounds through bf16.
_AMP_BF16_OPS = frozenset({
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "mul", "matmul",
    "fused_attention"})
_AMP_F32_OPS = frozenset({
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "mean"})


def _amp_cast_ins(ins, dtype, from_dtype):
    return {slot: [v.to(dtype) if v is not None and v.dtype == from_dtype
                   else v for v in vals]
            for slot, vals in ins.items()}


def _apply_amp(op_type, ins):
    """An op's inputs as mixed precision runs it: f32 -> bf16 for the
    contractions, bf16 -> f32 for the sensitive ops, else as they are.
    The casts run inside the op's kept graph, so an f32 master parameter
    receives an f32 gradient."""
    if op_type in _AMP_BF16_OPS:
        return _amp_cast_ins(ins, torch.bfloat16, torch.float32)
    if op_type in _AMP_F32_OPS:
        return _amp_cast_ins(ins, torch.float32, torch.bfloat16)
    return ins


class LowerCtx(object):
    """Per-run context handed to op rules: the run's device, a seeded
    random generator per op, which outputs of the running op some op,
    fetch or the scope reads (`output_read`), and the run's in-graph
    assertions (`add_error`)."""

    is_abstract = False
    # whether the run is one step of Executor.run(steps=K) (_StepCtx)
    in_multi_step = False

    def __init__(self, program, device, run_seed=0, is_startup=False,
                 unread=frozenset()):
        self.program = program
        self.device = device
        self.amp = bool(getattr(program, "_amp", False))
        self.run_seed = int(run_seed)
        self.is_startup = is_startup
        # names of global-block outputs nothing reads (unread_outputs)
        self.unread = unread
        self._op_salt = 0
        self._op_calls = 0
        self._const_calls = 0
        self._op_outputs = None
        # the iteration index of each enclosing loop (rnn_scan pushes its
        # step), folded into every random op's seed
        self._loop_iters = []
        # the While loops enclosing the running op in a step of
        # Executor.run(steps=K) (ops/control_ops._while)
        self.while_depth = 0
        # the forward ops some grad_of of this run differentiates (uid ->
        # that grad_of's no_grad_names), and their kept local graphs: uid ->
        # ({(slot, i): leaf input}, {name: output}), from the forward op's
        # run until its grad_of
        self.grad_stop = {}
        self.saved = {}
        self.op = None
        # message -> 0-d bool tensor on the run's device: the in-graph
        # assertions, raised on the host after the run (raise_op_errors)
        self.op_errors = {}

    def add_error(self, message, flag):
        """Record an in-graph assertion: `flag` (a 0-d bool tensor, never
        read here) is True where the program is at fault. Flags of one
        message combine by sticky OR. Inside a loop body (an enclosing
        rnn_scan's step or while's iteration) it records nothing, as the
        JAX package's rule records nothing inside a lax loop body, whose
        flags cannot leave the trace; a tensor array's overflow flag
        leaves a loop through PROGRAM_ERR instead."""
        if self._loop_iters:
            return
        prev = self.op_errors.get(message)
        self.op_errors[message] = flag if prev is None else prev | flag

    def begin_op(self, salt, outputs=None):
        self._op_salt = salt
        self._op_calls = 0
        self._const_calls = 0
        self._op_outputs = outputs

    def host_constant(self, arr):
        """A tensor on the run's device holding the host array `arr`: an
        op rule's constant (assign_value's values, a shape)."""
        return torch.from_numpy(np.array(arr, order="C")).to(self.device)

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
        return self._generator((int(seed), self._op_salt, self._op_calls,
                                salt, tuple(self._loop_iters)))

    def _generator(self, spec):
        """The generator of one rng call, `spec` its place in the run
        (rng_seed's)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(rng_seed(self.program, spec, self.run_seed))
        return g


def rng_seed(program, spec, run_seed):
    """The seed LowerCtx.rng gives the random op call `spec` = (user seed,
    op uid, call index within the op, salt, enclosing loop iterations) in
    the run drawing `run_seed`. A captured step (MultiStepRunner) reseeds
    its generators with it before each replay."""
    seed, op_salt, op_calls, salt, loop_iters = spec
    if seed:
        base = seed
    else:
        base = int(getattr(program, "random_seed", 0) or 0) * 1000003 \
            + int(run_seed)
    mask = 0x7FFFFFFFFFFFFFFF
    s = (base * 1000003 + op_salt * 97 + op_calls * 7 + salt) & mask
    for it in loop_iters:
        s = (s * 1000003 + it + 1) & mask
    return s


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

    def fork(self):
        """A child Env for a sub-block: the same Scope read-through, a
        copy of the values written so far (its writes stay its own)."""
        child = Env(self._scope, self._persistable, self._device)
        child.values = dict(self.values)
        return child

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


# The reserved Env name of the OR of the overflow flags of tensor arrays
# confined to a loop or conditional sub-block (the JAX package's
# PROGRAM_ERR): the control-flow rules sweep a sub-block's arrays into it
# (ops/control_ops.py), and lower_block turns it into an assertion.
PROGRAM_ERR = "__tensor_array_overflow__"
ARRAY_OVERFLOW = ("tensor array %r overflowed its capacity %d inside traced "
                  "control flow; pass a larger capacity to create_array()")
SUB_BLOCK_OVERFLOW = (
    "a tensor array confined to a loop/conditional sub-block overflowed "
    "its capacity inside traced control flow; pass a larger capacity to "
    "create_array()")


def accumulate_error(env, flag):
    """OR `flag` into the Env's PROGRAM_ERR."""
    cur = env.values.get(PROGRAM_ERR)
    env.write(PROGRAM_ERR, flag if cur is None else cur | flag)


def lower_block(ctx, block, env):
    """Run a program's global block: its `grad_of` ops name the forward
    ops that keep their local graphs in this run. After it, every tensor
    array left in the Env and the sub-blocks' PROGRAM_ERR become in-graph
    assertions with the JAX package's messages (its build_program_fn
    collect_errors); a program with neither adds none."""
    ctx.grad_stop = {op.attrs["fwd_uid"]:
                     frozenset(op.attrs.get("no_grad_names", ()))
                     for op in block.ops if op.type == "grad_of"}
    # the reader ops ran in the executor's host io pre-pass
    # (core/executor.run_host_io_prepass): their outputs are feeds here
    for op in block.ops:
        if op.type not in HOST_IO_OPS:
            lower_op(ctx, op, env)
    from ..ops.control_ops import TensorArray
    for name, v in list(env.values.items()):
        if isinstance(v, TensorArray):
            ctx.add_error(ARRAY_OVERFLOW % (name, v.buffer.shape[0]),
                          v.overflow)
    sub_err = env.values.get(PROGRAM_ERR)
    if sub_err is not None:
        ctx.add_error(SUB_BLOCK_OVERFLOW, sub_err)


def lower_sub_block(ctx, block, env):
    """Run `block`'s ops in order in `env`. A control-flow op runs its body
    through this, not lower_block: the run's grad_of table (ctx.grad_stop)
    belongs to the global block and must outlive the body, or every
    forward op after the control-flow op would keep no graph."""
    for op in block.ops:
        lower_op(ctx, op, env)


def lower_op(ctx, op, env):
    # the innermost op running: after a raise it names the op at fault
    outer, ctx.op = ctx.op, op
    try:
        _lower_op_inner(ctx, op, env)
        ctx.op = outer
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
    stop = ctx.grad_stop.get(op.uid)
    if od.special:
        if stop is not None and op.type not in SPECIAL_GRADS:
            raise NotImplementedError(
                "op %r has a special rule, which keeps no graph: it cannot "
                "be differentiated" % op.type)
        ctx.begin_op(op.uid, op.outputs)
        od.lower(ctx, op, env)
        return
    ins = {slot: [env.read(n) for n in names]
           for slot, names in op.inputs.items()}
    ctx.begin_op(op.uid, op.outputs)
    if stop is None:
        if ctx.amp:
            ins = _apply_amp(op.type, ins)
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
        if ctx.amp:
            ins = _apply_amp(op.type, ins)
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


# Forward op types whose gradient is hand-written rather than autograd's:
# special rules that are differentiable (parity: the JAX package's
# SPECIAL_GRADS; ops/control_ops.py registers its one entry,
# reorder_lod_tensor_by_rank). Each entry: {"fn": fn(ctx, grad_of op,
# env), "diff_slots": the input slots that receive a gradient}.
# backward.py reads the same table.
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


# ---------------------------------------------------------------------------
# Multi-step execution: Executor.run(steps=K)
# ---------------------------------------------------------------------------

# fetch-reduce policies for multi-step execution: how K per-step fetch
# values collapse into the one value the caller sees per K-step call
FETCH_REDUCE_POLICIES = ("last", "mean", "stack")


def _mean_acc_dtype(dtype):
    """Accumulation dtype for fetch_reduce='mean': float fetches accumulate
    in (at least) f32 so K bf16 losses don't round to garbage; f64 stays
    f64; bool/int fetches also go through f32 — their mean is a rate."""
    if dtype.is_floating_point:
        return torch.promote_types(dtype, torch.float32)
    return torch.float32


def _find_var(program, name):
    for blk in program.blocks:
        if name in blk.vars:
            return blk.vars[name]
    return None


def analyze_state(program, feed_names, fetch_names=()):
    """Decide which persistable vars are program state (static analysis).

    Returns (state_rw, state_ro, state_out):
      state_rw — read from the Scope AND overwritten
      state_ro — read from the Scope, never written
      state_out — all persistables written (order of the new state)

    `fetch_names` count as reads: fetching a persistable var no op
    produces (the evaluator.eval pattern — an empty program fetching
    state) reads it straight from the Scope."""
    feed = set(feed_names)
    written = set()
    state_in = []
    state_out = []
    seen_in = set()
    seen_out = set()

    def visit_read(name):
        if name in feed or name in written or name in seen_in:
            return
        v = _find_var(program, name)
        if v is not None and v.persistable:
            seen_in.add(name)
            state_in.append(name)

    for blk in program.blocks:
        for op in blk.ops:
            if op.type in HOST_IO_OPS:
                continue  # reader vars hold host-side state, no tensor
            for name in op.all_input_vars():
                visit_read(name)
            for name in op.all_output_vars():
                if not name:
                    continue
                written.add(name)
                v = _find_var(program, name)
                if v is not None and v.persistable and name not in seen_out:
                    seen_out.add(name)
                    state_out.append(name)
    # fetches of persistable vars NO op writes read straight from the
    # Scope; after the op walk, so fetching a var this program produces
    # stays a plain fetch
    for name in fetch_names:
        visit_read(name)
    state_rw = [n for n in state_in if n in seen_out]
    state_ro = [n for n in state_in if n not in seen_out]
    return state_rw, state_ro, state_out


def build_slot_update_fn():
    """The row writer of decode slot state (serving.DecodeEngine).

    fn(state_vals, slot, row_vals) -> state_vals

    state_vals: [slots, ...] tensors (the carried decode state: hidden
    rows, token cursors, caches); slot: a Python int; row_vals: one row
    per tensor (shape state.shape[1:], numpy or a tensor). Row `slot` of
    each tensor is overwritten IN PLACE on its device (`copy_` into the
    row view): the tensor object and its storage stay, so a later CUDA
    graph that holds its pointer keeps seeing it, and the other rows'
    bits are not touched. The slot is a Python int, so indexing makes no
    host sync; a host row reaches a card through pinned memory as a
    non-blocking copy, ordered before the next step on the same stream.
    Parity: the JAX package's donated dynamic_update_index_in_dim.

    A tensor that cannot take a row write in place (an expanded or
    otherwise non-contiguous step output) is first replaced by a
    contiguous copy; the returned tuple holds what to keep."""
    def update(state_vals, slot, row_vals):
        slot = int(slot)
        out = []
        for s, r in zip(state_vals, row_vals):
            if not s.is_contiguous():
                s = s.contiguous()
            row = r if isinstance(r, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(r))
            if row.device.type == "cpu" and s.device.type == "cuda":
                row = row.pin_memory()
            s[slot].copy_(row.reshape(s.shape[1:]),
                          non_blocking=s.device.type == "cuda")
            out.append(s)
        return tuple(out)
    return update


class GraphCaptureError(RuntimeError):
    """A training step that cannot run inside a CUDA graph (a host sync,
    or a tensor made from host values inside the step): Executor.run(
    steps=K) raises this naming the op; it never runs eager instead."""


class _StepCtx(LowerCtx):
    """The LowerCtx of a captured step. Each random op call records its
    place in the step (`specs`); with `gens` given (the capture, and
    every step of the CPU's plain version) the call gets the next of
    those generators, which the runner reseeds before each step with the
    seed an eager run would draw.

    A While of the step (ops/control_ops._while_captured) keeps its body's
    stream and its iteration counter in `while_state` (op uid -> (stream,
    counter), the runner's, so the warm-up makes them and the capture
    uses them) and records (its iteration counter, the kernel launches of
    one body iteration, its body's memory pool) in `while_loops`. A
    random op inside a While body raises: the graph replays the body's
    captured draw at every iteration."""

    in_multi_step = True

    def __init__(self, program, device, run_seed, unread, gens=None,
                 while_state=None, constants=None):
        super(_StepCtx, self).__init__(program, device, run_seed=run_seed,
                                       unread=unread)
        self.gens = gens
        self.specs = []
        self.while_state = {} if while_state is None else while_state
        self.while_loops = []
        self.constants = {} if constants is None else constants

    def host_constant(self, arr):
        """On a card, the constant the warm-up run made for this call of
        the op (copied once, through pinned memory, without a host sync):
        the capture reads that tensor and copies nothing from the host.
        Op rules never write their inputs in place, so it stays as made."""
        if self.device.type != "cuda":
            return super(_StepCtx, self).host_constant(arr)
        self._const_calls += 1
        key = (self.op.uid if self.op is not None else -1,
               self._const_calls)
        t = self.constants.get(key)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise GraphCaptureError(
                    "the captured step made a constant its warm-up run "
                    "did not make: its constants depend on something other "
                    "than the program")
            t = torch.from_numpy(np.array(arr, order="C")).pin_memory().to(
                self.device, non_blocking=True)
            self.constants[key] = t
        return t

    def _generator(self, spec):
        if self.while_depth:
            op = self.op
            raise GraphCaptureError(
                "op %r (uid %d) draws random numbers inside a While body, "
                "which Executor.run(steps=K) captures once and replays at "
                "every iteration: each iteration would draw the same "
                "numbers. Run the program with steps=1"
                % (op.type if op is not None else "?",
                   op.uid if op is not None else -1))
        self.specs.append(spec)
        if self.gens is None:
            return super(_StepCtx, self)._generator(spec)
        if len(self.specs) > len(self.gens):
            raise GraphCaptureError(
                "the step drew more random streams than its warm-up run "
                "did (%d): its random ops depend on something other than "
                "the program and the feed shapes" % len(self.gens))
        return self.gens[len(self.specs) - 1]


def _storage_ptr(t):
    return t.untyped_storage().data_ptr()


def _release_pools(device_index, pools):
    """Give back the memory pools of a dropped graph's While bodies."""
    for pool in pools:
        try:
            torch._C._cuda_releasePool(device_index, pool)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _copy_into(buf, value):
    """buf <- value without a host sync: a CPU value bound for the card
    goes through pinned memory as a non-blocking copy."""
    if value.device == buf.device:
        buf.copy_(value)
    elif buf.device.type == "cuda":
        buf.copy_(value.pin_memory(), non_blocking=True)
    else:
        buf.copy_(value)


class MultiStepRunner(object):
    """One training step over static buffers, run K times per call.

    Buffers: one per feed, one per persistable the step reads (state_rw
    and state_ro) and one per persistable it writes that it does not read.
    The step reads them and ends by copying its new state into them, so
    step i + 1 starts where step i ended.

    On CUDA the first call warms the step up on a side stream (under
    `torch.cuda.set_sync_debug_mode("error")`: a step that syncs with the
    host cannot be captured, and raises GraphCaptureError naming its op),
    then captures ONE step into a torch.cuda.CUDAGraph whose random ops
    draw from generators made before the capture and registered with the
    graph. Each call then replays it K times with no host sync between
    replays, reseeding the generators before each replay with the seeds K
    sequential runs would draw, and collects each replay's fetches on the
    device. On the CPU (the plain version) each of the K steps runs the
    same step eagerly over the same buffers and generators.

    A call copies into the buffers only the scope values that changed
    since the runner last saw them (any scope.set between calls is
    seen), and hands the scope fresh copies of the new state: nothing a
    caller or the scope holds changes under a later replay.

    In-graph assertions (LowerCtx.add_error): one static 0-d bool buffer
    per message of the step, zeroed at the start of each call and ORed
    with the step's flag inside the step (inside the captured graph), so
    after K replays each holds the sticky OR over the K steps, as the
    JAX package's lax.scan carries its flags (its fold_errors). The
    caller reads them once, after the K steps."""

    def __init__(self, program, device, feed_names, fetch_names, state_rw,
                 state_ro, state_out, steps, fetch_reduce="stack",
                 unread=frozenset(), stacked_names=()):
        self.program = program
        self.device = torch.device(device)
        self.feed_names = list(feed_names)
        # feeds given as a [K, ...] stack (a reader's K-block): step i
        # reads slice i
        self.stacked = frozenset(stacked_names)
        self._stacks = {}      # stacked feed name -> its stack on device
        self.fetch_names = list(fetch_names)
        self.in_names = list(state_rw) + list(state_ro)
        # the state the eager run writes back: global-block outputs
        glob = {n for op in program.global_block().ops
                if op.type not in HOST_IO_OPS
                for n in op.all_output_vars() if n}
        self.out_names = [n for n in state_out if n in glob]
        self.steps = int(steps)
        self.fetch_reduce = fetch_reduce
        self.unread = unread
        self.cuda = self.device.type == "cuda"
        self._built = False    # set once a build has run to its end
        self._feed_bufs = None
        self._bufs = {}        # persistable name -> static buffer
        self._handed = {}      # name -> (weakref, _version) last seen
        self._specs = None     # one spec per random op call of a step
        self._gens = None
        self._graph = None
        self._fetch_out = None
        self._errs = {}        # assertion message -> static flag buffer
        # the step's While loops as conditional nodes (_StepCtx's
        # while_loops), and their bodies' streams and counters
        self._while_loops = []
        self._while_state = {}
        # (op uid, call) -> a constant the warm-up made on the card
        self._constants = {}
        # the port's kernels one step launches outside its While bodies
        # (a body's launches count once an iteration: while_loops)
        self.launches = {}
        self.warmup_s = self.capture_s = None
        self.pool_bytes = None

    # ---------------------------------------------------------- buffers --
    def fits(self, scope):
        """Whether the buffers still fit the scope's state (a state
        re-created at another shape or dtype needs a new runner; the
        feeds' shapes are in the cache key)."""
        if not self._built:
            return True
        for n, buf in self._bufs.items():
            cur = scope.get(n) if n in self.in_names else buf
            if cur is None or cur.shape != buf.shape or \
                    cur.dtype != buf.dtype:
                return False
        return True

    def _read_scope(self, scope):
        vals = {}
        for n in self.in_names:
            v = scope.get(n)
            if v is None:
                raise RuntimeError(
                    "persistable variable %r is not initialized in the "
                    "scope; run the startup program first" % n)
            vals[n] = v
        return vals

    def _sync_in(self, scope, feeds):
        """Copy the feeds, and the scope values changed since the last
        call, into the buffers (no host sync). A stacked feed goes to the
        device whole; _feed_step copies each step's slice."""
        for n in self.feed_names:
            if n in self.stacked:
                v = feeds[n]
                self._stacks[n] = v.pin_memory().to(
                    self.device, non_blocking=True) \
                    if v.device.type == "cpu" and self.cuda \
                    else v.to(self.device)
            else:
                _copy_into(self._feed_bufs[n], feeds[n])
        for n, cur in self._read_scope(scope).items():
            seen = self._handed.get(n)
            if seen is not None and seen[0]() is cur and \
                    seen[1] == cur._version:
                continue
            _copy_into(self._bufs[n], cur)
            self._handed[n] = (weakref.ref(cur), cur._version)

    def _feed_step(self, i):
        """Step i's slice of each stacked feed into its buffer: a copy on
        the device, enqueued before the step (outside the graph)."""
        for n in self.stacked:
            self._feed_bufs[n].copy_(self._stacks[n][i])

    def _alloc(self, scope, feeds):
        self._bufs, self._handed = {}, {}
        self._feed_bufs = {
            n: torch.empty(feeds[n].shape[1:] if n in self.stacked
                           else feeds[n].shape, dtype=feeds[n].dtype,
                           device=self.device)
            for n in self.feed_names}
        for n, cur in self._read_scope(scope).items():
            self._bufs[n] = torch.empty_like(cur, device=self.device)

    # ------------------------------------------------------------- step --
    def _ctx(self, run_seed, gens=None):
        return _StepCtx(self.program, self.device, run_seed, self.unread,
                        gens, while_state=self._while_state,
                        constants=self._constants)

    def _step(self, ctx, copy_back):
        """One step over the buffers under `ctx`: returns (fetches, new
        state)."""
        env = Env(None, (), self.device)
        env.values.update(self._feed_bufs)
        env.values.update((n, self._bufs[n]) for n in self.in_names)
        with torch.no_grad():
            lower_block(ctx, self.program.global_block(), env)
        fetches = [env.read(n) for n in self.fetch_names]
        new = {n: env.values[n] for n in self.out_names if n in env.values}
        if copy_back:
            self._copy_back(new)
            self._fold_errors(ctx.op_errors)
        return fetches, new

    def _fold_errors(self, errors):
        """The step's assertion flags ORed into their buffers (sticky
        across the call's steps)."""
        if set(errors) != set(self._errs):
            raise RuntimeError(
                "the step raised assertions %s, its warm-up run %s: its "
                "assertions depend on something other than the program"
                % (sorted(errors), sorted(self._errs)))
        for m, f in errors.items():
            buf = self._errs[m]
            torch.logical_or(buf, f.reshape(()), out=buf)

    def _copy_back(self, new):
        """New state -> its buffers. A new value that shares storage with
        another buffer (an assign between two persistables) is cloned
        first, so no copy reads a buffer an earlier copy overwrote."""
        ptrs = {_storage_ptr(b) for b in self._bufs.values()}
        ptrs.update(_storage_ptr(b) for b in self._feed_bufs.values())
        vals = []
        for n, v in new.items():
            buf = self._bufs[n]
            if v is buf:
                continue
            if _storage_ptr(v) in ptrs:
                v = v.clone()
            vals.append((buf, v))
        for buf, v in vals:
            buf.copy_(v)

    def _reseed(self, run_seed):
        for spec, g in zip(self._specs, self._gens):
            g.manual_seed(rng_seed(self.program, spec, run_seed))

    def _build(self, scope, feeds, run_seed):
        """Allocate the buffers and warm the step up (on CUDA: capture
        it). Runs no step that the caller sees."""
        self._alloc(scope, feeds)
        self._sync_in(scope, feeds)
        self._feed_step(0)
        if not self.cuda:
            ctx = self._ctx(run_seed)
            self._write_only_bufs(self._step(ctx, copy_back=False)[1])
            self._alloc_errors(ctx)
            self._specs = ctx.specs
            self._gens = [torch.Generator(device=self.device)
                          for _ in self._specs]
            self._built = True
            return
        from ..ops import cuda_kernels as ck
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        mode = torch.cuda.get_sync_debug_mode()
        ctx = None
        try:
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                ctx = self._ctx(run_seed)
                self._write_only_bufs(self._step(ctx, copy_back=False)[1])
        except Exception as e:
            raise self._capture_error(ctx, e, "its warm-up run") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._alloc_errors(ctx)
        self._specs = ctx.specs
        self._gens = [torch.Generator(device=self.device)
                      for _ in self._specs]
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self._gens and not hasattr(graph, "register_generator_state"):
            raise GraphCaptureError(
                "this PyTorch (%s) has no CUDAGraph.register_generator_state"
                ": a step with random ops cannot be captured"
                % torch.__version__)
        for g in self._gens:
            graph.register_generator_state(g)
        self._reseed(run_seed)
        before = ck.launch_counts()
        # the capture empties the cache first (torch.cuda.graph): do it
        # here, so the reserved bytes' rise is the graph's pool
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        ctx, failure = None, []
        try:
            with torch.cuda.graph(graph, stream=side):
                try:
                    ctx = self._ctx(run_seed, self._gens)
                    fetches = self._step(ctx, copy_back=True)[0]
                except Exception as e:
                    failure.append(e)
                    raise
        except Exception as e:
            cause = failure[0] if failure else e
            raise self._capture_error(ctx, cause, "its capture") from cause
        finally:
            self.launches = ck.take_launches(before)
        if len(ctx.specs) != len(self._gens):
            raise GraphCaptureError(
                "the captured step drew %d random streams, its warm-up run "
                "%d" % (len(ctx.specs), len(self._gens)))
        self._graph = graph
        self._while_loops = ctx.while_loops
        if ctx.while_loops:
            # a body's memory pool lives as long as the graph replaying it
            weakref.finalize(graph, _release_pools, self.device.index,
                             [pool for _, _, pool in ctx.while_loops])
        self._fetch_out = fetches
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._built = True

    def _capture_error(self, ctx, cause, phase):
        op = getattr(ctx, "op", None)
        where = ("op %r (uid %d)" % (op.type, op.uid) if op is not None
                 else "the step")
        return GraphCaptureError(
            "Executor.run(steps=%d) captures one step of the program into "
            "a CUDA graph, and %s failed in %s: %s. A step that syncs with "
            "the host or builds tensors from host values cannot be "
            "captured; run it with steps=1"
            % (self.steps, where, phase, cause))

    def _alloc_errors(self, ctx):
        """One flag buffer per assertion message of the warm-up step."""
        self._errs = {m: torch.zeros((), dtype=torch.bool, device=self.device)
                      for m in ctx.op_errors}

    def _write_only_bufs(self, new):
        for n in self.out_names:
            if n not in self._bufs:
                if n not in new:
                    raise RuntimeError(
                        "persistable %r is written by the program but "
                        "its step left no value" % n)
                self._bufs[n] = torch.empty_like(new[n])

    # ------------------------------------------------------------- call --
    def __call__(self, scope, feeds, seed):
        """Run K steps from the scope's state, step i drawing seed
        `seed + i`. Returns (fetches reduced per fetch_reduce, {name: new
        state tensor}, {assertion message: its flag's sticky OR over the
        K steps}); writes nothing into the scope."""
        if not self._built:
            self._build(scope, feeds, seed)
        else:
            self._sync_in(scope, feeds)
        for buf in self._errs.values():
            buf.zero_()
        for iters, _, _ in self._while_loops:
            iters.zero_()
        out = None
        for i in range(self.steps):
            self._reseed(seed + i)
            self._feed_step(i)
            if self.cuda:
                self._graph.replay()
                fetches = self._fetch_out
            else:
                fetches = self._step(self._ctx(seed + i, self._gens),
                                     copy_back=True)[0]
            out = self._collect(i, fetches, out)
        if self.launches or self._while_loops:
            from ..ops import cuda_kernels as ck
            ck.add_launches(self.launches, self.steps)
            for iters, body, _ in self._while_loops:
                # counted by the iterations the card ran, read when the
                # counts are next read (never here)
                ck.add_device_launches(body, iters)
        if self.fetch_reduce == "mean":
            out = [a / self.steps for a in out]
        new_state = {}
        for n in self.out_names:
            t = self._bufs[n].clone()
            new_state[n] = t
            self._handed[n] = (weakref.ref(t), t._version)
        return out, new_state, dict(self._errs)

    def _collect(self, i, fetches, out):
        if self.fetch_reduce == "stack":
            if out is None:
                out = [torch.empty((self.steps,) + tuple(f.shape),
                                   dtype=f.dtype, device=f.device)
                       for f in fetches]
            for acc, f in zip(out, fetches):
                acc[i].copy_(f)
        elif self.fetch_reduce == "mean":
            if out is None:
                out = [torch.zeros(f.shape, dtype=_mean_acc_dtype(f.dtype),
                                   device=f.device) for f in fetches]
            for acc, f in zip(out, fetches):
                acc.add_(f.to(acc.dtype))
        elif i == self.steps - 1:
            out = [f.clone() for f in fetches]
        return out


def lower_multi_step(program, device, feed_names, fetch_names, state_rw,
                     state_ro, state_out, steps, fetch_reduce="stack",
                     unread=frozenset(), stacked_names=()):
    """The K-step runner of `program` (the JAX package's lower_multi_step,
    whose lax.scan runs the step K times in one dispatch).

    Contract (tests/test_torch_multi_step.py):
      * a K-step call gives the same bits as K sequential Executor.run
        calls — step i runs with seed + i, the seeds Scope.next_seed would
        have issued, so dropout masks line up;
      * feeds replay identically every step, except the stacked ones
        (`stacked_names`, a reader's [K, ...] block): step i reads slice i;
      * fetches collapse per `fetch_reduce`: 'last' (step K-1's value),
        'mean' (accumulated in f32, then divided by K), 'stack' (a
        leading-K stack).
    See MultiStepRunner for how the step runs on CUDA and on the CPU."""
    if steps < 1:
        raise ValueError("steps must be >= 1, got %r" % (steps,))
    if fetch_reduce not in FETCH_REDUCE_POLICIES:
        raise ValueError("fetch_reduce must be one of %r, got %r"
                         % (FETCH_REDUCE_POLICIES, fetch_reduce))
    return MultiStepRunner(program, device, feed_names, fetch_names,
                           state_rw, state_ro, state_out, steps,
                           fetch_reduce=fetch_reduce, unread=unread,
                           stacked_names=stacked_names)
