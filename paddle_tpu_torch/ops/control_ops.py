"""Control-flow op rules: rnn_scan (the lowering target of StaticRNN and
DynamicRNN), while, conditional_block (Switch's scalar form and IfElse's
row form), split_lod_tensor / merge_lod_tensor, the tensor arrays, the
rank tables, and beam_search / beam_search_decode.

Parity: paddle/fluid/operators/{while_op,conditional_block_op,
tensor_array_read_write_op,lod_rank_table_op,max_sequence_len_op,
shrink_rnn_memory_op,lod_tensor_to_array_op,array_to_lod_tensor_op,
reorder_lod_tensor_by_rank_op,beam_search_op,beam_search_decode_op}.cc,
the reference's recurrent_op.cc, and the JAX package's
ops/control_ops.py. Torch runs eagerly and has no lax.while_loop,
lax.scan or lax.cond, so each loop is a Python loop over its sub-block
(core/lowering.lower_sub_block) in a fork of the Env:
- rnn_scan runs its step block once per time step in a fresh Env holding
  the statics, the memories and the step's slices of the inputs; rows
  past their length keep their memories and give 0;
- while runs its block while its condition holds: ONE host read of the
  condition per iteration, nothing else leaves the card. The loop
  carries (carry_names) are the vars the block writes that live outside
  it. Under Executor.run(steps=K) on a card the loop is a conditional
  while node of the captured graph, its condition set on the device
  (_while_captured, csrc/graph_while.cu);
- conditional_block runs its block on every run. Its scalar form selects
  each output against its previous value with torch.where on the
  condition (no host sync, so a Switch stays capturable); its row form
  (IfElse) writes the block's outputs, and merge_lod_tensor's row mask
  selects: both branches compute on the full batch.

A tensor array is a buffer [capacity, ...], a 0-d int32 length and a
sticky 0-d bool overflow flag, all on the device. An index is clamped on
the device as XLA clamps it (a negative one wraps first), and one outside
[0, capacity) sets the flag: indexing a CUDA tensor out of range would
fire a device-side assert, which poisons the context. The flags of the
arrays a sub-block can see are swept into the reserved PROGRAM_ERR value
after each iteration or block (_sweep_overflow), as the JAX package
threads them through its loop carries; core/lowering.lower_block turns
the arrays left at the end and PROGRAM_ERR into the run's assertions.

Gradients: rnn_scan is ONE op. When some grad_of differentiates it, its
rule runs under autograd (core/lowering.py), so the kept graph spans all
T steps and reaches every Static input. The other rules here are special
(they read and write the Env themselves) and keep no graph; of them only
reorder_lod_tensor_by_rank has a gradient, the inverse permutation
(lowering.SPECIAL_GRADS).
"""
import numpy as np
import torch

from ..core import lowering, registry
from ..core.framework import GRAD_SUFFIX
from ..core.lowering import (PROGRAM_ERR, Env, EnvReadError,
                             GraphCaptureError, accumulate_error,
                             lower_sub_block)
from ..core.registry import register, single
from .basic import stable_topk

DEFAULT_ARRAY_CAPACITY = 256


# ------------------------------------------------------ the Env values --

def _array_index(i, cap):
    """(i wrapped if negative and clamped into [0, cap) as a [1] int64
    tensor, whether i lay outside [0, cap)): XLA's dynamic index rule, on
    the device."""
    i = i.reshape(()).to(torch.int64)
    bad = (i >= cap) | (i < 0)
    i = torch.where(i < 0, i + cap, i).clamp(0, cap - 1)
    return i.reshape(1), bad


class TensorArray(object):
    """A LoDTensorArray value: buffer [capacity, ...], length (0-d int32)
    and overflow (0-d bool), all on the device.

    Parity: paddle/fluid/framework/lod_tensor_array.h (a std::vector of
    LoDTensors on the host) and the JAX package's TensorArray. The
    capacity is fixed (create_array's `capacity`, default
    DEFAULT_ARRAY_CAPACITY) and a write makes a new value: an Env that
    forked before it still holds the old one."""

    __slots__ = ("buffer", "length", "overflow")

    def __init__(self, buffer, length, overflow=None):
        self.buffer = buffer
        self.length = length
        self.overflow = overflow if overflow is not None else torch.zeros(
            (), dtype=torch.bool, device=buffer.device)

    def write(self, i, x):
        cap = self.buffer.shape[0]
        if isinstance(i, (int, np.integer)):
            # a concrete index is checked here, as the JAX package checks
            # one at trace time
            if int(i) >= cap:
                raise IndexError(
                    "tensor array write at index %d exceeds capacity %d; "
                    "pass a larger capacity to create_array()"
                    % (int(i), cap))
            i = torch.tensor(int(i), device=self.buffer.device)
        pos, bad = _array_index(i, cap)
        buf = self.buffer.index_copy(
            0, pos, x.to(self.buffer.dtype).reshape((1,) +
                                                   self.buffer.shape[1:]))
        length = torch.maximum(self.length,
                               (i.reshape(()) + 1).to(torch.int32))
        return TensorArray(buf, length, self.overflow | bad)

    def read(self, i):
        pos, _ = _array_index(i, self.buffer.shape[0])
        return self.buffer.index_select(0, pos)[0]

    @staticmethod
    def empty(shape, dtype, capacity, device):
        return TensorArray(
            torch.zeros((capacity,) + tuple(shape), dtype=dtype,
                        device=device),
            torch.zeros((), dtype=torch.int32, device=device))


class RankTable(object):
    """A lod_rank_table value: the sequence lengths sorted descending
    (int32) and the permutation that sorts them (int64), on the device
    (reference: framework/lod_rank_table.h)."""

    __slots__ = ("lengths", "index")

    def __init__(self, lengths, index):
        self.lengths = lengths
        self.index = index


def _sweep_overflow(benv, incoming):
    """The OR of `incoming`, the sub-Env's PROGRAM_ERR and the overflow
    flag of every tensor array the sub-Env can see (the JAX package's
    _sweep_overflow): how a flag raised on an array that never leaves its
    sub-block still reaches the run's assertions. None when there is
    nothing to OR (a sub-block that sees no array adds no assertion)."""
    flags = [] if incoming is None else [incoming]
    sub = benv.values.get(PROGRAM_ERR)
    if sub is not None:
        flags.append(sub)
    flags.extend(v.overflow for v in benv.values.values()
                 if isinstance(v, TensorArray))
    if not flags:
        return None
    err = flags[0]
    for f in flags[1:]:
        err = err | f
    return err


def _rnn_scan(ctx, ins, attrs):
    sub = ctx.program.blocks[attrs["sub_block"]]
    xs = ins.get("X", [])                 # step inputs [B, T, feat...]
    mems = list(ins.get("Boot", []))      # memory boot values [B, ...]
    statics = ins.get("Static", [])       # closed-over reads
    seqlen = single(ins, "SeqLen")        # [B] int32, or None (StaticRNN)
    in_names = attrs["in_names"]          # placeholders inside the block
    static_names = attrs["static_names"]
    pre_names = attrs["pre_names"]        # memory placeholders
    update_names = attrs["update_names"]  # vars holding the new memories
    out_names = attrs["out_names"]        # per-step outputs to stack

    t_len = int(attrs["max_len"]) if attrs.get("max_len") else xs[0].shape[1]
    if seqlen is not None:
        seqlen = seqlen.reshape(-1).to(torch.int64)
    # unbind once: its backward is one stack, where T slices would each
    # scatter into a zero tensor of x's full size
    xs_t = [x.unbind(1) for x in xs]
    steps = [[] for _ in out_names]
    for t in range(t_len):
        env = Env()
        for n, v in zip(static_names, statics):
            env.write(n, v)
        for n, v in zip(pre_names, mems):
            env.write(n, v)
        for n, x_t in zip(in_names, xs_t):
            env.write(n, x_t[t])
        # the step index salts the seeds of the body's random ops
        ctx._loop_iters.append(t)
        try:
            lower_sub_block(ctx, sub, env)
        finally:
            ctx._loop_iters.pop()
        new_mems = [env.read(n).to(m.dtype)
                    for n, m in zip(update_names, mems)]
        outs = [env.read(n) for n in out_names]
        if seqlen is not None:
            # past a row's length its memories keep their value and its
            # outputs are 0
            alive = t < seqlen

            def sel(new, old):
                m = alive.reshape((-1,) + (1,) * (new.dim() - 1))
                return torch.where(m, new, old.to(new.dtype))

            new_mems = [sel(nm, pm) for nm, pm in zip(new_mems, mems)]
            outs = [sel(o, torch.zeros((), dtype=o.dtype, device=o.device))
                    for o in outs]
        mems = new_mems
        for acc, o in zip(steps, outs):
            acc.append(o)
    return {"Out": [torch.stack(acc, dim=1) for acc in steps],
            "LastMem": mems}


def _rnn_scan_infer(block, op, out_vars):
    """Output shapes from the step block's vars: the rule itself cannot run
    on meta tensors at build time (B and T share the sentinel there)."""
    sub = block.program.blocks[op.attrs["sub_block"]]
    t_len = op.attrs.get("max_len")
    if not t_len and op.inputs.get("X"):
        x0 = block.var_recursive(op.inputs["X"][0])
        t_len = x0.shape[1] if x0.shape is not None else None
    for name, inner in zip(op.outputs.get("Out", ()),
                           op.attrs["out_names"]):
        iv = sub.var_recursive(inner)
        ov = block.var_recursive(name)
        if iv.shape is not None:
            ov.shape = (iv.shape[0], t_len if t_len else -1) \
                + tuple(iv.shape[1:])
        ov.dtype = iv.dtype
    for name, inner in zip(op.outputs.get("LastMem", ()),
                           op.attrs["update_names"]):
        iv = sub.var_recursive(inner)
        ov = block.var_recursive(name)
        ov.shape, ov.dtype = iv.shape, iv.dtype


registry.register("rnn_scan", _rnn_scan, infer=_rnn_scan_infer)


def _conditional_block(ctx, op, env):
    """The block runs unconditionally in a fork of the enclosing Env (a
    special rule: the block closes over the enclosing block's vars by
    name, and an out var may have no previous value).

    Scalar form (is_scalar_condition=True, Switch): each out var becomes
    where(cond, block's value, previous value), the previous value zeros
    when nothing wrote it before. A Switch's cases carry exclusive
    conditions (case i: cond_i and no earlier cond), so the last where
    reproduces first-match-wins; an untaken case's arrays cannot
    overflow. Row form (IfElse): the block's values are written as they
    are, and merge_lod_tensor's row mask selects."""
    attrs = op.attrs
    sub = ctx.program.blocks[attrs["sub_block"]]
    benv = env.fork()
    benv.values.pop(PROGRAM_ERR, None)   # the block's own contribution
    lower_sub_block(ctx, sub, benv)
    berr = _sweep_overflow(benv, None)
    if not attrs.get("is_scalar_condition", True):
        for name in attrs["out_names"]:
            env.write(name, benv.read(name))
        if berr is not None:
            accumulate_error(env, berr)
        return
    cond = env.read(op.inputs["Cond"][0]).reshape(()).to(torch.bool)
    if berr is not None:
        accumulate_error(env, berr & cond)
    for name in attrs["out_names"]:
        new = benv.read(name)
        try:
            prev = env.read(name).to(new.dtype).broadcast_to(new.shape)
        except EnvReadError:
            prev = torch.zeros_like(new)
        env.write(name, torch.where(cond, new, prev))


def _conditional_block_infer(block, op, out_vars):
    """Build-time shapes: each out var is a var of the enclosing block
    that the sub-block's ops assign; it keeps the shape and dtype its
    producer gave it, or else takes those of the sub-block's writer's
    first input (an assign copies its X)."""
    sub = block.program.blocks[op.attrs["sub_block"]]
    for var in out_vars.get("Out", ()):
        if var.shape is not None:
            continue
        for sop in sub.ops:
            if var.name in sop.all_output_vars():
                src = sub.var_recursive(sop.all_input_vars()[0]) \
                    if sop.all_input_vars() else None
                if src is not None and src.shape is not None:
                    var.shape, var.dtype = src.shape, src.dtype


registry.register("conditional_block", _conditional_block,
                  infer=_conditional_block_infer, special=True)


@register("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs):
    """Both branches of an IfElse see the full batch (the row mask
    selects at merge_lod_tensor)."""
    x = single(ins, "X")
    return {"OutTrue": [x], "OutFalse": [x]}


@register("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs):
    """Rows where Mask holds from InTrue, the rest from InFalse."""
    x_true = single(ins, "InTrue")
    x_false = single(ins, "InFalse")
    mask = single(ins, "Mask")                      # [B, 1] bool or float
    m = mask.reshape((-1,) + (1,) * (x_true.dim() - 1)).to(torch.bool)
    return {"Out": [torch.where(m, x_true, x_false.to(x_true.dtype))]}


# -------------------------------------------------------- tensor arrays --

def _env_array(ctx, env, name, like=None):
    """The tensor array `name` holds, or (at its first write) an empty one
    of the array var's capacity and `like`'s element shape and dtype."""
    arr = env.values.get(name)
    if arr is not None:
        return arr
    if like is None:
        raise ValueError("tensor array %r read before any write" % name)
    var = lowering._find_var(ctx.program, name)
    cap = getattr(var, "capacity", None) or DEFAULT_ARRAY_CAPACITY
    return TensorArray.empty(like.shape, like.dtype, cap, like.device)


def _write_to_array(ctx, op, env):
    x = env.read(op.inputs["X"][0])
    i = env.read(op.inputs["I"][0])
    out = op.outputs["Out"][0]
    env.write(out, _env_array(ctx, env, out, like=x).write(i, x))


def _read_from_array(ctx, op, env):
    arr = env.read(op.inputs["X"][0])
    i = env.read(op.inputs["I"][0])
    env.write(op.outputs["Out"][0], arr.read(i))


def _lod_array_length(ctx, op, env):
    arr = env.read(op.inputs["X"][0])
    env.write(op.outputs["Out"][0], arr.length.reshape(1))


# ---------------------------------------------------------- rank tables --

def _lod_rank_table(ctx, op, env):
    xlen = env.read(op.inputs["XLen"][0]).reshape(-1).to(torch.int32)
    # a stable descending sort: equal lengths keep their order, as the
    # reference's LoDRankTable does
    order = torch.argsort(-xlen, stable=True)
    env.write(op.outputs["Out"][0], RankTable(xlen[order], order))


def _max_sequence_len(ctx, op, env):
    rt = env.read(op.inputs["RankTable"][0])
    env.write(op.outputs["Out"][0], rt.lengths[:1])


def _reorder_by_rank(ctx, op, env):
    x = env.read(op.inputs["X"][0])
    rt = env.read(op.inputs["RankTable"][0])
    env.write(op.outputs["Out"][0], x.index_select(0, rt.index))
    if op.inputs.get("XLen") and op.outputs.get("OutLen"):
        xl = env.read(op.inputs["XLen"][0])
        env.write(op.outputs["OutLen"][0], xl.index_select(0, rt.index))


def _grad_reorder_by_rank(ctx, op, env):
    """The gradient of a row permutation is the inverse permutation
    (reference: reorder_lod_tensor_op.cc's grad kernel reorders with the
    inverted rank table); XLen carries none."""
    fwd_inputs = op.attrs["fwd_inputs"]
    rt = env.read(fwd_inputs["RankTable"][0])
    og = env.values.get(op.attrs["fwd_outputs"]["Out"][0] + GRAD_SUFFIX)
    xname = fwd_inputs["X"][0]
    if og is None or xname in op.attrs.get("no_grad_names", ()):
        return
    env.accumulate(xname + GRAD_SUFFIX,
                   og.index_select(0, torch.argsort(rt.index)))


lowering.SPECIAL_GRADS["reorder_lod_tensor_by_rank"] = {
    "fn": _grad_reorder_by_rank, "diff_slots": ("X",)}


def _shrink_rnn_memory(ctx, op, env):
    # the reference shrinks the batch to the sequences still alive at step
    # I (the sorted layout); the padded-dense layout keeps its shape and
    # rnn_scan masks instead, so this is the identity
    env.write(op.outputs["Out"][0], env.read(op.inputs["X"][0]))


def _lod_tensor_to_array(ctx, op, env):
    """A padded sequence [B, T, ...] -> a time-major array of its T steps
    [B, ...], rows in rank order first when a RankTable is given (as
    reorder_lod_tensor_by_rank moves their companions;
    array_to_lod_tensor undoes it)."""
    x = env.read(op.inputs["X"][0])
    if op.inputs.get("RankTable"):
        x = x.index_select(0, env.read(op.inputs["RankTable"][0]).index)
    env.write(op.outputs["Out"][0], TensorArray(
        x.movedim(1, 0),
        torch.full((), x.shape[1], dtype=torch.int32, device=x.device)))


def _array_to_lod_tensor(ctx, op, env):
    """[B, capacity, ...]: the time dim is the capacity (a data-dependent
    one would need a host read), and OutLen gives every row the written
    length, so sequence ops mask the zero tail."""
    arr = env.read(op.inputs["X"][0])
    out = arr.buffer.movedim(0, 1)
    if op.inputs.get("RankTable"):
        rt = env.read(op.inputs["RankTable"][0])
        out = out.index_select(0, torch.argsort(rt.index))
    env.write(op.outputs["Out"][0], out)
    if op.outputs.get("OutLen"):
        env.write(op.outputs["OutLen"][0],
                  arr.length.to(torch.int32).expand(out.shape[0]))


# ---------------------------------------------------------------- while --

def _run_body(ctx, sub, env, carry_names, vals, err, it):
    """One iteration of a While body in a fork of `env` holding the
    carries `vals` and PROGRAM_ERR `err`; iteration `it` salts the body's
    random ops. Returns (benv, new carries, the swept overflow flag)."""
    benv = env.fork()
    if err is not None:
        benv.write(PROGRAM_ERR, err)
    for n, v in zip(carry_names, vals):
        benv.write(n, v)
    ctx._loop_iters.append(it)
    try:
        lower_sub_block(ctx, sub, benv)
    finally:
        ctx._loop_iters.pop()
    vals = [benv.read(n) if isinstance(v, (TensorArray, RankTable))
            else benv.read(n).to(v.dtype)
            for n, v in zip(carry_names, vals)]
    return benv, vals, _sweep_overflow(benv, err)


def _carry_tensors(v):
    """The tensors of a carry value, in a fixed order."""
    if isinstance(v, TensorArray):
        return [v.buffer, v.length, v.overflow]
    if isinstance(v, RankTable):
        return [v.lengths, v.index]
    return [v]


def _carry_like(v, tensors):
    """A carry value of v's kind over `tensors` (_carry_tensors' order)."""
    if isinstance(v, TensorArray):
        return TensorArray(*tensors)
    if isinstance(v, RankTable):
        return RankTable(*tensors)
    return tensors[0]


def _while_captured(ctx, op, env, sub, cond_name, carry_names, vals, err,
                    cond):
    """A While inside a step that Executor.run(steps=K) captures on a
    card: a conditional WHILE node of the graph (csrc/graph_while.cu).

    Before the node: one fixed buffer for every carry tensor (a tensor
    array's buffer, length and flag, a rank table's two tensors) holding
    the carry's value on entry, and the overflow flag. The loop's
    iteration counter is made in the warm-up, outside the graph: the
    runner zeroes it before a call's replays and counts the body's kernel
    launches by it after them, and a tensor the capture allocated could
    share its memory with a temporary the graph writes earlier in each
    replay. The entry condition is set on the device; the body is
    captured ONCE into the node's body graph on a stream of its own,
    allocating from a memory pool of its own, and ends by writing the new
    carries into their buffers in place, ORing its overflow flags into
    the flag buffer, counting the iteration and setting the condition.
    The graph replays the body while the condition holds; the host reads
    nothing.

    During the runner's warm-up (on the card, not capturing, host reads
    an error) the body runs ONCE on its stream with the condition unread:
    enough to warm its kernels and the stream's state; that run's values
    are never seen."""
    from . import cuda_kernels as ck
    capturing = torch.cuda.is_current_stream_capturing()
    if op.uid not in ctx.while_state:
        if capturing:
            raise GraphCaptureError(
                "op 'while' (uid %d) was captured without its warm-up run"
                % op.uid)
        ctx.while_state[op.uid] = (
            torch.cuda.Stream(cond.device),
            torch.zeros((), dtype=torch.int64, device=cond.device))
    body_stream, iters = ctx.while_state[op.uid]
    cur = torch.cuda.current_stream(cond.device)
    if not capturing:
        body_stream.wait_stream(cur)
        with torch.cuda.stream(body_stream):
            _, vals, err = _run_body(ctx, sub, env, carry_names, vals, err,
                                     0)
        cur.wait_stream(body_stream)
        for v in vals:
            for t in _carry_tensors(v):
                t.record_stream(cur)
        if err is not None:
            err.record_stream(cur)
        return vals, err
    bufs = [_carry_like(v, [t.clone() for t in _carry_tensors(v)])
            for v in vals]
    err_buf = (err.reshape(()).clone() if err is not None else
               torch.zeros((), dtype=torch.bool, device=cond.device))
    entry = cond.reshape(-1)[:1].to(torch.bool).contiguous()
    dev = cond.device.index
    handle = ck.graph_while_begin(entry, body_stream)
    before = ck.launch_snapshot()
    pool = torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
            try:
                benv, new, new_err = _run_body(
                    ctx, sub, env, carry_names, bufs, err_buf, 0)
                new_cond = benv.read(cond_name).reshape(-1)[:1].to(
                    torch.bool).clone()
                _write_carries(op, carry_names, bufs, new)
                torch.logical_or(err_buf, new_err.reshape(()), out=err_buf)
                iters.add_(1)
                ck.set_while_condition(handle, new_cond)
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
    finally:
        ck.graph_while_end(body_stream)
    ctx.while_loops.append((iters, ck.take_launches(before), pool))
    return bufs, err_buf


def _write_carries(op, carry_names, bufs, new):
    """The body's new carries into their buffers, in place. A new value
    that shares storage with a buffer (a carry assigned from another) is
    cloned first, so no copy reads a buffer an earlier copy wrote."""
    ptrs = {lowering._storage_ptr(t) for b in bufs
            for t in _carry_tensors(b)}
    pairs = []
    for name, b, v in zip(carry_names, bufs, new):
        for bt, vt in zip(_carry_tensors(b), _carry_tensors(v)):
            if vt is bt:
                continue
            if tuple(vt.shape) != tuple(bt.shape):
                raise GraphCaptureError(
                    "op 'while' (uid %d): loop carry %r changes shape from "
                    "%s to %s inside the loop; a captured loop needs fixed "
                    "carry shapes (as lax.while_loop does)"
                    % (op.uid, name, tuple(bt.shape), tuple(vt.shape)))
            if lowering._storage_ptr(vt) in ptrs:
                vt = vt.clone()
            pairs.append((bt, vt))
    for bt, vt in pairs:
        bt.copy_(vt)


def _while(ctx, op, env):
    """The sub-block runs while the condition holds, in a fork of the Env
    per iteration holding the carries' current values; the iteration
    index salts the body's random ops. Eagerly the condition is read on
    the host once before each iteration, and nothing else is. After the
    loop the carries are written back, the condition set False, and the
    swept overflow flags ORed into PROGRAM_ERR.

    Under Executor.run(steps=K) (ctx.in_multi_step) a While on the card
    becomes a conditional while node of the captured step
    (_while_captured); on the CPU it is the same host loop. A random op in
    its body raises GraphCaptureError there (_StepCtx): a body the graph
    replays would draw the same numbers every iteration. Its overflow
    flag always reaches PROGRAM_ERR, so every step raises the same set of
    assertion messages."""
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    cond_name = op.inputs["Condition"][0]
    carry_names = list(op.attrs["carry_names"])
    vals, missing = [], []
    for n in carry_names:
        try:
            vals.append(env.read(n))
        except EnvReadError:
            missing.append(n)
    if missing:
        raise ValueError(
            "While loop carries %r, but they have no value before the loop. "
            "XLA loop carries need an initial value: assign / array_write / "
            "fill_constant each of them before `with while_op.block():`."
            % missing)
    err = env.values.get(PROGRAM_ERR)
    cond = env.read(cond_name)
    if ctx.in_multi_step:
        ctx.while_depth += 1
    try:
        if ctx.in_multi_step and cond.device.type == "cuda":
            vals, err = _while_captured(ctx, op, env, sub, cond_name,
                                        carry_names, vals, err, cond)
        else:
            it = 0
            while bool(cond.reshape(())):       # the loop's one host read
                benv, vals, err = _run_body(ctx, sub, env, carry_names,
                                            vals, err, it)
                cond = benv.read(cond_name)
                it += 1
    finally:
        if ctx.in_multi_step:
            ctx.while_depth -= 1
    if ctx.in_multi_step and err is None:
        err = torch.zeros((), dtype=torch.bool, device=cond.device)
    for n, v in zip(carry_names, vals):
        env.write(n, v)
    env.write(cond_name, torch.zeros((1,), dtype=torch.bool,
                                     device=cond.device))
    if err is not None:
        accumulate_error(env, err)


# ---------------------------------------------------------- beam search --

def _beam_search(ctx, op, env):
    """One step of beam search on the dense [batch, beam] layout.

    Parity: paddle/fluid/operators/beam_search_op.cc (LoD candidate lists
    grown and pruned on the host) and the JAX package's rule: each batch
    row keeps exactly beam_size beams; a finished beam (its last id is
    end_id) can only extend with end_id at no cost, so its total stays.

    inputs: pre_ids [B, K] int, pre_scores [B, K] (cumulative log-probs),
    scores [B, K, V] (the next token's log-probs per beam); outputs:
    selected_ids, selected_scores, parent_idx [B, K] (int32, the source
    beam of each). The top-k over the K*V candidates is the stable
    total-order topk of ops/basic.py, so ties come out in lax.top_k's
    order."""
    pre_ids = env.read(op.inputs["pre_ids"][0])
    pre_scores = env.read(op.inputs["pre_scores"][0])
    scores = env.read(op.inputs["scores"][0])
    beam_size = int(op.attrs["beam_size"])
    end_id = int(op.attrs["end_id"])
    b, k, v = scores.shape
    finished = (pre_ids == end_id)[:, :, None]
    total = pre_scores[:, :, None] + scores                     # [B, K, V]
    # 0 at end_id, -1e9 elsewhere (built on the device: an index store of
    # a Python scalar would copy it from the host, a synchronizing call)
    only_end = torch.where(
        torch.arange(v, device=scores.device) == end_id,
        torch.zeros((), dtype=scores.dtype, device=scores.device),
        torch.full((), -1e9, dtype=scores.dtype, device=scores.device))
    total = torch.where(finished, pre_scores[:, :, None] + only_end, total)
    top_scores, top_idx = stable_topk(total.reshape(b, k * v), beam_size)
    env.write(op.outputs["selected_ids"][0],
              (top_idx % v).to(pre_ids.dtype))
    env.write(op.outputs["selected_scores"][0], top_scores)
    if op.outputs.get("parent_idx"):
        env.write(op.outputs["parent_idx"][0],
                  (top_idx // v).to(torch.int32))


def _beam_search_decode(ctx, op, env):
    """Backtrack the per-step arrays into sentences: a reverse loop over
    the capacity, the steps at or past the written length held by
    where(t < n) on the device (no host read).

    Parity: paddle/fluid/operators/beam_search_decode_op.cc (a host-side
    LoD backtrace) and the JAX package's reverse lax.scan. inputs: Ids
    and ParentIdx (arrays of [B, K] tokens and parent beams), Scores (an
    array of [B, K] cumulative scores: its last written entry is the
    total); outputs: SentenceIds [B, K, C] (end_id past the end),
    SentenceScores [B, K]."""
    ids_arr = env.read(op.inputs["Ids"][0])
    par_arr = env.read(op.inputs["ParentIdx"][0])
    scores_arr = env.read(op.inputs["Scores"][0])
    end_id = int(op.attrs["end_id"])
    scores = scores_arr.read(scores_arr.length - 1)
    buf_ids, buf_par = ids_arr.buffer, par_arr.buffer           # [C, B, K]
    c, b, k = buf_ids.shape
    n = ids_arr.length
    beam = torch.arange(k, device=buf_ids.device).expand(b, k)
    end = torch.full((), end_id, dtype=buf_ids.dtype, device=buf_ids.device)
    toks = []
    for t in range(c - 1, -1, -1):
        valid = t < n
        toks.append(torch.where(valid, buf_ids[t].gather(1, beam), end))
        beam = torch.where(valid, buf_par[t].to(torch.int64).gather(1, beam),
                           beam)
    env.write(op.outputs["SentenceIds"][0], torch.stack(toks[::-1], dim=2))
    env.write(op.outputs["SentenceScores"][0], scores)


for _type, _rule in (
        ("write_to_array", _write_to_array),
        ("read_from_array", _read_from_array),
        ("lod_array_length", _lod_array_length),
        ("lod_rank_table", _lod_rank_table),
        ("max_sequence_len", _max_sequence_len),
        ("reorder_lod_tensor_by_rank", _reorder_by_rank),
        ("shrink_rnn_memory", _shrink_rnn_memory),
        ("lod_tensor_to_array", _lod_tensor_to_array),
        ("array_to_lod_tensor", _array_to_lod_tensor),
        ("while", _while),
        ("beam_search", _beam_search),
        ("beam_search_decode", _beam_search_decode)):
    registry.register(_type, _rule, special=True)
