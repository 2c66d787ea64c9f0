"""Control-flow op rules: rnn_scan (the lowering target of StaticRNN and
DynamicRNN) and conditional_block in its scalar form (the lowering target
of Switch).

Parity: the recurrent_op / DynamicRNN machinery of the reference and the
JAX package's ops/control_ops.py, whose rnn_scan is one masked lax.scan
over the step block. Here it is a Python loop over the T steps: each step
runs the step block's ops (core/lowering.lower_sub_block) in a fresh Env
holding the statics, the memories and the step's slices of the inputs.

Gradients: the whole loop is ONE op. When some grad_of differentiates it,
its rule runs under autograd (core/lowering.py), so the kept graph spans
all T steps and reaches every Static input (the step block's parameters
and closed-over tensors): the step block's ops keep no graphs of their
own.

conditional_block runs its block on every run and selects each output
against its previous value with torch.where on the scalar condition, as
the JAX rule does: the condition never leaves the device, so the step has
no host sync and stays capturable by a CUDA graph.
"""
import torch

from ..core import registry
from ..core.lowering import Env, EnvReadError, lower_sub_block
from ..core.registry import single


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
    """Scalar form (is_scalar_condition=True): the block runs
    unconditionally in a copy of the enclosing Env, and each out var
    becomes where(cond, block's value, previous value), the previous value
    zeros when nothing wrote it before. A Switch's cases carry exclusive
    conditions (case i: cond_i and no earlier cond), so the last where
    reproduces first-match-wins. A special rule (it reads the Env: the
    block closes over the enclosing block's vars by name, and an out var
    may have no previous value)."""
    attrs = op.attrs
    if not attrs.get("is_scalar_condition", True):
        raise NotImplementedError(
            "conditional_block with is_scalar_condition=False (the IfElse "
            "form, split_lod_tensor / merge_lod_tensor) is not ported yet "
            "(ROADMAP A6)")
    sub = ctx.program.blocks[attrs["sub_block"]]
    cond = env.read(op.inputs["Cond"][0]).reshape(()).to(torch.bool)
    benv = env.fork()
    lower_sub_block(ctx, sub, benv)
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
