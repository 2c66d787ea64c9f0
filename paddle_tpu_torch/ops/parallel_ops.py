"""The `pipeline` op (the GPipe looped pipeline, parallel/pipeline.py) and
the `moe` op (top-1 switch experts, parallel/moe.py).

Parity: the JAX package's ops/parallel_ops.py. layers.pipelined_stack and
layers.switch_moe build them; Executor runs the stages one after the other
and the experts on one device; ParallelExecutor over a mesh with a 'pp'
axis runs the microbatch schedule, with an 'ep' axis splits the expert
products over its replicas.

Both are ordinary rules: a differentiated `pipeline` op runs under its
kept graph (core/lowering.py), so its stages' ops, which have no grad_of
of their own, build their graphs inside it and its grad_of reaches every
stage's parameters (through the K1-K3 autograd Functions of a fused
attention inside a stage too).
"""
import torch

from ..core import registry
from ..core.lowering import (Env, SUB_BLOCK_OVERFLOW, lower_sub_block)
from ..core.registry import single
from ..parallel.moe import moe_layer
from ..parallel.pipeline import _microbatches, run_schedule


def _stage_runner(ctx, attrs):
    """stage_fn(param values, x, stage) -> (y, error flag or None): the
    template sub-block (stage 0's) run with that stage's parameters bound
    to the template names. The stage index is folded into every random
    op's seed (a Python int: the draw stays capturable), so each stage
    draws its own mask, the same for all its microbatches. The error flag
    sweeps the stage's PROGRAM_ERR and tensor-array overflows, as the
    control-flow rules sweep their sub-blocks."""
    from .control_ops import _sweep_overflow
    sub = ctx.program.blocks[attrs["sub_block"]]
    pnames = list(attrs["param_names"])
    in_name, out_name = attrs["in_name"], attrs["out_name"]

    def stage_fn(plist, xin, stage):
        benv = Env(None, (), ctx.device)
        for n, v in zip(pnames, plist):
            benv.write(n, v)
        benv.write(in_name, xin)
        ctx._rng_extra.append(stage)
        try:
            lower_sub_block(ctx, sub, benv)
        finally:
            ctx._rng_extra.pop()
        return benv.read(out_name), _sweep_overflow(benv, None)

    return stage_fn


def _pipeline_lower(ctx, ins, attrs):
    x = single(ins, "X")
    flat = list(ins.get("StageParams", []))
    S = int(attrs["num_stages"])
    Pn = int(attrs["params_per_stage"])
    stage_fn = _stage_runner(ctx, attrs)
    errs = []

    def call(s, xin):
        y, err = stage_fn(flat[s * Pn:(s + 1) * Pn], xin, s)
        if err is not None:
            errs.append(err)
        return y

    mesh = ctx.mesh
    pp = int(mesh.shape.get("pp", 1)) if mesh is not None else 1
    if pp > 1:
        if pp != S:
            raise ValueError(
                "pipeline op has %d stages but the mesh 'pp' axis is %d — "
                "stage count and pipeline ranks must match" % (S, pp))
        M = int(attrs.get("num_microbatches") or 0) or S
        out = torch.cat(run_schedule(call, S, _microbatches(x, M)))
    else:
        out = x
        for s in range(S):
            out = call(s, out)
    if errs:
        err = errs[0]
        for e in errs[1:]:
            err = err | e
        ctx.add_error(SUB_BLOCK_OVERFLOW, err)
    return {"Out": [out]}


def _pipeline_infer(block, op, out_vars):
    xv = block.var_recursive(op.inputs["X"][0])
    ov = block.var_recursive(op.outputs["Out"][0])
    ov.shape, ov.dtype = xv.shape, xv.dtype


registry.register("pipeline", _pipeline_lower, infer=_pipeline_infer)


def _moe_lower(ctx, ins, attrs):
    x = single(ins, "X")
    params = {"gate": single(ins, "Gate"),
              "w1": single(ins, "W1"), "b1": single(ins, "B1"),
              "w2": single(ins, "W2"), "b2": single(ins, "B2")}
    mesh = ctx.mesh
    ep = int(mesh.shape.get("ep", 1)) if mesh is not None else 1
    d = x.shape[-1]
    y, aux = moe_layer(params, x.reshape(-1, d),
                       capacity_factor=float(attrs["capacity_factor"]),
                       ep=ep)
    return {"Out": [y.reshape(x.shape)], "AuxLoss": [aux.reshape(1)]}


def _moe_infer(block, op, out_vars):
    xv = block.var_recursive(op.inputs["X"][0])
    ov = block.var_recursive(op.outputs["Out"][0])
    ov.shape, ov.dtype = xv.shape, xv.dtype
    av = block.var_recursive(op.outputs["AuxLoss"][0])
    av.shape, av.dtype = (1,), "float32"


registry.register("moe", _moe_lower, infer=_moe_infer)
