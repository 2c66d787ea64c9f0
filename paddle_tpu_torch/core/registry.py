"""Operator registry: op type -> PyTorch rule (+ optional shape inference).

Parity: the reference's OpInfoMap / OpKernel registration
(paddle/fluid/framework/op_registry.h) and the JAX package's
core/registry.py. Each op registers ONE rule `fn(ctx, ins, attrs) ->
{slot: [tensor]}` over torch tensors; the same rule runs on the card, on
the CPU, and — for build-time shape inference — on `meta` tensors, which
carry shape and dtype and compute nothing (the counterpart of
`jax.eval_shape`).
"""
import numpy as np
import torch

# sentinels substituted for the dynamic batch dim (-1) during abstract shape
# inference. Outputs are inferred under BOTH; any output dim that DIFFERS
# between the two runs is batch-derived (even when folded into a product by
# reshape, e.g. [-1, K] -> [-1*K]) and maps back to -1, while dims that
# agree are genuinely static.
BATCH_SENTINEL = 1021
BATCH_SENTINEL_B = 1031

META = torch.device("meta")


def torch_dtype(name):
    """Declared dtype string -> torch dtype."""
    return getattr(torch, np.dtype(name).name if name != "bfloat16"
                   else "bfloat16")


def dtype_name(dtype):
    """torch dtype -> declared dtype string ('float32', 'int64', ...)."""
    return str(dtype).replace("torch.", "")


class OpDef(object):
    """An op's rule. A `special` rule is called as lower(ctx, op, env)
    and writes its outputs into the Env itself (a control-flow op whose
    sub-block reads the enclosing block's vars by name: the JAX package's
    register_special); every other rule maps input tensors to output
    tensors."""

    def __init__(self, type, lower, infer=None, uses_rng=False,
                 special=False):
        self.type = type
        self.lower = lower
        self.infer = infer
        self.uses_rng = uses_rng
        self.special = special


_OPS = {}


def register(type, lower=None, infer=None, uses_rng=False, special=False):
    """Register an op. Usable as decorator: @register('relu')."""
    def deco(fn):
        _OPS[type] = OpDef(type, fn, infer=infer, uses_rng=uses_rng,
                           special=special)
        return fn
    if lower is not None:
        return deco(lower)
    return deco


def get(type):
    od = _OPS.get(type)
    if od is None:
        raise NotImplementedError(
            "op %r has no rule in paddle_tpu_torch yet" % (type,))
    return od


def is_registered(type):
    return type in _OPS


def single(ins, slot, default=None):
    """Fetch the single value of an input slot (helper for rules)."""
    vs = ins.get(slot)
    if not vs:
        return default
    return vs[0]


class AbstractCtx(object):
    """LowerCtx stand-in used during meta-tensor shape inference."""
    is_startup = False
    is_abstract = True
    device = META

    def rng(self, salt=0, seed=0):
        return None

    def output_read(self, slot):
        return True  # shape inference builds every output

    def add_error(self, message, flag):
        pass  # shape inference runs no assertion


def _meta_for(var, idx=0):
    """Meta tensor for inference pass `idx` (0 = BATCH_SENTINEL,
    1 = BATCH_SENTINEL_B). Prefers the var's recorded abstract shapes —
    which preserve folded batch products through reshapes that a bare -1
    re-substitution would lose — while they are still current."""
    rec = getattr(var, "_abstract_shapes", None)
    if rec is not None and rec[2] == tuple(var.shape or ()):
        shape = rec[idx]
    elif var.shape is None:
        return None
    else:
        sentinel = (BATCH_SENTINEL, BATCH_SENTINEL_B)[idx]
        shape = tuple(sentinel if d == -1 else d for d in var.shape)
    return torch.empty(shape, dtype=torch_dtype(var.dtype), device=META)


def abstract_eval(block, op):
    """READ-ONLY dual-sentinel abstract evaluation of a registered op.

    Runs the op's rule on meta tensors twice (BATCH_SENTINEL /
    BATCH_SENTINEL_B) and maps sentinel-tracking dims back to -1.

    Returns {slot: [entry | None]} for the op's declared output slots, each
    entry (public_shape_with_-1, (shape_a, shape_b), dtype_name), or None
    when the op can't be evaluated this way (unregistered, custom `infer`,
    un-inferable input, or the rule raising on meta tensors).
    """
    if not is_registered(op.type):
        return None
    od = get(op.type)
    if od.infer is not None or od.special:
        return None
    try:
        ins, ins_b = {}, {}
        has_dynamic = False
        for slot, names in op.inputs.items():
            vars_ = [block.var_recursive(n) for n in names]
            metas = [_meta_for(v) for v in vars_]
            if any(m is None for m in metas):
                return None  # un-inferable input
            has_dynamic = has_dynamic or any(
                -1 in (v.shape or ()) for v in vars_)
            ins[slot] = metas
            ins_b[slot] = [_meta_for(v, 1) for v in vars_]
        ctx = AbstractCtx()
        outs = od.lower(ctx, ins, op.attrs)
        outs_b = od.lower(ctx, ins_b, op.attrs) if has_dynamic else outs
        result = {}
        for slot, vals in outs.items():
            if slot not in op.outputs or not isinstance(vals, (list, tuple)):
                continue
            vals_b = outs_b.get(slot, vals)
            entries = []
            for t, t_b in zip(vals, vals_b):
                if t is None:
                    entries.append(None)
                    continue
                sa = tuple(int(d) for d in t.shape)
                sb = tuple(int(d) for d in t_b.shape)
                public = tuple(-1 if d != db else d for d, db in zip(sa, sb))
                entries.append((public, (sa, sb), dtype_name(t.dtype)))
            result[slot] = entries
        return result
    except Exception:  # noqa: BLE001 — inference is best-effort; running
        return None    # the program gives the real error with its op


def infer_and_set_shapes(block, op):
    """Set output Variable shapes/dtypes by abstractly evaluating the rule.

    Mirrors OpDesc::InferShape/InferVarType in the reference, with zero
    per-op code in the common case.
    """
    if not is_registered(op.type):
        return
    od = get(op.type)
    out_vars = {slot: [block.var_recursive(n) for n in names]
                for slot, names in op.outputs.items()}
    if od.infer is not None:
        od.infer(block, op, out_vars)
        return
    res = abstract_eval(block, op)
    if res is None:
        return
    for slot, entries in res.items():
        for var, entry in zip(out_vars[slot], entries):
            if entry is None:
                continue
            public, (shape_a, shape_b), dtype = entry
            var.shape = public
            var._abstract_shapes = (shape_a, shape_b, var.shape)
            var.dtype = dtype
