"""Elementwise / math / tensor op rules (the subset the Transformer's, the
sentiment classifiers' and the attention translator's programs run).

Parity: paddle/fluid/operators/{activation_op,elementwise_*_op,mul_op,
matmul_op,mean_op,sum_op,topk_op,scale_op,reshape_op,squeeze_op,
unsqueeze_op,reduce_op,cast_op,one_hot_op,increment_op,sign_op,assign_op,
fill_constant_op,fill_constant_batch_size_like_op,assign_value_op,
uniform_random_op,gaussian_random_op}.cc
and the JAX package's ops/basic.py, whose rules these mirror over torch
tensors. `mul` stays a plain torch.matmul: the JAX package left the matrix
product to XLA, outside any Pallas kernel. Gradients come from autograd
through these same rules (core/lowering.py:_lower_grad_of).
"""
import numpy as np
import torch

from ..core.registry import register, single, torch_dtype


def _out(x):
    return {"Out": [x]}


@register("relu")
def _relu(ctx, ins, attrs):
    return _out(torch.relu(single(ins, "X")))


@register("tanh")
def _tanh(ctx, ins, attrs):
    return _out(torch.tanh(single(ins, "X")))


def _bcast_y(x, y, axis):
    """Fluid broadcast: Y's shape must match a contiguous run of X's dims
    starting at `axis` (axis=-1 => trailing alignment, numpy-style)."""
    if x.dim() == y.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) + \
        (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


def _elementwise(name, fn):
    def lower(ctx, ins, attrs):
        x, y = single(ins, "X"), single(ins, "Y")
        return _out(fn(x, _bcast_y(x, y, attrs.get("axis", -1))))
    register(name)(lower)


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


@register("sign")
def _sign(ctx, ins, attrs):
    return _out(torch.sign(single(ins, "X")))


@register("mul")
def _mul(ctx, ins, attrs):
    x, y = single(ins, "X"), single(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    lead = int(np.prod(x.shape[:xn])) if xn > 0 else 1
    x2 = x.reshape(lead, -1)
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1)
    out = torch.matmul(x2, y2)
    return _out(out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:])))


@register("matmul")
def _matmul(ctx, ins, attrs):
    """Batched matmul with fluid's transpose_X / transpose_Y and alpha."""
    x, y = single(ins, "X"), single(ins, "Y")
    if attrs.get("transpose_X") and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y") and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return _out(out)


@register("squeeze")
def _squeeze(ctx, ins, attrs):
    """Drop the size-1 dims `axes` (every size-1 dim when none are given;
    dropping a dim of another size fails in the reshape)."""
    x = single(ins, "X")
    axes = attrs.get("axes") or [i for i, d in enumerate(x.shape) if d == 1]
    axes = {a % x.dim() for a in axes}
    return _out(x.reshape([d for i, d in enumerate(x.shape)
                           if i not in axes]))


@register("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = single(ins, "X")
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return _out(x)


@register("scale")
def _scale(ctx, ins, attrs):
    x = single(ins, "X")
    out = x * attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if bias:
        if attrs.get("bias_after_scale", True):
            out = out + bias
        else:
            out = (x + bias) * attrs.get("scale", 1.0)
    return _out(out)


@register("mean")
def _mean(ctx, ins, attrs):
    return _out(torch.mean(single(ins, "X")).reshape(1))


@register("sum")
def _sum(ctx, ins, attrs):
    """Sum of the X inputs (a multi-input fc emits it)."""
    xs = ins.get("X", [])
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return _out(out)


@register("topk")
def _topk(ctx, ins, attrs):
    vals, idx = torch.topk(single(ins, "X"), attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}


@register("reshape")
def _reshape(ctx, ins, attrs):
    x = single(ins, "X")
    # fluid semantics: 0 copies the input's dim, -1 infers
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return _out(x.reshape(shape))


@register("assign")
def _assign(ctx, ins, attrs):
    """calc_gradient seeds a target's gradient with it."""
    return _out(single(ins, "X"))


@register("cast")
def _cast(ctx, ins, attrs):
    return _out(single(ins, "X").to(
        torch_dtype(np.dtype(attrs["out_dtype"]).name)))


@register("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    x = single(ins, "X")
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all"):
        out = x.sum(dim=tuple(range(x.dim())), keepdim=keep)
        return _out(out if keep else out.reshape(1))
    dim = attrs.get("dim", 0)
    dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim
    return _out(x.sum(dim=dim, keepdim=keep))


@register("one_hot")
def _one_hot(ctx, ins, attrs):
    """float32 one-hot over the last dim (a trailing 1 is dropped); an id
    outside [0, depth) gives a zero row, as jax.nn.one_hot does."""
    x = single(ins, "X")
    idx = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    cols = torch.arange(attrs["depth"], device=x.device)
    return _out((idx.long()[..., None] == cols).to(torch.float32))


@register("increment")
def _increment(ctx, ins, attrs):
    x = single(ins, "X")
    step = attrs.get("step", 1.0)
    return _out(x + (step if x.is_floating_point() else int(step)))


def _attr_np_dtype(attrs, default="float32"):
    """A "dtype" attr that may be a numpy-style string (the layers) OR the
    era framework.proto VarType enum int (5=FP32, 2=INT32, ...)."""
    v = attrs.get("dtype", default)
    if isinstance(v, (int, np.integer)):
        table = {0: "bool", 1: "int16", 2: "int32", 3: "int64",
                 4: "float16", 5: "float32", 6: "float64"}
        v = table.get(int(v), default)
    return np.dtype(v)


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = [1 if s == -1 else s for s in attrs.get("shape", [1])]
    return _out(torch.full(shape, attrs.get("value", 0.0),
                           dtype=torch_dtype(_attr_np_dtype(attrs).name),
                           device=ctx.device))


@register("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """A constant whose dim output_dim_idx copies Input's dim
    input_dim_idx (an RNN memory's boot value takes the batch so)."""
    ref = single(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return _out(torch.full(shape, attrs.get("value", 0.0),
                           dtype=torch_dtype(_attr_np_dtype(attrs).name),
                           device=ref.device))


@register("assign_value")
def _assign_value(ctx, ins, attrs):
    """assign_value_op.cc stores the payload in a dtype-suffixed attr
    (fp32_values / int32_values) in era descs — accept those alongside the
    layers' own "values"."""
    dtype = _attr_np_dtype(attrs)
    if "values" in attrs:
        vals = attrs["values"]
    elif dtype == np.int32 and "int32_values" in attrs:
        vals = attrs["int32_values"]
    elif "fp32_values" in attrs:
        vals = attrs["fp32_values"]
    else:
        raise KeyError("assign_value: none of values/fp32_values/int32_values "
                       "in attrs %r" % sorted(attrs))
    arr = np.asarray(vals, dtype=dtype).reshape(attrs["shape"])
    return _out(torch.from_numpy(np.ascontiguousarray(arr)).to(ctx.device))


def _random(ctx, attrs, fill):
    shape = [1 if s == -1 else s for s in attrs["shape"]]
    out = torch.empty(shape, dtype=torch_dtype(_attr_np_dtype(attrs).name),
                      device=ctx.device)
    if out.device.type != "meta":
        fill(out, ctx.rng(seed=attrs.get("seed", 0)))
    return _out(out)


@register("uniform_random", uses_rng=True)
def _uniform_random(ctx, ins, attrs):
    return _random(ctx, attrs, lambda t, g: t.uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0), generator=g))


@register("gaussian_random", uses_rng=True)
def _gaussian_random(ctx, ins, attrs):
    return _random(ctx, attrs, lambda t, g: t.normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0), generator=g))
