"""Elementwise / math / tensor op rules: the activations, the elementwise,
compare and logical families, minus, mul / matmul, concat, split, cos_sim,
the clip ops behind gradient and error clipping, the reductions, the
shape, fill, index and random ops, print, and weight normalization.

Parity: paddle/fluid/operators/{activation_op,elementwise_*_op,minus_op,
mul_op,matmul_op,mean_op,sum_op,concat_op,split_op,transpose_op,
compare_op,logical_op,cos_sim_op,clip_op,clip_by_norm_op,topk_op,scale_op,
reshape_op,squeeze_op,unsqueeze_op,reduce_op,cast_op,one_hot_op,
increment_op,sign_op,assign_op,fill_constant_op,
fill_constant_batch_size_like_op,fill_zeros_like_op,fill_op,
assign_value_op,uniform_random_op,uniform_random_batch_size_like_op,
gaussian_random_op,gaussian_random_batch_size_like_op,
truncated_gaussian_random_op,expand_op,print_op,shape_op,arg_max_op,
is_empty_op,multiplex_op,cumsum_op,gather_op,scatter_op}.cc
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


# ---------------------------------------------------- activations --
# The JAX package's _act table (its ops/basic.py), each with its attrs and
# their defaults. Where it uses a jnp.where or a clip, so does this table,
# so the gradients agree too (torch.maximum and torch.minimum split a tie's
# gradient as jnp.maximum and jnp.minimum do; torch.clamp would not).

def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class _Abs(torch.autograd.Function):
    """|x| with the JAX package's gradient: jax.grad(jnp.abs) is +1 at 0
    (and at -0), where torch.abs's is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _act(name, fn):
    register(name)(lambda ctx, ins, attrs, fn=fn:
                   _out(fn(single(ins, "X"), attrs)))


_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("logsigmoid", lambda x, a: -_softplus(-x))
_act("exp", lambda x, a: torch.exp(x))
_act("relu", lambda x, a: torch.relu(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_act("softshrink", lambda x, a: torch.where(
    x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
    torch.where(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5),
                torch.zeros_like(x))))
_act("sqrt", lambda x, a: torch.sqrt(x))
_act("abs", lambda x, a: _Abs.apply(x))
_act("ceil", lambda x, a: torch.ceil(x))
_act("floor", lambda x, a: torch.floor(x))
_act("cos", lambda x, a: torch.cos(x))
_act("sin", lambda x, a: torch.sin(x))
_act("round", lambda x, a: torch.round(x))
_act("reciprocal", lambda x, a: 1.0 / x)
_act("log", lambda x, a: torch.log(x))
_act("square", lambda x, a: torch.square(x))
_act("softplus", lambda x, a: _softplus(x))
_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_act("brelu", lambda x, a: _clip(x, a.get("t_min", 0.0),
                                 a.get("t_max", 24.0)))
_act("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 0.02) * x))
_act("soft_relu", lambda x, a: torch.log1p(torch.exp(_clip(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_act("elu", lambda x, a: torch.where(
    x > 0, x, a.get("alpha", 1.0) * torch.expm1(x)))
_act("relu6", lambda x, a: _clip(x, 0.0, a.get("threshold", 6.0)))
_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 2.0 / 3.0) * x))
_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_act("hard_sigmoid", lambda x, a: _clip(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))

ACTIVATIONS = (
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "sqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "log", "square", "softplus", "softsign", "brelu",
    "leaky_relu", "soft_relu", "elu", "relu6", "pow", "stanh", "hard_shrink",
    "thresholded_relu", "hard_sigmoid", "swish")


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
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


# ------------------------------------------------ compare / logical --
# Boolean outputs, numpy broadcasting (compare_op.cc, logical_op.cc).

def _compare(name, fn):
    register(name)(lambda ctx, ins, attrs, fn=fn:
                   _out(fn(single(ins, "X"), single(ins, "Y"))))


_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("equal", torch.eq)
_compare("not_equal", torch.ne)
_compare("logical_and", torch.logical_and)
_compare("logical_or", torch.logical_or)
_compare("logical_xor", torch.logical_xor)


@register("logical_not")
def _logical_not(ctx, ins, attrs):
    return _out(torch.logical_not(single(ins, "X")))


@register("concat")
def _concat(ctx, ins, attrs):
    return _out(torch.cat(ins["X"], dim=attrs.get("axis", 0)))


@register("split")
def _split(ctx, ins, attrs):
    """X cut along `axis` into the given `sections`, or into `num` equal
    parts (which must divide the axis, as jnp.split requires)."""
    x = single(ins, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get("num", 1)
        if x.shape[axis] % num:
            raise ValueError("split: axis %d of size %d does not divide "
                             "into %d equal parts"
                             % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine over the last axis, the denominator floored at
    1e-12; also the two norms (cos_sim_op.h)."""
    x, y = single(ins, "X"), single(ins, "Y")
    xn = torch.sqrt(torch.square(x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt(torch.square(y).sum(dim=-1, keepdim=True))
    out = (x * y).sum(dim=-1, keepdim=True) / torch.clamp_min(xn * yn,
                                                              1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register("sign")
def _sign(ctx, ins, attrs):
    return _out(torch.sign(single(ins, "X")))


# ------------------------------------------------------------ clipping --
# Gradient and error clipping (clip.py, core/backward.py) build these. Each
# stays on the device: the norms are tensors, selected with torch.where,
# never read back to the host.

@register("clip")
def _clip_op(ctx, ins, attrs):
    return _out(_clip(single(ins, "X"), attrs["min"], attrs["max"]))


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """X * max_norm / ||X|| where the L2 norm of all of X exceeds
    max_norm, else X (the norm floored at 1e-12 in the division)."""
    x = single(ins, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones_like(norm))
    return _out(x * scale)


@register("reduce_sum_square")
def _reduce_sum_square(ctx, ins, attrs):
    return _out(torch.sum(torch.square(single(ins, "X"))).reshape(1))


@register("global_norm_scale")
def _global_norm_scale(ctx, ins, attrs):
    """min(1, clip_norm / sqrt(X)) as [1], X the summed squares of a
    gradient group (the square root floored at 1e-12)."""
    total_sq = single(ins, "X").reshape(())
    norm = torch.sqrt(total_sq)
    scale = attrs["clip_norm"] / torch.clamp_min(norm, 1e-12)
    return _out(torch.minimum(torch.ones_like(scale), scale).reshape(1))


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


@register("transpose")
def _transpose(ctx, ins, attrs):
    return _out(single(ins, "X").permute(*attrs["axis"]))


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


def _total_order(x):
    """x's values as integers in IEEE total order (-NaN < -inf < ... < -0
    < +0 < ... < inf < NaN), the order lax.top_k ranks floats in; other
    dtypes as they are."""
    if not x.is_floating_point():
        return x
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        return i ^ ((i >> 63) & 0x7FFFFFFFFFFFFFFF)
    i = x.float().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def stable_topk(x, k):
    """(values, indices) of the k largest along the last dim, as
    lax.top_k gives them: a stable descending sort, so among equal values
    the lower index comes first (torch.topk leaves ties in an order of
    its own, fault C12), NaN above inf and +0 above -0."""
    order = torch.sort(_total_order(x), dim=-1, descending=True,
                       stable=True).indices
    idx = order[..., :k]
    return torch.gather(x, -1, idx), idx


@register("topk")
def _topk(ctx, ins, attrs):
    """The k largest along the last dim (stable_topk)."""
    out, idx = stable_topk(single(ins, "X"), attrs.get("k", 1))
    return {"Out": [out], "Indices": [idx]}


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


def _prod(x, dim, keepdim):
    """torch.prod reduces one dim at a time: the highest first, so the
    others keep their places."""
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, fn):
    """reduce_<fn> over attr dim (an int or a list), or every dim with
    reduce_all ([1] then unless keep_dim). max and min are torch.amax and
    torch.amin, which split a tie's gradient evenly as jnp.max does."""
    def lower(ctx, ins, attrs):
        x = single(ins, "X")
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all"):
            out = fn(x, tuple(range(x.dim())), keep)
            return _out(out if keep else out.reshape(1))
        dim = attrs.get("dim", 0)
        dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return _out(fn(x, dim, keep))
    register(name)(lower)


_reduce("reduce_sum", lambda x, d, k: x.sum(dim=d, keepdim=k))
_reduce("reduce_mean", lambda x, d, k: x.mean(dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce("reduce_prod", _prod)


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


def _batch_size_like(ref, attrs):
    """A *_batch_size_like op's shape: attr shape with dim output_dim_idx
    copied from Input's dim input_dim_idx."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return shape


@register("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """A constant whose dim output_dim_idx copies Input's dim
    input_dim_idx (an RNN memory's boot value takes the batch so)."""
    ref = single(ins, "Input")
    shape = _batch_size_like(ref, attrs)
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
    return _out(ctx.host_constant(arr))


def _random(ctx, attrs, fill, shape=None):
    """A draw of attr shape (-1 read as 1), or `shape`, from the op's
    generator (ctx.rng: the run's seed, or the op's seed attr)."""
    if shape is None:
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


@register("uniform_random_batch_size_like", uses_rng=True)
def _uniform_random_bsl(ctx, ins, attrs):
    return _random(ctx, attrs, lambda t, g: t.uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0), generator=g),
        _batch_size_like(single(ins, "Input"), attrs))


@register("gaussian_random_batch_size_like", uses_rng=True)
def _gaussian_random_bsl(ctx, ins, attrs):
    return _random(ctx, attrs, lambda t, g: t.normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0), generator=g),
        _batch_size_like(single(ins, "Input"), attrs))


_PHI2 = 0.9772498680518208   # the standard normal's CDF at 2


def _truncated_normal(t, mean, std, g):
    """N(mean, std) cut at two standard deviations, as
    jax.random.truncated_normal(-2, 2) scaled: a uniform draw between
    the CDF's values at -2 and 2 through the inverse CDF."""
    t.uniform_(1.0 - _PHI2, _PHI2, generator=g)
    t.mul_(2.0).sub_(1.0).erfinv_().mul_(std * 2.0 ** 0.5).add_(mean)
    return t


@register("truncated_gaussian_random", uses_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    return _random(ctx, attrs, lambda t, g: _truncated_normal(
        t, attrs.get("mean", 0.0), attrs.get("std", 1.0), g))


# ------------------------------------------ shape, fill and index ops --

@register("minus")
def _minus(ctx, ins, attrs):
    return _out(single(ins, "X") - single(ins, "Y"))


@register("expand")
def _expand(ctx, ins, attrs):
    """x tiled expand_times along each dim (np.tile's rule)."""
    return _out(torch.tile(single(ins, "X"), tuple(attrs["expand_times"])))


_printed = {}   # id of a print op's attrs -> times it has printed


@register("print")
def _print(ctx, ins, attrs):
    """Identity that prints `message`, the var's name, dtype and shape and
    its first `summarize` values (all when -1) each time it runs, at most
    first_n times an op (-1: always). On the card the print copies the
    values to the host, a sync, as any print of a device value does."""
    x = single(ins, "In")
    if x.device.type == "meta":
        return _out(x)
    parts = [attrs.get("message") or ""]
    if attrs.get("print_tensor_name", True):
        parts.append(attrs.get("var_name", ""))
    if attrs.get("print_tensor_type", True):
        parts.append(str(np.dtype(str(x.dtype).replace("torch.", ""))))
    if attrs.get("print_tensor_shape", True):
        parts.append(str(tuple(x.shape)))
    shown = x.detach().reshape(-1)
    summarize = attrs.get("summarize", -1)
    if summarize and summarize > 0:
        shown = shown[:summarize]
    first_n = attrs.get("first_n", -1)
    n = _printed.get(id(attrs), 0)
    if first_n < 0 or n < first_n:
        _printed[id(attrs)] = n + 1
        print(" ".join(p for p in parts if p), shown.cpu().numpy())
    return _out(x)


@register("shape")
def _shape(ctx, ins, attrs):
    x = single(ins, "Input")
    return _out(ctx.host_constant(np.asarray(x.shape, dtype=np.int32)))


@register("arg_max")
def _arg_max(ctx, ins, attrs):
    """The first index of the largest value along attr axis, int64."""
    return _out(torch.argmax(single(ins, "X"), dim=attrs.get("axis", -1)))


@register("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return _out(torch.zeros_like(single(ins, "X")))


@register("fill")
def _fill(ctx, ins, attrs):
    """Out = the row-major float list `value` in `shape`, cast to
    `dtype` (force_cpu places nothing: the program's device holds it)."""
    arr = np.asarray(attrs["value"], dtype=np.float32).reshape(
        attrs["shape"]).astype(_attr_np_dtype(attrs))
    return _out(ctx.host_constant(arr))


@register("is_empty")
def _is_empty(ctx, ins, attrs):
    x = single(ins, "X")
    return _out(ctx.host_constant(np.asarray(x.numel() == 0)))


@register("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of the output is row i of input Ids[i]."""
    ids = single(ins, "Ids").reshape(-1).long()
    xs = torch.stack(ins["X"], dim=0)   # [candidates, batch, ...]
    return _out(xs[ids, torch.arange(ids.shape[0], device=ids.device)])


@register("cumsum")
def _cumsum(ctx, ins, attrs):
    """Running sum along attr axis; exclusive drops each element's own
    term, reverse runs from the end (the JAX rule's order of operations,
    so the gradients agree too)."""
    x = single(ins, "X")
    axis = attrs.get("axis", -1)
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive"):
        out = out - x
    if attrs.get("reverse"):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
        if attrs.get("exclusive"):
            out = out - x
    return _out(out)


@register("gather")
def _gather(ctx, ins, attrs):
    """Rows Index of X (along dim 0)."""
    x, idx = single(ins, "X"), single(ins, "Index")
    return _out(x[idx.reshape(-1).long()])


@register("scatter")
def _scatter(ctx, ins, attrs):
    """X with rows Ids replaced by Updates (out of place)."""
    x, ids, upd = single(ins, "X"), single(ins, "Ids"), single(ins, "Updates")
    out = x.clone()
    out[ids.reshape(-1).long()] = upd
    return _out(out)


# ------------------------------------------------ weight normalization --

def _wn_axes(x, dim):
    return tuple(i for i in range(x.dim()) if i != dim) if dim is not None \
        else tuple(range(x.dim()))


@register("wn_norm")
def _wn_norm(ctx, ins, attrs):
    """||X|| over every axis but attr dim: weight norm's g at startup."""
    x = single(ins, "X")
    return _out(torch.sqrt(torch.sum(torch.square(x), dim=_wn_axes(
        x, attrs.get("dim")))).reshape(-1))


@register("weight_norm")
def _weight_norm(ctx, ins, attrs):
    """W = G * V / ||V||, the norm over every axis but attr dim (the
    reference's 9-op weight-norm graph as one op, as in the JAX
    package); autograd gives the G and V gradients."""
    g, v = single(ins, "G"), single(ins, "V")
    dim = attrs.get("dim")
    norm = torch.sqrt(torch.sum(torch.square(v), dim=_wn_axes(v, dim),
                                keepdim=True))
    shape = [v.shape[dim] if i == dim else 1 for i in range(v.dim())]
    return _out(v * (g.reshape(shape) / torch.clamp_min(norm, 1e-12)))
