"""NN op rules: layer_norm, fused_attention, lookup_table, dropout,
softmax_with_cross_entropy, softmax, log_softmax, cross_entropy,
sigmoid_cross_entropy_with_logits, square_error_cost, label_smooth,
accuracy, auc, conv2d, depthwise_conv2d, conv2d_transpose, pool2d,
maxout, batch_norm, lrn, l2_normalize, nce and the losses smooth_l1_loss,
log_loss, huber_loss, hinge_loss, rank_loss and margin_rank_loss.

Parity: paddle/fluid/operators/{layer_norm_op,lookup_table_op,dropout_op,
softmax_with_cross_entropy_op,softmax_op,cross_entropy_op,
sigmoid_cross_entropy_with_logits_op,squared_l2_distance_op,
label_smooth_op,accuracy_op,auc_op,conv_op,conv_transpose_op,pool_op,
maxout_op,batch_norm_op,lrn_op,norm_op,nce_op,smooth_l1_loss_op,
log_loss_op,huber_loss_op,hinge_loss_op,rank_loss_op,
margin_rank_loss_op}.cc and the JAX package's ops/nn_ops.py.
layer_norm with scale and bias, the flash branch of fused_attention and
the hard-label 2-D softmax_with_cross_entropy call the hand-written CUDA
kernels through their wrappers (ops/cuda_kernels.py), which dispatch by
device: the same rule runs the kernel on the card, the plain version on
the CPU, and computes nothing on `meta` tensors during build-time shape
inference. Each goes through its kernel's autograd Function, whose
backward is the kernel's backward; under no_grad (every inference run, and
every op no grad_of differentiates) the Function records nothing.
"""
import math

import numpy as np
import torch

from ..core.registry import register, single
from . import cuda_kernels
from .kernel_config import flash_at, reference_is_dense

_NEG_INF = -1e30


def _out(x):
    return {"Out": [x]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = single(ins, "X")
    scale = single(ins, "Scale")
    bias = single(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = int(np.prod(x.shape[:begin]))
    x2 = x.reshape(lead, -1)
    if scale is not None and bias is not None:
        args = (x2, scale.reshape(-1), bias.reshape(-1), eps)
        y, mean, var = cuda_kernels.LayerNorm.apply(*args)
        return {"Y": [y.reshape(x.shape).to(x.dtype)],
                "Mean": [mean], "Variance": [var]}
    xf = x2.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(1, -1)
    if bias is not None:
        y = y + bias.reshape(1, -1)
    return {"Y": [y.reshape(x.shape).to(x.dtype)],
            "Mean": [mean.reshape(lead)], "Variance": [var.reshape(lead)]}


def attention_reference(q, k, v, causal=False, scale=None, kv_len=None):
    """Dense single-device attention over [B, T, H, D] (parity:
    paddle_tpu/parallel/ring_attention.py attention_reference). kv_len:
    optional [B] or [B, 1] true key lengths. A row with no valid key
    softmaxes uniformly over the -1e30 logits, as the reference does; the
    flash path (cuda_kernels.flash_attention_fwd_plain) gives 0 there."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    if kv_len is not None:
        kv_len = kv_len.reshape(k.shape[0])
        kpos = torch.arange(k.shape[1], device=q.device)
        kmask = kpos[None, :] < kv_len[:, None]
        logits = torch.where(kmask[:, None, None, :], logits,
                             torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@register("fused_attention")
def _fused_attention(ctx, ins, attrs):
    """Attention of q [B, Tq, H, D] over k, v [B, Tk, H, D] with optional
    [B] / [B, 1] key lengths. kernel_config.flash_at decides flash (the
    CUDA kernel's wrapper, Tq = Tk) or the dense reference (Tq != Tk, or
    Tq <= 1); the block_q / block_k / sp_impl attrs are TPU and mesh knobs
    the JAX package reads and this rule ignores.

    A row with no valid key (kv_len <= 0) on the flash path comes back as
    the mean of v over all keys where the JAX package would have answered
    through its dense path (kernel_config.reference_is_dense: below its
    1024 crossover), by a select with no host sync, so v's gradient
    follows; above it both packages' flash kernels give 0 (fault C9).
    The flash kernels take q, k, v all fp32 or all bf16 (a program under
    enable_mixed_precision casts them to bf16): out comes back in their
    dtype, every product and sum in fp32, as the TPU kernels do."""
    q = single(ins, "Q")
    k = single(ins, "K")
    v = single(ins, "V")
    kv_len = single(ins, "KVLen") if ins.get("KVLen") else None
    if kv_len is not None:
        kv_len = kv_len.reshape(-1)
    causal = attrs.get("causal", False)
    scale = attrs.get("scale", None)
    t = q.shape[1]
    if not flash_at(t, q.device.type, k.shape[1]):
        return _out(attention_reference(q, k, v, causal=causal, scale=scale,
                                        kv_len=kv_len).to(q.dtype))
    out = cuda_kernels.FlashAttention.apply(q, k, v, kv_len, causal, scale)
    if kv_len is not None and reference_is_dense(t):
        empty = (kv_len <= 0).reshape(-1, 1, 1, 1)
        out = torch.where(empty, v.mean(dim=1, keepdim=True).to(out.dtype),
                          out)
    return _out(out)


@register("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Rows of W [V, D] for the ids, with the JAX rule's jnp.take
    semantics and no host sync: an id in [-V, 0) wraps to id + V; any
    other id outside [0, V) gives a row of NaN (the index is clamped for
    the gather, then the row replaced), and W gets no gradient from it.
    A bad token id thus poisons only its own row, never the device (an
    out-of-range index_select is a device-side assert on the card)."""
    w = single(ins, "W")        # [V, D]
    ids = single(ins, "Ids")    # [..., 1] or [...] int
    flat = ids.reshape(-1).long()
    v = w.shape[0]
    valid = (flat >= -v) & (flat < v)
    idx = torch.where(flat < 0, flat + v, flat).clamp(0, v - 1)
    out = torch.where(valid[:, None], w.index_select(0, idx),
                      torch.full((), float("nan"), dtype=w.dtype,
                                 device=w.device))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((flat == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    if ids.dim() and ids.shape[-1] == 1:
        out_shape = tuple(ids.shape[:-1]) + (w.shape[-1],)
    else:
        out_shape = tuple(ids.shape) + (w.shape[-1],)
    return _out(out.reshape(out_shape))


@register("dropout", uses_rng=True)
def _dropout(ctx, ins, attrs):
    """Out = X * Mask with Mask (X's dtype) 1 where a uniform draw on X's
    device falls below 1 - dropout_prob, else 0: the JAX rule's
    bernoulli(1 - p), fluid's downgrade_in_infer, so no rescale in
    training. With is_test, Out = X * (1 - p) and Mask is all ones. The
    draw comes from the op's generator (LowerCtx.rng): a nonzero `seed`
    attr pins the mask across runs, seed 0 draws anew each run and each
    step of a loop body. The backward differentiates the kept graph of
    this one draw (dX = dOut * Mask), so it never draws again."""
    x = single(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False):
        return {"Out": [x * (1.0 - p)], "Mask": [torch.ones_like(x)]}
    draw = torch.rand(x.shape, generator=ctx.rng(seed=attrs.get("seed", 0)),
                      device=x.device)
    mask = (draw < 1.0 - p).to(x.dtype)
    return {"Out": [x * mask], "Mask": [mask]}


@register("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """(1 - epsilon) * X + epsilon * PriorDist, or + epsilon / C (C the
    last dim) without a prior."""
    x = single(ins, "X")
    eps = attrs.get("epsilon", 0.0)
    dist = single(ins, "PriorDist")
    if dist is not None:
        return _out((1 - eps) * x + eps * dist)
    return _out((1 - eps) * x + eps / x.shape[-1])


@register("softmax")
def _softmax(ctx, ins, attrs):
    return _out(torch.softmax(single(ins, "X"), dim=-1))


@register("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """-log of the label's probability (X holds probabilities), floored at
    1e-20 as the JAX rule does."""
    x = single(ins, "X")
    label = single(ins, "Label")
    logp = torch.log(torch.clamp_min(x, 1e-20))
    if attrs.get("soft_label", False):
        return {"Y": [-(label * logp).sum(dim=-1, keepdim=True)]}
    return {"Y": [-_gather_label_logits(logp, label)[..., None]]}


@register("accuracy")
def _accuracy(ctx, ins, attrs):
    """Share of rows whose label is among the top-k Indices."""
    pred_idx = single(ins, "Indices")   # [N, k] from topk
    label = single(ins, "Label")        # [N, 1]
    n = pred_idx.shape[0]
    correct = (pred_idx.long() == label.long().reshape(-1, 1)).any(dim=1)
    num_correct = correct.to(torch.float32).sum()
    return {"Accuracy": [(num_correct / n).reshape(1)],
            "Correct": [num_correct.to(torch.int32).reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=pred_idx.device)]}


def _gather_label_logits(logp, label):
    """[..., C] values + [..., 1] (or [...]) int labels -> [...] picked
    values, the label mapped to its class by
    cuda_kernels.hard_label_index."""
    flat = logp.reshape(-1, logp.shape[-1])
    lab = cuda_kernels.hard_label_index(label.reshape(-1, 1), flat.shape[-1])
    return flat.gather(1, lab).reshape(logp.shape[:-1])


@register("softmax_with_cross_entropy")
def _softmax_xent(ctx, ins, attrs):
    """Hard labels on 2-D logits take the K4 kernel (loss and row lse in
    one pass). A hard label outside [0, V) picks the class of
    cuda_kernels.hard_label_index on every path and rank (-1 -> V - 1,
    V + k -> V - 1), as the JAX package's CPU path does. The Softmax
    output the op also declares ([N, V], exp(logits - lse) from K4's lse,
    not a second reduction) is built only when some op, fetch or the
    scope reads it (ctx.output_read): the JAX rule leaves an unread one to
    XLA to drop, and eager PyTorch would materialize it at every step.
    Soft labels and other ranks take the plain log-softmax path."""
    logits = single(ins, "Logits")
    label = single(ins, "Label")
    soft = attrs.get("soft_label", False)
    if not soft and logits.dim() == 2:
        lab = label.reshape(-1)
        loss, lse = cuda_kernels.SoftmaxXent.apply(logits, lab)
        outs = {"Loss": [loss.to(logits.dtype)]}
        if ctx.output_read("Softmax"):
            outs["Softmax"] = [torch.exp(logits.float() - lse)
                               .to(logits.dtype)]
        return outs
    logp = torch.log_softmax(logits.float(), dim=-1)
    if soft:
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        loss = -_gather_label_logits(logp, label)[..., None]
    outs = {"Loss": [loss.to(logits.dtype)]}
    if ctx.output_read("Softmax"):
        outs["Softmax"] = [torch.exp(logp).to(logits.dtype)]
    return outs


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ctx, ins, attrs):
    """Elementwise max(x, 0) - x z + log1p(exp(-|x|)): stable for logits
    of any size."""
    x = single(ins, "X")
    label = single(ins, "Label")
    return _out(torch.maximum(x, torch.zeros_like(x)) - x * label
                + torch.log1p(torch.exp(-torch.abs(x))))


@register("square_error_cost")
def _square_error(ctx, ins, attrs):
    return _out(torch.square(single(ins, "X") - single(ins, "Y")))


# ------------------------------------------------------- conv net family --
# Plain torch calls (cuDNN on the card): the JAX package leaves conv, pool
# and batch_norm to XLA, outside any Pallas kernel. Layouts are fluid's
# NCHW / OIHW; the JAX rule's FLAGS_conv_layout (an internal TPU layout
# knob, the fluid-facing contract NCHW either way) is not read here.

def pair(v):
    """An int or a 2-sequence -> an (h, w) tuple of ints."""
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


@register("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter, with strides, symmetric paddings,
    dilations and groups. Under mixed precision both operands arrive
    bf16 (core/lowering.py casts them) and cuDNN accumulates in fp32."""
    x = single(ins, "Input")
    w = single(ins, "Filter")
    out = torch.nn.functional.conv2d(
        x, w, stride=pair(attrs.get("strides", [1, 1])),
        padding=pair(attrs.get("paddings", [0, 0])),
        dilation=pair(attrs.get("dilations", [1, 1])),
        groups=attrs.get("groups", 1) or 1)
    return {"Output": [out.to(x.dtype)]}


@register("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    """max / avg pooling over NCHW with the JAX rule's edges, which
    torch's own ceil_mode and count_include_pad do not give: ceil_mode
    adds padding at the end only, as much as makes ceil((H - k + 2p) / s)
    + 1 windows (a window may then lie wholly in padding: -inf for max, 0
    for avg); max pads with -inf; avg divides by the window's count of
    real elements when `exclusive` (the default) and there is padding or
    ceil_mode extra, else by kh * kw. global_pooling takes the whole
    plane with no padding."""
    f = torch.nn.functional
    x = single(ins, "X")
    ksize = pair(attrs.get("ksize", [2, 2]))
    strides = pair(attrs.get("strides", [1, 1]))
    pads = pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling"):
        ksize, pads, strides = (x.shape[2], x.shape[3]), (0, 0), (1, 1)
    extra = [0, 0]
    if attrs.get("ceil_mode", False):
        for d, hw in enumerate((x.shape[2], x.shape[3])):
            span = hw - ksize[d] + 2 * pads[d]
            out_ceil = -(-span // strides[d]) + 1
            extra[d] = max(0, (out_ceil - 1) * strides[d] - span)
    # F.pad's order: (w begin, w end, h begin, h end)
    widths = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    padded = any(widths)
    if attrs.get("pooling_type", "max") == "max":
        xp = f.pad(x, widths, value=float("-inf")) if padded else x
        out = f.max_pool2d(xp, ksize, strides)
    elif attrs.get("exclusive", True) and padded:
        s = f.avg_pool2d(f.pad(x, widths), ksize, strides,
                         divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = f.avg_pool2d(f.pad(ones, widths), ksize, strides,
                           divisor_override=1)
        out = s / cnt.clamp_min(1.0)
    else:
        out = f.avg_pool2d(f.pad(x, widths) if padded else x, ksize,
                           strides)
    return _out(out.to(x.dtype))


@register("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """Batch normalization over every axis but the channel axis (1 for
    NCHW input of rank > 2, the last otherwise), as the JAX rule does.
    Training: the batch mean and the BIASED batch variance normalize x
    (torch.batch_norm's dispatch with no running stats: cuDNN on the card,
    whose saved mean and inverse std give the batch statistics); the moving
    statistics become momentum * old + (1 - momentum) * batch, outside
    the gradient (torch's own running update is unbiased, with
    the momentum the other way round, so it is not used); SavedMean and
    SavedVariance are the batch mean and variance themselves. is_test
    normalizes by the moving statistics and passes them through.
    Statistics are fp32 whatever x's dtype; Y takes x's dtype."""
    x = single(ins, "X")
    scale = single(ins, "Scale")
    bias = single(ins, "Bias")
    mean = single(ins, "Mean")
    var = single(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    nchw = attrs.get("data_layout", "NCHW") == "NCHW" and x.dim() > 2
    xc = x if nchw or x.dim() == 2 else x.movedim(-1, 1)
    # torch.batch_norm, not F.batch_norm: the latter refuses a channel
    # with one value per batch, which the JAX rule normalizes (to bias)
    cudnn = torch.backends.cudnn.enabled
    if attrs.get("is_test", False):
        y = torch.batch_norm(xc, scale, bias, mean, var, False, 0.0, eps,
                             cudnn)
        mean_out, var_out, saved_mean, saved_var = mean, var, mean, var
    else:
        # torch.batch_norm's own dispatch (cuDNN or native), keeping the
        # batch mean and 1 / sqrt(var + eps) it saves for the backward, so
        # x is reduced once
        y, saved_mean, invstd = torch._batch_norm_impl_index(
            xc, scale, bias, None, None, True, 0.0, eps, cudnn)[:3]
        saved_mean = saved_mean.detach()
        saved_var = invstd.detach().pow(-2) - eps
        mean_out = momentum * mean + (1 - momentum) * saved_mean
        var_out = momentum * var + (1 - momentum) * saved_var
    if xc is not x:
        y = y.movedim(1, -1)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [saved_mean],
            "SavedVariance": [saved_var]}


@register("lrn")
def _lrn(ctx, ins, attrs):
    """Local response normalization across channels of an NCHW input:
    mid = k + alpha * (sum of x^2 over the n channels centred on c),
    out = x / mid^beta (lrn_op.h). MidOut is mid."""
    x = single(ins, "X")
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    sq = torch.nn.functional.pad(torch.square(x),
                                 (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """The input gradient of a conv2d: NCHW input, filter [C_in, C_out,
    kh, kw] (torch's conv_transpose2d layout as it is), fluid's paddings
    those of the forward conv: out (H - 1) stride - 2 pad + dil (k - 1) +
    1. groups must be 1, as the reference enforces."""
    x = single(ins, "Input")
    w = single(ins, "Filter")
    if int(attrs.get("groups", 1) or 1) != 1:
        raise ValueError(
            "conv2d_transpose: groups != 1 is not supported (the "
            "reference enforces groups == 1 for transposed convolution)")
    out = torch.nn.functional.conv_transpose2d(
        x, w, stride=pair(attrs.get("strides", [1, 1])),
        padding=pair(attrs.get("paddings", [0, 0])),
        dilation=pair(attrs.get("dilations", [1, 1])))
    return {"Output": [out.to(x.dtype)]}


@register("maxout")
def _maxout(ctx, ins, attrs):
    """NCHW: the max over each group of `groups` consecutive channels."""
    x = single(ins, "X")
    g = attrs["groups"]
    n, c, h, w = x.shape
    return _out(torch.amax(x.reshape(n, c // g, g, h, w), dim=2))


@register("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    """X / sqrt(sum(X^2) along attr axis + epsilon)."""
    x = single(ins, "X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


@register("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return _out(torch.log_softmax(single(ins, "X"), dim=-1))


# ------------------------------------------------------------- losses --

@register("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    """Per row, the sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, with d = (X - Y) * InsideWeight and each term
    times OutsideWeight (when given)."""
    x, y = single(ins, "X"), single(ins, "Y")
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    iw, ow = single(ins, "InsideWeight"), single(ins, "OutsideWeight")
    if iw is not None:
        diff = diff * iw
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ow is not None:
        elem = elem * ow
    loss = torch.sum(elem.reshape(elem.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [loss], "Diff": [diff]}


@register("log_loss")
def _log_loss(ctx, ins, attrs):
    p, label = single(ins, "Predicted"), single(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = single(ins, "X"), single(ins, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


def _relu_max(x):
    """max(0, x) with jnp.maximum's gradient (split at a tie)."""
    return torch.maximum(torch.zeros_like(x), x)


@register("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits, labels = single(ins, "Logits"), single(ins, "Labels")
    return {"Loss": [_relu_max(1.0 - (2.0 * labels - 1.0) * logits)]}


@register("rank_loss")
def _rank_loss(ctx, ins, attrs):
    """log(1 + exp(Left - Right)) - Label (Left - Right)."""
    label = single(ins, "Label")
    d = single(ins, "Left") - single(ins, "Right")
    return _out(torch.log1p(torch.exp(d)) - label * d)


@register("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    label = single(ins, "Label")
    x1, x2 = single(ins, "X1"), single(ins, "X2")
    act = _relu_max(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


# ------------------------------------------------------------ metrics --

@register("auc")
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC: each prediction's positive score (column 1 of a
    two-column Predict) falls in one of num_thresholds buckets, TP / FP
    (the running counts, persistable) gain this batch's positives and
    negatives, and AUC is the trapezoid area under the ROC curve their
    reversed running sums trace. The integer counts add exactly in any
    order; the area is summed in float64."""
    pred = single(ins, "Predict")
    label = single(ins, "Label").reshape(-1)
    tp_in, fp_in = single(ins, "TP"), single(ins, "FP")
    num_t = attrs.get("num_thresholds", 200)
    score = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    bucket = torch.clamp((score * num_t).to(torch.int32), 0, num_t - 1).long()
    pos = (label > 0).to(tp_in.dtype)
    tp = tp_in + torch.zeros_like(tp_in).index_add_(0, bucket, pos)
    fp = fp_in + torch.zeros_like(fp_in).index_add_(0, bucket, 1 - pos)
    tp_c = torch.flip(torch.cumsum(torch.flip(tp, (0,)), 0), (0,)).double()
    fp_c = torch.flip(torch.cumsum(torch.flip(fp, (0,)), 0), (0,)).double()
    tpr = tp_c / torch.clamp_min(tp_c[0], 1)
    fpr = fp_c / torch.clamp_min(fp_c[0], 1)
    auc = -torch.trapezoid(tpr, fpr)
    return {"AUC": [auc.float().reshape(1)], "TPOut": [tp], "FPOut": [fp]}


# ---------------------------------------------------------------- nce --

@register("nce", uses_rng=True)
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation: each row's true classes (Label) and
    num_neg_samples classes drawn uniformly from [0, num_total_classes)
    by the op's generator (SampleLabels), their logits x . W[c] + b[c]
    (SampleLogits), and Cost = the sum over those of the sigmoid cross
    entropy against 1 (true) or 0 (drawn). The draws are the port's own:
    they do not reproduce the JAX package's bits."""
    x, label = single(ins, "Input"), single(ins, "Label")
    w, b = single(ins, "Weight"), single(ins, "Bias")
    num_neg = attrs.get("num_neg_samples", 10)
    n = x.shape[0]
    label = label.reshape(n, -1).long()
    num_true = label.shape[1]
    neg = torch.empty((n, num_neg), dtype=torch.int64, device=x.device)
    if neg.device.type != "meta":
        neg.random_(0, attrs.get("num_total_classes"),
                    generator=ctx.rng(seed=attrs.get("seed", 0)))
    samples = torch.cat([label, neg], dim=1)          # [N, T + S]
    logits = torch.einsum("nd,nsd->ns", x, w[samples.reshape(-1)].reshape(
        n, -1, w.shape[1]))
    if b is not None:
        logits = logits + b.reshape(-1)[samples.reshape(-1)].reshape(n, -1)
    ones = torch.cat([torch.ones((n, num_true), device=x.device),
                      torch.zeros((n, num_neg), device=x.device)], dim=1)
    ce = torch.clamp_min(logits, 0) - logits * ones + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return {"Cost": [ce.sum(dim=1, keepdim=True)], "SampleLogits": [logits],
            "SampleLabels": [samples]}
