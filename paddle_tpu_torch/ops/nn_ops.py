"""NN op rules (the subset the Transformer's and the sentiment
classifiers' programs run): layer_norm, fused_attention, lookup_table,
softmax_with_cross_entropy, softmax, cross_entropy, accuracy.

Parity: paddle/fluid/operators/{layer_norm_op,lookup_table_op,
softmax_with_cross_entropy_op,softmax_op,cross_entropy_op,accuracy_op}.cc
and the JAX package's ops/nn_ops.py.
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
from .kernel_config import flash_at

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
    the JAX package reads and this rule ignores."""
    q = single(ins, "Q")
    k = single(ins, "K")
    v = single(ins, "V")
    kv_len = single(ins, "KVLen") if ins.get("KVLen") else None
    if kv_len is not None:
        kv_len = kv_len.reshape(-1)
    causal = attrs.get("causal", False)
    scale = attrs.get("scale", None)
    if not flash_at(q.shape[1], q.device.type, k.shape[1]):
        return _out(attention_reference(q, k, v, causal=causal, scale=scale,
                                        kv_len=kv_len).to(q.dtype))
    return _out(cuda_kernels.FlashAttention.apply(q, k, v, kv_len, causal,
                                                  scale))


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
