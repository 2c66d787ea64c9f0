"""Sequence op rules over the padded-dense layout: sequence_pool (and its
first/last-step forms), sequence_softmax, sequence_mask, sequence_conv,
the dynamic LSTM and the LSTM with recurrent projection (LSTMP).

Parity: paddle/fluid/operators/{sequence_pool_op,sequence_softmax_op,
sequence_mask_op,sequence_conv_op,lstm_op,lstmp_op}.{cc,cu,h} and the JAX
package's ops/sequence_ops.py. A lod_level-1
tensor is a padded dense array X [num_seqs, max_len, *feature] plus XLen
int32 [num_seqs] of true lengths (core/lod.py), and every op masks by
XLen.

Four rules call hand-written CUDA kernels through their autograd
Functions (ops/cuda_kernels.py), on the same conditions under which the JAX
package dispatches its Pallas kernels, less its PADDLE_TPU_PALLAS switch,
which has no counterpart here:
  * sequence_pool SUM / AVERAGE / SQRT on fp32 -> MaskedPool (K9);
  * sequence_softmax on fp32 [B, T] (or [B, T, 1]) -> MaskedSoftmax (K8);
    other dtypes take the where-mask path;
  * lstm with no peepholes, fp32 and the default activations -> FusedLSTM
    (K6). Every other lstm (peepholes, other activations) runs the torch
    loop of cuda_kernels.fused_lstm_plain, as the JAX package runs its
    lax.scan: no kernel exists for it in either package;
  * lstmp on the same conditions (and the default proj_activation) ->
    FusedLSTMP (K7); every other lstmp runs the torch loop of
    cuda_kernels.fused_lstmp_plain.
The JAX package's gru rule waits for its path; a program that uses it
fails with the registry's unknown-op error.
"""
import numpy as np
import torch

from ..core.registry import register, single, torch_dtype
from . import cuda_kernels


def _feat_mask(x, xlen):
    """mask broadcastable over x's feature dims."""
    m = cuda_kernels.step_mask(xlen, x.shape[0], x.shape[1], x.device,
                               x.dtype)
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


@register("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = single(ins, "X")          # [B, T, ...]
    xlen = single(ins, "XLen")    # [B]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    if ptype in cuda_kernels.POOL_TYPES and x.dim() >= 2 \
            and x.dtype == torch.float32:
        # feature dims flatten to one trailing axis for the kernel
        b, t = x.shape[:2]
        feat = tuple(x.shape[2:])
        f = int(np.prod(feat)) if feat else 1
        out = cuda_kernels.MaskedPool.apply(x.reshape(b, t, f), xlen, ptype)
        return {"Out": [out.reshape((b,) + feat)]}
    m = _feat_mask(x, xlen)
    denom = xlen.to(x.dtype).clamp_min(1).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = (x * m).sum(dim=1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(dim=1) / denom
    elif ptype == "SQRT":
        out = (x * m).sum(dim=1) / torch.sqrt(denom)
    elif ptype == "MAX":
        # finfo.min, not -inf, where the mask is off: a row of length 0
        # stays finite
        neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                         device=x.device)
        out = torch.where(m > 0, x, neg).amax(dim=1)
    elif ptype == "LAST":
        # jnp.take_along_axis's fill rule, with no host sync: a length
        # above T gives a NaN row and no gradient (the index is clamped
        # for the gather, then the row replaced); an out-of-range gather
        # is a device-side assert on the card (fault C8)
        lens = xlen.long().reshape((-1,) + (1,) * (x.dim() - 2))
        idx = (lens - 1).clamp(0, x.shape[1] - 1).unsqueeze(1).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        out = torch.where(lens > x.shape[1],
                          torch.full((), float("nan"), dtype=x.dtype,
                                     device=x.device),
                          x.gather(1, idx).squeeze(1))
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return {"Out": [out]}


@register("sequence_last_step")
def _sequence_last_step(ctx, ins, attrs):
    return _sequence_pool(ctx, ins, dict(attrs, pooltype="LAST"))


@register("sequence_first_step")
def _sequence_first_step(ctx, ins, attrs):
    return _sequence_pool(ctx, ins, dict(attrs, pooltype="FIRST"))


@register("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    x = single(ins, "X")        # [B, T] or [B, T, 1]
    xlen = single(ins, "XLen")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    logits = x.reshape(x.shape[0], x.shape[1]) if squeeze else x
    if logits.dim() == 2 and logits.dtype == torch.float32:
        out = cuda_kernels.MaskedSoftmax.apply(logits, xlen)
    else:
        m = _feat_mask(logits, xlen)
        neg = torch.full((), -1e30, dtype=logits.dtype, device=x.device)
        out = torch.softmax(torch.where(m > 0, logits, neg), dim=1) * m
    return {"Out": [out.reshape(x.shape)]}


@register("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    """lengths [N] -> [N, maxlen] mask, maxlen from the int attr or from
    dim 1 of MaxLenRef. Parity: sequence_mask_op.h."""
    x = single(ins, "X")
    ref = single(ins, "MaxLenRef")
    maxlen = ref.shape[1] if ref is not None else int(attrs["maxlen"])
    mask = cuda_kernels.step_mask(x, x.shape[0], maxlen, x.device,
                                  torch.bool)
    return {"Y": [mask.to(torch_dtype(attrs.get("out_dtype", "int64")))]}


@register("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window conv over time (reference: sequence_conv_op).

    Filter [ctx_len * D, F]; the window starts at contextStart, and steps
    outside the row or past its length read zeros."""
    x = single(ins, "X")         # [B, T, D]
    w = single(ins, "Filter")    # [ctx_len*D, F]
    xlen = single(ins, "XLen")
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    t = x.shape[1]
    xm = x * _feat_mask(x, xlen)
    steps = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(xm, -off, dims=1)
        if off > 0:    # rolled forward: zero the tail
            valid = steps < (t - off)
        elif off < 0:  # rolled backward: zero the head
            valid = steps >= (-off)
        else:
            valid = torch.ones(t, dtype=torch.bool, device=x.device)
        cols.append(shifted * valid[None, :, None].to(x.dtype))
    ctx_mat = torch.cat(cols, dim=-1)               # [B, T, ctx_len*D]
    out = torch.einsum("btc,cf->btf", ctx_mat, w)
    return {"Out": [out * _feat_mask(out, xlen)]}


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


@register("lstm")
def _lstm(ctx, ins, attrs):
    """dynamic_lstm: input [B, T, 4D] (pre-projected by an fc), weight
    [D, 4D] recurrent, bias [1, 4D] (+[1, 3D] peepholes if use_peepholes).

    Gate order (reference lstm_op.cc:125 {W_ch, W_ih, W_fh, W_oh}):
    candidate, input, forget, output. BatchGate and BatchCellPreAct are the
    input and the cell, as in the JAX rule: nothing reads them, so no
    gradient flows through those aliases."""
    x = single(ins, "Input")       # [B, T, 4D]
    w = single(ins, "Weight")      # [D, 4D]
    bias = single(ins, "Bias")     # [1, 4D(+3D)]
    h0 = single(ins, "H0")
    c0 = single(ins, "C0")
    xlen = single(ins, "XLen")
    d = w.shape[0]
    b, t, _ = x.shape
    use_peep = attrs.get("use_peepholes", False)
    gate_name = attrs.get("gate_activation", "sigmoid")
    cell_name = attrs.get("cell_activation", "tanh")
    cand_name = attrs.get("candidate_activation", "tanh")
    is_rev = attrs.get("is_reverse", False)

    if (not use_peep and x.dtype == torch.float32 and gate_name == "sigmoid"
            and cell_name == "tanh" and cand_name == "tanh"):
        hidden, cell = cuda_kernels.FusedLSTM.apply(
            x, w, bias.reshape(-1)[:4 * d], h0, c0, xlen, is_rev)
        return {"Hidden": [hidden], "Cell": [cell],
                "BatchGate": [x], "BatchCellPreAct": [cell]}
    if x.device.type == "meta":
        # build-time shape inference: skip the T-step loop
        out = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
        return {"Hidden": [out], "Cell": [out], "BatchGate": [x],
                "BatchCellPreAct": [out]}

    # lstm_op.h: act_cand maps the candidate gate, act_cell maps the cell
    # state on its way into the hidden output (h = o * act_cell(c))
    state_dt = torch.float32 if x.dtype in (torch.float32, torch.bfloat16) \
        else x.dtype
    bias = bias.reshape(-1)
    hidden, cell = cuda_kernels.fused_lstm_plain(
        x, w, bias[:4 * d], h0, c0, xlen, is_rev,
        peepholes=bias[4 * d:7 * d] if use_peep else None,
        acts=(_ACTS[gate_name], _ACTS[cell_name], _ACTS[cand_name]),
        dtype=state_dt)
    hidden, cell = hidden.to(x.dtype), cell.to(x.dtype)
    return {"Hidden": [hidden], "Cell": [cell],
            "BatchGate": [x], "BatchCellPreAct": [cell]}


@register("lstmp")
def _lstmp(ctx, ins, attrs):
    """lstmp_op.cc — LSTM with recurrent projection: the [B, P] PROJECTED
    state (not the [B, D] hidden) feeds the next step's gate product
    (lstmp_op.h:161-167), so Weight is [P, 4D] and ProjWeight [D, P];
    r_t = proj_act(h_t @ ProjWeight). H0 [B, D] enters through the same
    projection (lstmp_op.h:174-187), computed here in torch so that its
    gradient flows through autograd. As in the JAX rule, proj_act is
    applied where the reference applies cell_act to the projection
    (lstmp_op.h:201-203, an evident typo: both default to tanh).
    BatchGate, BatchCellPreAct and BatchHidden alias the input and the
    cell, as in the JAX rule."""
    x = single(ins, "Input")            # [B, T, 4D]
    w = single(ins, "Weight")           # [P, 4D]
    w_proj = single(ins, "ProjWeight")  # [D, P]
    bias = single(ins, "Bias")          # [1, 4D(+3D)]
    h0 = single(ins, "H0")
    c0 = single(ins, "C0")
    xlen = single(ins, "XLen")
    d, p = w_proj.shape
    b, t, _ = x.shape
    use_peep = attrs.get("use_peepholes", False)
    gate_name = attrs.get("gate_activation", "sigmoid")
    cell_name = attrs.get("cell_activation", "tanh")
    cand_name = attrs.get("candidate_activation", "tanh")
    proj_name = attrs.get("proj_activation", "tanh")
    is_rev = attrs.get("is_reverse", False)

    if (not use_peep and x.dtype == torch.float32 and gate_name == "sigmoid"
            and cell_name == "tanh" and cand_name == "tanh"
            and proj_name == "tanh"):
        r0 = None if h0 is None else torch.tanh(h0.float() @ w_proj.float())
        proj, cell = cuda_kernels.FusedLSTMP.apply(
            x, w, w_proj, bias.reshape(-1)[:4 * d], r0, c0, xlen, is_rev)
        if r0 is None:
            r0 = torch.zeros((b, p), dtype=torch.float32, device=x.device)
        return {"Projection": [proj], "Cell": [cell],
                "BatchGate": [x], "BatchCellPreAct": [cell],
                "BatchHidden": [cell], "OrderedP0": [r0.to(x.dtype)]}
    state_dt = torch.float32 if x.dtype in (torch.float32, torch.bfloat16) \
        else x.dtype
    proj_act = _ACTS[proj_name]
    r0 = torch.zeros((b, p), dtype=state_dt, device=x.device) \
        if h0 is None else proj_act(h0.to(state_dt) @ w_proj.to(state_dt))
    if x.device.type == "meta":
        # build-time shape inference: skip the T-step loop
        proj = torch.empty((b, t, p), dtype=x.dtype, device=x.device)
        cell = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
        return {"Projection": [proj], "Cell": [cell], "BatchGate": [x],
                "BatchCellPreAct": [cell], "BatchHidden": [cell],
                "OrderedP0": [r0]}
    bias = bias.reshape(-1)
    proj, cell = cuda_kernels.fused_lstmp_plain(
        x, w, w_proj, bias[:4 * d], r0, c0, xlen, is_rev,
        peepholes=bias[4 * d:7 * d] if use_peep else None,
        acts=(_ACTS[gate_name], _ACTS[cell_name], _ACTS[cand_name],
              proj_act),
        dtype=state_dt)
    proj, cell = proj.to(x.dtype), cell.to(x.dtype)
    return {"Projection": [proj], "Cell": [cell],
            "BatchGate": [x], "BatchCellPreAct": [cell],
            "BatchHidden": [cell], "OrderedP0": [r0]}
