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
The rest of the JAX file's rules (sequence_expand, sequence_reshape,
lod_reset, row_conv, gru, gru_unit, lstm_unit, sequence_cache_write)
are plain torch: the JAX package has no kernel for them either. Their
recurrence, gru, is a torch loop over T, as the JAX rule's lax.scan; its
gradient comes from autograd through the loop. sequence_reshape and
lod_reset keep static output shapes and assert their preconditions
in-graph (LowerCtx.add_error): no rule reads a tensor's value on the
host, so a step holding them stays capturable by a CUDA graph.
"""
import math

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


@register("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """Repack row data to width new_dim (reference: sequence_reshape_op.cc).

    Padded-dense: each row's valid data is a contiguous prefix of the
    flattened [T*D] row, so reshaping to [T*D/new_dim, new_dim] keeps it a
    contiguous prefix; only the lengths rescale (exact integer math). T is
    zero-padded up when T*D doesn't divide new_dim (bucketed padding). A
    sequence whose len*D new_dim does not divide trips an in-graph
    assertion (the reference op enforces it; a floor would drop its
    tail)."""
    x = single(ins, "X")        # [B, T, D]
    xlen = single(ins, "XLen")  # [B]
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape
    # smallest pad with (t+pad)*d % new_dim == 0: t+pad = 0 (mod nd/gcd)
    m = new_dim // math.gcd(d, new_dim)
    pad_t = (-t) % m
    if pad_t:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_t))
        t += pad_t
    out = x.reshape(b, (t * d) // new_dim, new_dim)
    elems = xlen.to(torch.int32) * d
    ctx.add_error(
        "sequence_reshape: a sequence's len*dim (%d per step) is not "
        "divisible by new_dim=%d; its tail would be dropped" % (d, new_dim),
        (elems % new_dim != 0).any())
    return {"Out": [out], "OutLen": [elems // new_dim]}


@register("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Expand each row of X to match Y's sequence lengths.

    Padded-layout semantics: X [B, 1-or-T, ...] or [B, ...]; the output
    repeats X's per-sequence row across Y's max_len steps (masked)."""
    x = single(ins, "X")
    y = single(ins, "Y")
    ylen = single(ins, "YLen")
    t = y.shape[1]
    head = x[:, 0] if x.dim() == y.dim() else x
    rep = head[:, None].expand((x.shape[0], t) + tuple(head.shape[1:]))
    return {"Out": [rep * _feat_mask(rep, ylen)]}


def _device_ints(values, device):
    """A 1-d int32 tensor of `values` built on `device` by fills, not by a
    host copy (a copy from host memory cannot be captured into a CUDA
    graph)."""
    out = torch.zeros(len(values), dtype=torch.int32, device=device)
    for i, v in enumerate(values):
        if v:
            out[i] = int(v)
    return out


@register("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """lod_reset_op.cc: keep the flat data stream, replace the segmentation.

    The padded-dense layout repacks rows: X's valid rows are scattered
    into one contiguous stream (by the old exclusive prefix sums), then
    gathered per the new lengths. New lengths come from attr target_lens
    (static), YLen (Y's own LoD), or YData (Y.data holding offsets). The
    output's shape comes from static shapes only: [len(target_lens),
    max(target_lens)], Y's [B, T], or [number of offsets - 1, the stream's
    capacity]. A target whose lengths do not sum to the stream's length,
    or a negative length, trips an in-graph assertion (the reference
    enforces both)."""
    x = single(ins, "X")
    xlen = single(ins, "XLen")
    ylen = single(ins, "YLen")
    ydata = single(ins, "YData")
    y = single(ins, "Y")
    t_lens = attrs.get("target_lens") or []
    if ylen is None and ydata is None and not t_lens:
        # no target: pass through unchanged (as the JAX rule tolerates
        # for metadata-only program clones)
        return {"Out": [x]} if xlen is None else \
            {"Out": [x], "OutLen": [xlen]}
    dev = x.device
    # 1. flatten valid rows into one contiguous stream
    if xlen is not None:
        b, t = x.shape[:2]
        feat = tuple(x.shape[2:])
        cap = b * t
        xl = xlen.reshape(-1).to(torch.int64)
        cum = torch.cumsum(xl, 0) - xl                  # exclusive prefix
        steps = torch.arange(t, device=dev)
        pos = cum[:, None] + steps[None, :]
        valid = steps[None, :] < xl[:, None]
        pos = torch.where(valid, pos, torch.full_like(pos, cap))  # park pads
        flat = torch.zeros((cap + 1,) + feat, dtype=x.dtype,
                           device=dev).index_put(
            (pos.reshape(-1),), x.reshape((cap,) + feat))[:cap]
        total = xl.sum()
    else:                       # dense X: its rows are the stream
        feat = tuple(x.shape[1:])
        flat = x
        cap = x.shape[0]
        total = torch.full((), cap, dtype=torch.int64, device=dev)
    # 2. the new segmentation
    if ylen is not None:
        newlen = ylen.reshape(-1).to(torch.int32)
        b2 = y.shape[0] if y is not None else newlen.shape[0]
        t2 = y.shape[1] if y is not None and y.dim() > 1 else cap
    elif ydata is not None:
        off = ydata.reshape(-1).to(torch.int32)
        newlen = off[1:] - off[:-1]
        b2, t2 = newlen.shape[0], cap
    else:
        lens = [int(v) for v in t_lens]
        newlen = _device_ints(lens, dev)
        b2, t2 = len(lens), max(lens)
    nl = newlen.to(torch.int64)
    ctx.add_error(
        "lod_reset: target segmentation length sum != data stream length",
        (nl.sum() != total) | (nl < 0).any())
    cum2 = torch.cumsum(nl, 0) - nl
    steps2 = torch.arange(t2, device=dev)
    idx = cum2[:, None] + steps2[None, :]
    valid2 = steps2[None, :] < nl[:, None]
    out = flat[idx.clamp(0, cap - 1).reshape(-1)].reshape((b2, t2) + feat)
    out = torch.where(valid2.reshape((b2, t2) + (1,) * len(feat)), out,
                      torch.zeros((), dtype=x.dtype, device=dev))
    return {"Out": [out], "OutLen": [newlen]}


@register("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (reference: row_conv_op, DeepSpeech2)."""
    x = single(ins, "X")        # [B, T, D]
    w = single(ins, "Filter")   # [future_ctx, D]
    xlen = single(ins, "XLen")
    t = x.shape[1]
    mask = _feat_mask(x, xlen)
    xm = x * mask
    steps = torch.arange(t, device=x.device)
    out = torch.zeros_like(x)
    for k in range(w.shape[0]):
        shifted = torch.roll(xm, -k, dims=1)
        valid = (steps < (t - k)).to(x.dtype)
        out = out + shifted * valid[None, :, None] * w[k][None, None, :]
    return {"Out": [out * mask]}


def _amp_recurrence(ctx, x_dtype):
    """The JAX rule's mixed-precision discipline for a recurrence: under
    AMP (or a bf16 input) the step's recurrent product takes bf16
    operands, while the carried state stays f32. Returns (state dtype,
    rmat(h, w))."""
    bf = getattr(ctx, "amp", False) or x_dtype == torch.bfloat16
    state_dt = torch.float32 if x_dtype in (torch.float32, torch.bfloat16) \
        else x_dtype

    def rmat(h, wm):
        if bf:
            return (h.to(torch.bfloat16) @ wm.to(torch.bfloat16)).float()
        return h @ wm.to(state_dt)

    return state_dt, rmat


@register("gru")
def _gru(ctx, ins, attrs):
    """dynamic_gru: input [B, T, 3D] pre-projected, weight packed
    [D, 3D] = [update|reset (2D) ; candidate (D)] as in gru_op.cc. A torch
    loop over T (the JAX rule's lax.scan); past a row's length the state
    is carried unchanged."""
    x = single(ins, "Input")     # [B, T, 3D]
    w = single(ins, "Weight")    # [D, 3D]
    bias = single(ins, "Bias")   # [1, 3D]
    h0 = single(ins, "H0")
    xlen = single(ins, "XLen")
    d = w.shape[0]
    b, t, _ = x.shape
    if x.device.type == "meta":
        # build-time shape inference: skip the T-step loop
        hidden = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
        return {"Hidden": [hidden], "BatchGate": [x],
                "BatchResetHiddenPrev": [hidden], "BatchHidden": [hidden]}
    gact = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cact = _ACTS[attrs.get("activation", "tanh")]
    is_rev = attrs.get("is_reverse", False)
    state_dt, rmat = _amp_recurrence(ctx, x.dtype)
    w_g = w[:, :2 * d]      # update + reset recurrent weights
    w_c = w[:, 2 * d:]      # candidate recurrent weights
    bias = bias.reshape(-1).to(state_dt) if bias is not None \
        else torch.zeros(3 * d, dtype=state_dt, device=x.device)
    h = h0.to(state_dt) if h0 is not None \
        else torch.zeros((b, d), dtype=state_dt, device=x.device)
    m = cuda_kernels.step_mask(xlen, b, t, x.device, state_dt)
    xs = x.to(state_dt).unbind(1)
    order = range(t - 1, -1, -1) if is_rev else range(t)
    hs = [None] * t
    for k in order:
        xt, mt = xs[k], m[:, k:k + 1]
        xu = xt[:, :2 * d] + rmat(h, w_g) + bias[:2 * d]
        u, r = gact(xu).chunk(2, dim=-1)
        c = cact(xt[:, 2 * d:] + rmat(r * h, w_c) + bias[2 * d:])
        # the reference's convention (gru_kernel.h): the update gate
        # weights the CANDIDATE, not the carried state
        h_new = u * c + (1 - u) * h
        h = mt * h_new + (1 - mt) * h
        hs[k] = h
    hidden = torch.stack(hs, dim=1).to(x.dtype)
    return {"Hidden": [hidden], "BatchGate": [x],
            "BatchResetHiddenPrev": [hidden], "BatchHidden": [hidden]}


_UNIT_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _unit_act(value, default):
    """gru_unit's activation attr: the reference's int code or a name."""
    if isinstance(value, int):
        return _ACTS[_UNIT_ACTS.get(value, default)]
    return _ACTS[value]


@register("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """Single GRU step (reference: gru_unit_op), used inside DynamicRNN."""
    x = single(ins, "Input")        # [B, 3D]
    h_prev = single(ins, "HiddenPrev")
    w = single(ins, "Weight")       # [D, 3D]
    bias = single(ins, "Bias")
    d = w.shape[0]
    gact = _unit_act(attrs.get("gate_activation", 1), "sigmoid")
    cact = _unit_act(attrs.get("activation", 2), "tanh")
    if bias is not None:
        x = x + bias.reshape(-1)
    xu = x[:, :2 * d] + h_prev @ w[:, :2 * d]
    u, r = gact(xu).chunk(2, dim=-1)
    c = cact(x[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
    h = u * c + (1 - u) * h_prev   # gru_unit_op: u weights the candidate
    return {"Hidden": [h], "Gate": [xu], "ResetHiddenPrev": [r * h_prev]}


@register("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """Single LSTM step (reference: lstm_unit_op): X [B, 4D] pre-gates,
    packed i, f, o, j (the candidate LAST, unlike lstm_op's
    candidate-first order)."""
    x = single(ins, "X")
    c_prev = single(ins, "C_prev")
    forget_bias = attrs.get("forget_bias", 0.0)
    gi, gf, go, gj = x.chunk(4, dim=-1)
    c = torch.sigmoid(gf + forget_bias) * c_prev + \
        torch.sigmoid(gi) * torch.tanh(gj)
    h = torch.sigmoid(go) * torch.tanh(c)
    return {"C": [c], "H": [h]}


@register("sequence_cache_write")
def _sequence_cache_write(ctx, ins, attrs):
    """Per-row timestep write into a [B, T, ...] cache: Out[b, Pos[b]] =
    X[b], every other cell Cache's. A negative Pos counts from the end
    and a Pos outside [-T, T) writes nothing, as the JAX rule's scatter
    drops it; here the write is clamped and then masked, so no index
    leaves the cache on the card."""
    cache = single(ins, "Cache")                      # [B, T, ...]
    x = single(ins, "X")                              # [B, ...]
    pos = single(ins, "Pos").reshape(-1).to(torch.int64)   # [B]
    b, t = cache.shape[:2]
    pos = torch.where(pos < 0, pos + t, pos)
    ok = (pos >= 0) & (pos < t)
    rows = torch.arange(b, device=cache.device)
    idx = pos.clamp(0, t - 1)
    keep = ok.reshape((-1,) + (1,) * (cache.dim() - 2))
    val = torch.where(keep, x.to(cache.dtype), cache[rows, idx])
    return {"Out": [cache.index_put((rows, idx), val)]}
