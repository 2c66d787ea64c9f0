"""The sequence tail of the JAX package's ops/tail_ops.py: sequence_slice
and sequence_concat over the padded-dense layout (X [B, T, ...] + XLen
[B]). The rest of that file (prelu, pad, crop, roi_pool, the pools with
index, the norms and losses, precision_recall, ...) comes with ROADMAP
A11.

Parity: paddle/fluid/operators/{sequence_slice_op,sequence_concat_op}.cc.
Both keep static output shapes: a crop keeps T, a concatenation takes
the sum of its inputs' T; the new lengths ride in OutLen.
"""
import torch

from ..core.registry import register, single


@register("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """sequence_slice_op.cc: per-sequence crop [offset, offset+length) in
    the padded layout, a per-row gather with masking; the output keeps the
    static T and carries the new lengths in OutLen."""
    x = single(ins, "X")            # [B, T, ...]
    offset = single(ins, "Offset").reshape(-1).to(torch.int64)  # [B]
    length = single(ins, "Length").reshape(-1).to(torch.int32)  # [B]
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]             # [1, T]
    src = (pos + offset[:, None]).clamp(0, t - 1)               # [B, T]
    tail = (1,) * (x.dim() - 2)
    gathered = x.gather(1, src.reshape(src.shape + tail).expand(x.shape))
    keep = (pos < length[:, None]).reshape(tuple(x.shape[:2]) + tail)
    return {"Out": [torch.where(keep, gathered,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))],
            "OutLen": [length]}


@register("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """sequence_concat_op.cc: axis=0 concatenates along time per sequence
    (out seq b = x0[b][:len0] ++ x1[b][:len1] ++ ...); other axes are a
    plain feature concat. A gather: for each output step, the input that
    owns it from the row's cumulative-length table."""
    xs = ins["X"]                   # list of [B, Ti, F...]
    lens = ins["XLen"]              # list of [B]
    axis = attrs.get("axis", 0)
    if axis != 0:
        return {"Out": [torch.cat(xs, dim=axis)],
                "OutLen": [lens[0].to(torch.int32)]}
    dev = xs[0].device
    b = xs[0].shape[0]
    tmax = max(x.shape[1] for x in xs)
    feat = tuple(xs[0].shape[2:])
    stack = torch.stack(
        [torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (0, tmax - x.shape[1]))
         for x in xs], 0)                                   # [N, B, Tmax, F]
    ln = torch.stack([v.reshape(-1).to(torch.int64) for v in lens], 0)
    cum = torch.cat([torch.zeros((1, b), dtype=torch.int64, device=dev),
                     torch.cumsum(ln, 0)], 0)               # [N+1, B]
    ttot = sum(x.shape[1] for x in xs)
    t = torch.arange(ttot, device=dev)                      # [Ttot]
    # seg[b, t] = index of the input owning output step t of row b
    seg = (t[None, :, None] >= cum.T[:, None, 1:]).sum(-1)  # [B, Ttot]
    seg = seg.clamp(0, len(xs) - 1)
    start = cum.T.gather(1, seg)                            # [B, Ttot]
    local = (t[None, :] - start).clamp(0, tmax - 1)
    rows = torch.arange(b, device=dev)[:, None]
    flat_idx = (seg * b + rows) * tmax + local              # [B, Ttot]
    flat = stack.reshape((len(xs) * b * tmax,) + feat)
    out = flat[flat_idx.reshape(-1)].reshape((b, ttot) + feat)
    total = cum[-1]                                         # [B]
    keep = (t[None, :] < total[:, None]).reshape((b, ttot) + (1,) * len(feat))
    return {"Out": [torch.where(keep, out,
                                torch.zeros((), dtype=out.dtype,
                                            device=dev))],
            "OutLen": [total.to(torch.int32)]}
