"""The CTC family's sequence_erase and edit_distance (the book's
evaluator.EditDistance runs them).

Parity: paddle/fluid/operators/{edit_distance_op,sequence_erase_op}.
{h,cc,cu} and the JAX package's ops/ctc_ops.py. The reference walks
sequences on the host; here, as in the JAX package, each is a batched
computation over the padded-dense layout with no host read:
- sequence_erase: a keep-mask and a stable argsort move the kept tokens
  to the front of each row; the new lengths are the mask's sums;
- edit_distance: the Levenshtein table, one torch step per hypothesis
  position, the insertion recurrence closed into a cumulative min
  (d[i][j] = min_k<=j(cand[k] + j - k) = cummin(cand[k] - k) + j).
warpctc and ctc_align, with the OCR model that needs them, come in a
later slice (ROADMAP A6).
"""
import torch

from ..core.registry import register, single
from .crf_ops import squeeze_label


def _compact(x, keep, pad_value=0):
    """Move the kept tokens to the front of each row, pad the rest."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    out = x.gather(1, order)
    kept = keep.gather(1, order)
    new_len = keep.sum(1).to(torch.int32)
    return torch.where(kept, out, torch.full_like(out, pad_value)), new_len


@register("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    x = squeeze_label(single(ins, "X"))
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)
    tokens = list(attrs.get("tokens", []) or [])
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < \
        xlen[:, None]
    for tok in tokens:
        keep = keep & (x != int(tok))
    out, new_len = _compact(x, keep)
    return {"Out": [out], "OutLen": [new_len]}


@register("edit_distance")
def _edit_distance(ctx, ins, attrs):
    hyp = squeeze_label(single(ins, "Hyps"))   # [B, U1]
    ref = squeeze_label(single(ins, "Refs"))   # [B, U2]
    hlen = single(ins, "HypsLen").reshape(-1).to(torch.int64)
    rlen = single(ins, "RefsLen").reshape(-1).to(torch.int64)
    normalized = bool(attrs.get("normalized", True))
    b, u1 = hyp.shape
    u2 = ref.shape[1]
    dev = hyp.device

    jcol = torch.arange(u2 + 1, dtype=torch.float32, device=dev)[None, :]
    row = jcol.expand(b, u2 + 1)                    # d[0][j] = j
    rows = [row]
    for i in range(u1):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)     # [B, U2]
        # substitute / match (diagonal) against delete (above)
        cand = torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1.0)
        cand = torch.cat([row[:, :1] + 1.0, cand], dim=1)
        # insertions: row[j] = min_{k<=j}(cand[k] + j - k)
        row = (cand - jcol).cummin(dim=1).values + jcol
        rows.append(row)
    table = torch.stack(rows, dim=1)                # [B, U1+1, U2+1]
    d_h = table.gather(
        1, hlen.clamp(0, u1)[:, None, None].expand(b, 1, u2 + 1))[:, 0]
    dist = d_h.gather(1, rlen.clamp(0, u2)[:, None])[:, 0]
    if normalized:
        dist = dist / rlen.clamp_min(1).to(dist.dtype)
    seq_num = torch.full((1,), b, dtype=torch.int64, device=dev)
    return {"Out": [dist[:, None].to(torch.float32)],
            "SequenceNum": [seq_num]}
