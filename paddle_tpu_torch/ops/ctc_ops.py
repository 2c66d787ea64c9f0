"""The CTC family: the warpctc loss, ctc_align (the greedy decoder's
merge), sequence_erase and edit_distance (the book's
evaluator.EditDistance runs the last two).

Parity: paddle/fluid/operators/{warpctc_op,ctc_align_op,edit_distance_op,
sequence_erase_op}.{h,cc,cu} and the JAX package's ops/ctc_ops.py. The
reference calls the warp-ctc library for the loss and walks sequences on
the host for the rest; here, as in the JAX package, each is a batched
computation over the padded-dense layout with no host read:
- warpctc: the log-space alpha recursion over the 2U+1 extended label
  states (blank, l1, blank, ..., lU, blank), one torch step per time step
  for the whole batch, rows past their length held by a mask; the softmax
  over the classes is part of the op (its input is unnormalized logits).
  Its gradient is autograd's through the loop, as the JAX package's is
  jax.vjp's through its lax.scan; the library's WarpCTCGrad output is
  zeros;
- ctc_align / sequence_erase: a keep-mask and a stable argsort move the
  kept tokens to the front of each row; the new lengths are the mask's
  sums;
- edit_distance: the Levenshtein table, one torch step per hypothesis
  position, the insertion recurrence closed into a cumulative min
  (d[i][j] = min_k<=j(cand[k] + j - k) = cummin(cand[k] - k) + j).
"""
import torch

from ..core.registry import register, single
from .crf_ops import squeeze_label

# the log of an impossible path: large and finite, as in the JAX package,
# so an infeasible alignment gives a large finite loss (F.ctc_loss gives
# inf) and the recursion never meets inf - inf
_NEG = -1e30


def take_along_axis(x, idx, dim):
    """jnp.take_along_axis's rule (faults C14, C15): an index in [-n, -1]
    wraps to index + n, and an index still outside [0, n) gives NaN (and
    no gradient). The gather itself reads an index clamped into range, so
    the card never meets a device-side assert and no host read is made.
    `x` is a float tensor; `idx` broadcasts as torch.gather takes it."""
    n = x.shape[dim]
    idx = torch.where(idx < 0, idx + n, idx)
    out = x.gather(dim, idx.clamp(0, n - 1))
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return torch.where((idx >= 0) & (idx < n), out, nan)


def _compact(x, keep, pad_value=0):
    """Move the kept tokens to the front of each row, pad the rest."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    out = x.gather(1, order)
    kept = keep.gather(1, order)
    new_len = keep.sum(1).to(torch.int32)
    return torch.where(kept, out, torch.full_like(out, pad_value)), new_len


def _shift(a, k):
    """a moved k states to the right along dim 1, _NEG shifted in."""
    pad = torch.full((a.shape[0], k), _NEG, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, :-k]], dim=1)


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) +
                         torch.exp(c - m))


@register("warpctc")
def _warpctc(ctx, ins, attrs):
    logits = single(ins, "Logits")                  # [B, T, C]
    label = squeeze_label(single(ins, "Label"))     # [B, U]
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)
    llen = single(ins, "LabelLen").reshape(-1).to(torch.int64)
    blank = int(attrs.get("blank", 0))
    norm_by_times = bool(attrs.get("norm_by_times", False))

    b, t_len, _ = logits.shape
    u = label.shape[1]
    s = 2 * u + 1
    dev = logits.device
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)

    # the extended labels: blank at the even states, the labels at the
    # odd ones (a label outside the classes reads NaN, a negative one
    # wraps, as jnp.take_along_axis does)
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label.to(torch.int64)
    # the skip s-2 -> s is allowed into a label state whose label differs
    # from the one before it; states past 2*llen never reach the final
    # selection (transitions only move forward), so padded labels are
    # harmless
    skip_ok = torch.zeros((b, s), dtype=torch.bool, device=dev)
    skip_ok[:, 3::2] = label[:, 1:] != label[:, :-1]
    lp_ext = take_along_axis(lp, ext[:, None, :].expand(b, t_len, s), 2)

    alpha = torch.cat([lp_ext[:, 0, :1],
                       torch.where(llen > 0, lp_ext[:, 0, 1], neg)[:, None],
                       neg.expand(b, s - 2)], dim=1) if s > 1 \
        else lp_ext[:, 0, :1]
    for t in range(1, t_len):
        skip = torch.where(skip_ok, _shift(alpha, 2), neg) if s > 2 \
            else neg.expand_as(alpha)
        diag = _shift(alpha, 1) if s > 1 else neg.expand_as(alpha)
        new = _logaddexp3(alpha, diag, skip) + lp_ext[:, t]
        alpha = torch.where((t < xlen)[:, None], new, alpha)

    # the end: state 2*llen (the trailing blank) or 2*llen-1 (the last
    # label); an end past the states reads NaN, a negative one wraps
    f_blank = take_along_axis(alpha, (2 * llen)[:, None], 1)[:, 0]
    last = (2 * llen - 1).clamp_min(0)[:, None]
    f_label = torch.where(llen > 0, take_along_axis(alpha, last, 1)[:, 0],
                          neg)
    m = torch.maximum(f_blank, f_label)
    loss = -(m + torch.log(torch.exp(f_blank - m) + torch.exp(f_label - m)))
    if norm_by_times:
        # the reference's WarpCTCGradKernel: the loss value stays raw and
        # only its gradient is divided by the number of time steps
        scaled = loss / xlen.clamp_min(1).to(loss.dtype)
        loss = loss.detach() - scaled.detach() + scaled
    return {"Loss": [loss[:, None].to(logits.dtype)],
            "WarpCTCGrad": [torch.zeros_like(logits)]}


@register("ctc_align")
def _ctc_align(ctx, ins, attrs):
    """Merge repeats (merge_repeated) and drop blanks, compacted to the
    front of each row; the new lengths in OutLen."""
    x = squeeze_label(single(ins, "Input"))          # [B, T]
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)
    blank = int(attrs.get("blank", 0))
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < \
        xlen[:, None]
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = (x != blank) & valid
    if attrs.get("merge_repeated", True):
        keep = keep & (x != prev)
    out, new_len = _compact(x, keep)
    return {"Output": [out], "OutLen": [new_len]}


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
    # d[hlen][rlen] by jnp.take_along_axis's rule: a length past the
    # table reads NaN, a negative one wraps
    d_h = take_along_axis(
        table, hlen[:, None, None].expand(b, 1, u2 + 1), 1)[:, 0]
    dist = take_along_axis(d_h, rlen[:, None], 1)[:, 0]
    if normalized:
        dist = dist / rlen.clamp_min(1).to(dist.dtype)
    seq_num = torch.full((1,), b, dtype=torch.int64, device=dev)
    return {"Out": [dist[:, None].to(torch.float32)],
            "SequenceNum": [seq_num]}
