"""Linear-chain CRF ops: forward NLL, Viterbi decode, chunk evaluation.

Parity: paddle/fluid/operators/{linear_chain_crf_op,crf_decoding_op,
chunk_eval_op}.h and the JAX package's ops/crf_ops.py. The reference walks
each sequence on the host with nested per-tag loops; the JAX package runs
one batched lax.scan over the padded-dense layout ([B, T, D] + XLen);
here each recurrence is a torch loop over T for the whole batch, with no
host read, so a step holding them stays capturable by a CUDA graph. The
gradient of the forward NLL comes from autograd through the loop, as the
JAX package's comes from jax.vjp (the reference hand-writes it). No
kernel of the port runs here: the JAX package has none for these ops.

Transition layout (linear_chain_crf_op.h:150-162): Transition is
[D+2, D]; row 0 = start weights, row 1 = end weights, rows 2.. =
w[2+j, i] = score of tag j -> tag i. LogLikelihood is the per-sequence
negative log likelihood [num_seqs, 1], computed in log space.
"""
import torch

from ..core.registry import register, single


def squeeze_label(label):
    """[B, T, 1] int label tensor -> [B, T] int64 (the JAX package's
    registry.squeeze_label, which narrows to int32 with x64 off)."""
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label.reshape(label.shape[0], label.shape[1])
    return label.to(torch.int64)


def _split_transition(w):
    return w[0], w[1], w[2:]  # start [D], end [D], trans [D, D] (j -> i)


def _valid(xlen, t):
    return torch.arange(t, device=xlen.device)[None, :] < xlen[:, None]


@register("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    x = single(ins, "Emission")       # [B, T, D]
    w = single(ins, "Transition")     # [D+2, D]
    label = squeeze_label(single(ins, "Label"))           # [B, T]
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)  # [B]
    b, t, d = x.shape
    start, end, trans = _split_transition(w)
    tmask = _valid(xlen, t)

    # log partition, by the forward algorithm
    alpha = start[None, :] + x[:, 0]                        # [B, D]
    for k in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + x[:, k]
        alpha = torch.where(tmask[:, k:k + 1], nxt, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)   # [B]

    # the gold path's score
    emit = x.gather(2, label[:, :, None])[:, :, 0]
    emit_score = (emit * tmask).sum(1)
    if t > 1:
        tr = trans[label[:, :-1], label[:, 1:]]
        trans_score = (tr * tmask[:, 1:]).sum(1)
    else:
        trans_score = torch.zeros((b,), dtype=x.dtype, device=x.device)
    last = (xlen - 1).clamp_min(0).clamp_max(t - 1)
    last_label = label.gather(1, last[:, None])[:, 0]
    score = start[label[:, 0]] + emit_score + trans_score + end[last_label]

    nll = torch.where(xlen > 0, log_z - score,
                      torch.zeros((), dtype=log_z.dtype, device=x.device))
    return {"LogLikelihood": [nll[:, None].to(x.dtype)]}


@register("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """Viterbi over the batch, then the backtrack from each row's true last
    step, both loops over T on the device: the lengths select by `where`,
    never by a host branch. With Label: the 0/1 match of the path."""
    x = single(ins, "Emission")      # [B, T, D]
    w = single(ins, "Transition")    # [D+2, D]
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)
    label = ins.get("Label")
    b, t, d = x.shape
    start, end, trans = _split_transition(w)
    tmask = _valid(xlen, t)

    # forward: alpha[b, i] = the best score ending at tag i; tracks hold
    # the argmax predecessor (the first of equal maxima, as jnp.argmax)
    alpha = start[None, :] + x[:, 0]
    tracks = []
    for k in range(1, t):
        scores = alpha[:, :, None] + trans[None]            # [B, j, i]
        best = scores.amax(dim=1) + x[:, k]
        tracks.append(scores.argmax(dim=1))
        alpha = torch.where(tmask[:, k:k + 1], best, alpha)
    best_last = (alpha + end[None, :]).argmax(dim=1)        # [B]

    # backtrack from each sequence's true last position: walking k = T-2
    # .. 0, at k+1 == len-1 the path restarts from best_last, within the
    # sequence it follows the tracked argmax, past it it is 0
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    cur = torch.where(xlen - 1 == t - 1, best_last, zero)
    path = [None] * t
    for k in range(t - 2, -1, -1):
        nxt = torch.where((k + 1) == xlen - 1, best_last, cur)
        prev = tracks[k].gather(1, nxt[:, None])[:, 0]
        cur = torch.where((k + 1) <= xlen - 1, prev, zero)
        path[k] = cur
    path[t - 1] = zero.expand(b)
    path = torch.stack(path, dim=1)                         # [B, T]
    steps = torch.arange(t, device=x.device)[None, :]
    path = torch.where(steps == (xlen - 1)[:, None], best_last[:, None],
                       path)
    path = torch.where(tmask, path, zero)
    if label:
        lbl = squeeze_label(label[0])
        path = torch.where(tmask, (lbl == path).to(torch.int64), zero)
    return {"ViterbiPath": [path]}


# ---------------------------------------------------------------------------
# chunk_eval (chunk_eval_op.h GetSegments/ChunkBegin/ChunkEnd, vectorized)
# ---------------------------------------------------------------------------

_SCHEMES = {
    # scheme: (num_tag_types, begin, inside, end, single); -1 = absent
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_flags(label, valid, num_chunk_types, scheme):
    """begin[i], next_end[i] and the chunk type per position, vectorized.

    The reference's stateful walk satisfies in_chunk[i] == (type[i] !=
    other) for every label sequence, which makes ChunkBegin / ChunkEnd pure
    functions of consecutive (tag, type) pairs (the JAX rule's
    derivation)."""
    num_tag, tag_b, tag_i, tag_e, tag_s = _SCHEMES[scheme]
    other = num_chunk_types
    tag = label % num_tag
    typ = torch.where(valid, label // num_tag,
                      torch.full_like(label, other))
    b, t = label.shape

    def shift_right(v, fill):
        return torch.cat([torch.full((b, 1), fill, dtype=v.dtype,
                                     device=v.device), v[:, :-1]], dim=1)

    def shift_left(v, fill):
        return torch.cat([v[:, 1:], torch.full((b, 1), fill, dtype=v.dtype,
                                               device=v.device)], dim=1)

    def chunk_begin(ptag, ptyp, tag, typ):
        res = torch.where(
            ptyp == other, typ != other,
            torch.where(
                typ == other, torch.zeros_like(typ, dtype=torch.bool),
                torch.where(
                    typ != ptyp, torch.ones_like(typ, dtype=torch.bool),
                    (tag == tag_b) | (tag == tag_s) |
                    (((tag == tag_i) | (tag == tag_e)) &
                     ((ptag == tag_e) | (ptag == tag_s))))))
        return res & (typ != other)

    def chunk_end(ptag, ptyp, tag, typ):
        # "does a chunk open at i-1 close before i": the reference ChunkEnd
        false = torch.zeros_like(typ, dtype=torch.bool)
        true = torch.ones_like(typ, dtype=torch.bool)
        return torch.where(
            ptyp == other, false,
            torch.where(
                typ == other, true,
                torch.where(
                    typ != ptyp, true,
                    torch.where(
                        (ptag == tag_b) | (ptag == tag_i),
                        (tag == tag_b) | (tag == tag_s),
                        (ptag == tag_e) | (ptag == tag_s)))))

    begin = chunk_begin(shift_right(tag, -1), shift_right(typ, other),
                        tag, typ) & valid
    # end_at[i]: position i is the last token of a chunk
    end_at = (typ != other) & chunk_end(
        tag, typ, shift_left(tag, -1), shift_left(typ, other)) & valid
    # next_end[i] = the first j >= i with end_at[j] (reverse cumulative min)
    idx = torch.arange(t, device=label.device)[None, :].expand(b, t)
    cand = torch.where(end_at, idx, torch.full_like(idx, t + 1))
    next_end = cand.flip(1).cummin(dim=1).values.flip(1)
    return begin, next_end, typ


@register("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    inference = squeeze_label(single(ins, "Inference"))  # [B, T]
    label = squeeze_label(single(ins, "Label"))
    xlen = single(ins, "XLen").reshape(-1).to(torch.int64)
    num_chunk_types = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = list(attrs.get("excluded_chunk_types", []) or [])
    valid = _valid(xlen, label.shape[1])

    beg_l, end_l, typ_l = _chunk_flags(label, valid, num_chunk_types, scheme)
    beg_i, end_i, typ_i = _chunk_flags(inference, valid, num_chunk_types,
                                       scheme)

    def included(typ):
        inc = torch.ones(typ.shape, dtype=torch.bool, device=typ.device)
        for e in excluded:
            inc = inc & (typ != e)
        return inc

    n_label = (beg_l & included(typ_l)).sum()
    n_infer = (beg_i & included(typ_i)).sum()
    n_correct = (beg_l & beg_i & (typ_l == typ_i) & (end_l == end_i) &
                 included(typ_l)).sum()

    nc = n_correct.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=nc.device)
    precision = torch.where(n_infer > 0, nc / n_infer.clamp_min(1), zero)
    recall = torch.where(n_label > 0, nc / n_label.clamp_min(1), zero)
    f1 = torch.where(n_correct > 0, 2 * precision * recall /
                     (precision + recall).clamp_min(1e-30), zero)
    return {"Precision": [precision.reshape(1)],
            "Recall": [recall.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [n_infer.reshape(1)],
            "NumLabelChunks": [n_label.reshape(1)],
            "NumCorrectChunks": [n_correct.reshape(1)]}
