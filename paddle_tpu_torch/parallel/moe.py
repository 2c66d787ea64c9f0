"""Expert parallelism (the `ep` mesh axis): a top-1 mixture-of-experts FFN.

Parity: the JAX package's parallel/moe.py (the Switch / GShard design:
top-1 gating over f32 softmax probabilities, a fixed expert capacity, the
GShard load-balance loss). There the dispatch and combine are dense
one-hot einsums over [N, E, C] and GSPMD turns them into the all-to-all
over the 'ep' axis. Here they are index gathers: a token's slot is
(expert, position in the expert's queue), the [E, C, D] expert input is
one `index_select` of the token rows and the output one gather of the
slots, each a gather whose backward is the gather of its inverse map (no
row takes two contributions). A one-hot product adds exact zeros to its
one nonzero term, so the fp32 values are the einsums' own; the [N, E, C]
tensors (335 MB a layer at N = 8192, E = 8, C = 1280 in fp32) are never
made.

With `ep` > 1 the expert products run in `ep` groups of E / ep experts,
one group a replica of the axis, as the JAX rule's sharding constraint
splits the [E, C, D] work; on replicas that share a device the groups run
one after the other.
"""
import math

import numpy as np
import torch

from .mesh import P

__all__ = ["init_moe_params", "moe_layer", "moe_param_specs",
           "dense_reference"]

_NAMES = ("gate", "w1", "b1", "w2", "b2")


def init_moe_params(rng, d_model, d_hidden, num_experts, dtype="float32",
                    device="cpu"):
    """params = {gate [D,E], w1 [E,D,H], b1 [E,H], w2 [E,H,D], b2 [E,D]},
    drawn from the numpy RandomState `rng` in the JAX package's order (the
    same numbers for the same state)."""
    k = [rng.randn(d_model, num_experts) * 0.02,
         rng.randn(num_experts, d_model, d_hidden) * (d_model ** -0.5),
         np.zeros((num_experts, d_hidden)),
         rng.randn(num_experts, d_hidden, d_model) * (d_hidden ** -0.5),
         np.zeros((num_experts, d_model))]
    dt = getattr(torch, np.dtype(dtype).name)
    return {n: torch.as_tensor(np.asarray(a, dtype), dtype=dt, device=device)
            for n, a in zip(_NAMES, k)}


def moe_param_specs(axis="ep"):
    """PartitionSpecs: experts split over `axis`, the gate replicated."""
    return {"gate": P(), "w1": P(axis), "b1": P(axis),
            "w2": P(axis), "b2": P(axis)}


def _mm(a, b):
    """a @ b in the promoted dtype of the two (jnp.matmul's promotion: a
    bf16 activation times an f32 gate is an f32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def dense_reference(params, x):
    """Every token through its top expert, without a capacity (what the
    capacity-bounded layer approaches as the capacity grows)."""
    probs = torch.softmax(_mm(x, params["gate"]), dim=-1)
    top_p, expert = probs.max(dim=-1)
    h = torch.relu(torch.einsum("nd,edh->neh", x, params["w1"])
                   + params["b1"])
    y = torch.einsum("neh,ehd->ned", h, params["w2"]) + params["b2"]
    y_sel = y[torch.arange(x.shape[0], device=x.device), expert]
    return y_sel * top_p[:, None]


class _Gather(torch.autograd.Function):
    """src[index] for an index that reads each row of src at most once,
    but for the last row (src's zero pad row, whose gradient is dropped):
    its backward is a gather too, through `inverse` (each src row's place
    in the output, or len(output) for none), so neither direction sums
    into a row and both are deterministic without atomics."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        return pad.index_select(0, inverse), None, None


def route(probs, cap):
    """Top-1 routing of [N, E] probabilities into capacity `cap`: (expert
    [N] int64, top_p [N], position in the expert's queue [N] int64, keep
    [N] bool). Ties go to the first expert (jnp.argmax's rule, and
    torch.argmax's); a token's position counts the tokens before it, in
    token order, routed to the same expert."""
    e = probs.shape[-1]
    expert = torch.argmax(probs, dim=-1)
    top_p = probs.gather(1, expert[:, None])[:, 0]
    # the running count runs along the tokens of an [E, N] copy: a scan
    # over the inner dim (the card's scan over an outer dim of 8 columns
    # took 1.4 ms a layer at N = 8192)
    onehot = torch.nn.functional.one_hot(expert, e).t().contiguous()
    pos = torch.cumsum(onehot, dim=1).gather(0, expert[None, :])[0] - 1
    return expert, top_p, pos, pos < cap


def moe_layer(params, x, capacity_factor=1.25, ep=1):
    """Top-1 MoE FFN over tokens x [N, D] -> ([N, D], aux_loss 0-d).

    Each expert takes C = ceil(N / E * capacity_factor) token slots; a
    token past its expert's capacity gets zero expert output. aux_loss is
    the GShard load-balance term sum(fraction_tokens * fraction_probs) * E.
    `ep`: the expert products run in that many groups of experts (one a
    replica of the 'ep' axis)."""
    n, d = x.shape
    e = params["w1"].shape[0]
    if e % ep:
        raise ValueError("%d experts do not split over a %d-way 'ep' axis"
                         % (e, ep))
    cap = int(math.ceil(n / e * capacity_factor))
    probs = torch.softmax(_mm(x, params["gate"]).float(), dim=-1)
    expert, top_p, pos, keep = route(probs, cap)
    # slot of each kept token in the flat [E * C] queue; dropped token i
    # goes to spare slot E * C + i past the end, so no two tokens share a
    # slot and the scatter below is deterministic
    ids = torch.arange(n, device=x.device)
    slot = torch.where(keep, expert * cap + pos, e * cap + ids)
    # the token each slot holds (n: none, the zero row of x_pad); the
    # spare slots are cut off
    token = torch.full((e * cap + n,), n, dtype=torch.int64, device=x.device)
    token = token.scatter(0, slot, ids)[:e * cap]
    # each token's slot, E * C (the zero row of out_pad) when dropped
    slot = torch.where(keep, slot, e * cap)
    pad = torch.full((1,), e * cap, dtype=torch.int64, device=x.device)
    xf = x.float()
    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    expert_in = _Gather.apply(x_pad, token, torch.cat([slot, pad])) \
        .reshape(e, cap, d)
    w1, b1 = params["w1"].float(), params["b1"].float()
    w2, b2 = params["w2"].float(), params["b2"].float()
    g = e // ep
    outs = []
    for i in range(ep):
        sl = slice(i * g, (i + 1) * g)
        h = torch.relu(torch.bmm(expert_in[sl], w1[sl]) + b1[sl, None, :])
        outs.append(torch.bmm(h, w2[sl]) + b2[sl, None, :])
    out = outs[0] if ep == 1 else torch.cat(outs)
    # combine: the slot's output times its token's gate probability; a
    # dropped token reads the zero row
    out_pad = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    gathered = _Gather.apply(
        out_pad, slot, torch.cat([token, token.new_full((1,), n)]))
    y = gathered * (top_p * keep)[:, None]
    frac_tokens = torch.nn.functional.one_hot(expert, e).float().mean(0)
    aux = (frac_tokens * probs.mean(0)).sum() * e
    return y.to(x.dtype), aux
