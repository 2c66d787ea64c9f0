"""Ring attention: exact attention over a sequence split across the 'sp'
replicas of a mesh.

Parity: the JAX package's parallel/ring_attention.py, whose ring runs in
shard_map with lax.ppermute. Here one controller holds every replica's
block: Q/K/V split on the sequence dim into one block per sp replica,
and at step s replica j attends its Q block to the K/V block of replica
(j - s) mod sp (the block that arrived after s hops round the ring),
accumulating an online (flash-style) softmax in fp32. A block moves to
its next replica's device between steps (nothing moves when the replicas
share a device). The block attention is plain torch, as the JAX one is
plain jnp; autograd gives the ring's backward. Exact: it matches
attention_reference on the gathered result to fp32 tolerance.

Layout: [batch, seq, heads, head_dim] ("BTHD").
"""
import math

import torch

from ..ops.nn_ops import attention_reference
from .mesh import P

__all__ = ["ring_attention", "attention_reference", "ring_attention_sharded",
           "sequence_parallel_specs", "split_seq"]

_NEG_INF = -1e30


def _block_attend(q, k, v, m, l, o, q_off, k_off, causal, scale,
                  kv_len=None):
    """One online-softmax accumulation step against one K/V block.
    q: [B,Tq,H,D]  k,v: [B,Tk,H,D]  m,l: [B,H,Tq]  o: [B,Tq,H,D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    kpos = k_off + torch.arange(k.shape[1], device=q.device)
    neg = torch.full((), _NEG_INF, dtype=logits.dtype, device=q.device)
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, neg)
    if kv_len is not None:
        kmask = kpos[None, :] < kv_len[:, None]
        logits = torch.where(kmask[:, None, None, :], logits, neg)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if causal or kv_len is not None:
        # a fully masked row would give exp(NEG - NEG) = 1 everywhere
        p = torch.where(logits <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def ring_attention(q_blocks, k_blocks, v_blocks, causal=False, scale=None,
                   kv_len=None):
    """The ring over `len(q_blocks)` sp replicas: replica j holds
    q_blocks[j] / k_blocks[j] / v_blocks[j], the LOCAL sequence blocks
    [B, T/sp, H, D] (on its device). kv_len: optional [B] GLOBAL true
    key lengths. Returns the replicas' output blocks, each in its q
    block's dtype."""
    n = len(q_blocks)
    if scale is None:
        scale = 1.0 / math.sqrt(q_blocks[0].shape[-1])
    b, t_q, h, _ = q_blocks[0].shape
    t_k = k_blocks[0].shape[1]
    qs = [q.float() for q in q_blocks]
    state = []
    for q in qs:
        state.append((torch.full((b, h, t_q), _NEG_INF, dtype=torch.float32,
                                 device=q.device),
                      torch.zeros((b, h, t_q), dtype=torch.float32,
                                  device=q.device),
                      torch.zeros(q.shape, dtype=torch.float32,
                                  device=q.device)))
    held = [(k.float(), v.float()) for k, v in zip(k_blocks, v_blocks)]
    lens = [None if kv_len is None else
            kv_len.reshape(b).to(q.device).long() for q in qs]
    for step in range(n):
        for j in range(n):
            src = (j - step) % n
            k, v = held[j]
            m, l, o = state[j]
            state[j] = _block_attend(qs[j], k, v, m, l, o, q_off=j * t_q,
                                     k_off=src * t_k, causal=causal,
                                     scale=scale, kv_len=lens[j])
        if step < n - 1:
            # one hop round the ring: replica j receives replica j-1's
            held = [(held[(j - 1) % n][0].to(qs[j].device),
                     held[(j - 1) % n][1].to(qs[j].device))
                    for j in range(n)]
    out = []
    for q, (m, l, o) in zip(q_blocks, state):
        l = torch.clamp(l, min=1e-30)
        out.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return out


def sequence_parallel_specs(batch_axis="dp", seq_axis="sp"):
    """PartitionSpec of BTHD activations under sequence parallelism."""
    return P(batch_axis, seq_axis, None, None)


def split_seq(x, n):
    """[B, T, ...] -> n blocks [B, T/n, ...] (T must divide)."""
    if x.shape[1] % n:
        raise ValueError("sequence length %d does not split evenly over "
                         "sp=%d" % (x.shape[1], n))
    return list(torch.chunk(x, n, dim=1))


def ring_attention_sharded(q, k, v, mesh, causal=False, scale=None,
                           batch_axis="dp", seq_axis="sp", kv_len=None):
    """Global-view ring attention: q, k, v full [B, T, H, D]; the sequence
    splits over `seq_axis`'s replicas, the ring runs, and the output
    blocks concatenate back. The batch axis changes nothing here (each
    dp replica's rows attend among themselves); kv_len: optional [B]
    global key lengths."""
    n = int(mesh.shape.get(seq_axis, 1))
    if n <= 1:
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len).to(q.dtype)
    outs = ring_attention(split_seq(q, n), split_seq(k, n), split_seq(v, n),
                          causal=causal, scale=scale, kv_len=kv_len)
    return torch.cat(outs, dim=1)
