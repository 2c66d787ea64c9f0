"""All-to-all (DeepSpeed-Ulysses-style) sequence parallelism.

Parity: the JAX package's parallel/ulysses.py. One all-to-all re-shards
sequence-split [B, T/sp, H, D] blocks into head-split [B, T, H/sp, D]
ones; each sp replica attends over the full sequence for its head group,
and a second all-to-all restores the sequence split. Heads must divide
by sp. One controller holds every replica's blocks, so an all-to-all is
a regrouping of the blocks (a move between devices when the replicas are
apart). The per-group attention is `attend`: the dense reference by
default, as the JAX module's; fused_attention passes its own kernel path
(the flash K1-K3 on the card).
"""
import torch

from .ring_attention import attention_reference, split_seq

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _dense(q, k, v, causal, scale, kv_len):
    return attention_reference(q, k, v, causal=causal, scale=scale,
                               kv_len=kv_len).to(q.dtype)


def ulysses_attention(q_blocks, k_blocks, v_blocks, causal=False,
                      scale=None, kv_len=None, attend=None):
    """Per-replica blocks in, per-replica blocks out: replica j holds the
    sequence blocks [B, T/sp, H, D]; heads must divide by sp. kv_len:
    optional [B] key lengths (after the exchange each replica holds the
    full sequence, so it is the plain dense mask)."""
    attend = _dense if attend is None else attend
    n = len(q_blocks)
    h = q_blocks[0].shape[2]
    if h % n != 0:
        raise ValueError(
            "ulysses_attention needs heads %% sp == 0 (got %d heads over "
            "sp=%d); use ring_attention for head-scarce long-context"
            % (h, n))
    g = h // n

    def seq_to_heads(blocks):
        # replica j gathers head group j of every sequence block
        return [torch.cat([b[:, :, j * g:(j + 1) * g].to(blocks[j].device)
                           for b in blocks], dim=1) for j in range(n)]

    qh, kh, vh = seq_to_heads(q_blocks), seq_to_heads(k_blocks), \
        seq_to_heads(v_blocks)
    outs = [attend(qh[j], kh[j], vh[j], causal, scale,
                   None if kv_len is None else kv_len.to(qh[j].device))
            for j in range(n)]
    t = q_blocks[0].shape[1]
    # replica i gathers its sequence block of every head group
    return [torch.cat([o[:, i * t:(i + 1) * t].to(q_blocks[i].device)
                       for o in outs], dim=2) for i in range(n)]


def ulysses_attention_sharded(q, k, v, mesh, causal=False, scale=None,
                              batch_axis="dp", seq_axis="sp", kv_len=None,
                              attend=None):
    """Global-view entry: full [B, T, H, D] arrays split over `seq_axis`,
    exchanged, attended and exchanged back."""
    n = int(mesh.shape.get(seq_axis, 1))
    if n <= 1:
        attend = _dense if attend is None else attend
        return attend(q, k, v, causal, scale, kv_len)
    outs = ulysses_attention(split_seq(q, n), split_seq(k, n),
                             split_seq(v, n), causal=causal, scale=scale,
                             kv_len=kv_len, attend=attend)
    return torch.cat(outs, dim=1)
