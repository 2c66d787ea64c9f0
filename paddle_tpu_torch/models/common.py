"""Shared model-building helpers.

Parity: the JAX package's models/common.py, unchanged in content."""
from paddle_tpu_torch import layers

__all__ = ["masked_mean_cost"]


def masked_mean_cost(cost, seq_var, maxlen_ref):
    """Length-masked mean of a per-timestep cost over true tokens.

    cost: [B, T, 1] per-position loss (e.g. cross_entropy over a padded
    sequence). seq_var: the sequence data Variable whose lengths companion
    gives each row's true length. maxlen_ref: a [B, T, ...] Variable whose
    time dim sets the mask width. This is the flat-LoD mean of the
    reference era (sum over real tokens / token count): padding positions
    contribute nothing.
    """
    seq_len = seq_var.block.var_recursive(seq_var.seq_len_var)
    mask = layers.sequence_mask(seq_len, maxlen=maxlen_ref, dtype="float32")
    masked = layers.elementwise_mul(x=layers.squeeze(x=cost, axes=[2]),
                                    y=mask)
    return layers.elementwise_div(
        x=layers.reduce_sum(masked), y=layers.reduce_sum(mask))
