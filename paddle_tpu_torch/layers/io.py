"""Data-input layers.

Parity: python/paddle/fluid/layers/io.py and the JAX package's
layers/io.py — `data` declares a feed Variable (batch dim prepended as -1,
like the reference's append_batch_size).
"""
from ..core.framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    # reference semantics: None becomes -1, and any explicit -1/None in the
    # shape disables batch-dim prepending
    shape = [-1 if s is None else s for s in shape]
    if append_batch_size and all(s >= 0 for s in shape):
        shape = [-1] + shape
    block = default_main_program().global_block()
    if lod_level > 0:
        # padded-dense sequence layout: [num_seqs, max_len, *feature] plus
        # an int32 lengths companion
        shape = [shape[0], -1] + shape[1:]
        block.create_var(
            name=name + "@SEQLEN", shape=[-1], dtype="int32",
            stop_gradient=True, is_data=True)
    main = block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    if lod_level > 0:
        main.seq_len_var = name + "@SEQLEN"
    return main
