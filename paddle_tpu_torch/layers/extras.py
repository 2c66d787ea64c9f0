"""The sequence tail of the JAX package's layers/extras.py: sequence_slice
and sequence_concat (ops/tail_ops.py). The rest of that file comes with
ROADMAP A11.

Parity: the reference registers these ops in C++ (paddle/fluid/operators/
{sequence_slice,sequence_concat}_op.cc) without era Python wrappers; the
JAX package's thin layers make them reachable from a Program, and these
emit the same ops.
"""
from ..core.layer_helper import LayerHelper
from .sequence import _seq_len

__all__ = ["sequence_slice", "sequence_concat"]


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.block.create_var(
        name=out.name + "@SEQLEN", shape=[-1], dtype="int32",
        stop_gradient=True)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out], "OutLen": [out_len]})
    out.lod_level = max(input.lod_level, 1)
    out.seq_len_var = out_len.name
    return out


def sequence_concat(input, axis=0, name=None):
    """Concatenate a list of sequences (axis=0: along time per sequence)."""
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    out_len = helper.block.create_var(
        name=out.name + "@SEQLEN", shape=[-1], dtype="int32",
        stop_gradient=True)
    helper.append_op(
        type="sequence_concat",
        inputs={"X": list(input),
                "XLen": [_seq_len(helper, x) for x in input]},
        outputs={"Out": [out], "OutLen": [out_len]},
        attrs={"axis": int(axis)})
    out.lod_level = max(input[0].lod_level, 1)
    out.seq_len_var = out_len.name
    return out
