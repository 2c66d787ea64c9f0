"""Sequence layers (LoD-aware): the subset the sentiment classifiers, the
attention translator and the stacked-LSTMP acoustic model call.

Parity: the sequence_* / dynamic_* functions of python/paddle/fluid/layers/
nn.py and the JAX package's layers/sequence.py — same names, arguments and
op emission, so both packages build the same Program for the same calls.
The JAX package's sequence_expand, sequence_reshape, dynamic_gru,
gru_unit, lstm_unit, lod_reset, row_conv and beam-search layers are not
ported yet.
"""
from ..core.layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_conv", "dynamic_lstm",
           "dynamic_lstmp"]


def _seq_len(helper, x):
    if x.seq_len_var is None:
        raise ValueError(
            "%r is not a sequence (lod_level=0); sequence layers need an "
            "input produced from a lod_level>0 data layer" % x.name)
    return helper.block.var_recursive(x.seq_len_var)


def sequence_pool(input, pool_type, is_test=False):
    helper = LayerHelper("sequence_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input], "XLen": [_seq_len(helper, input)]},
        outputs={"Out": [out]},
        attrs={"pooltype": pool_type.upper()})
    out.lod_level = 0
    out.seq_len_var = None
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    """Softmax over each sequence's time steps (input [B, T] or [B, T, 1]);
    steps past a row's length get 0. The fp32 [B, T] case runs the
    masked-softmax kernel (ops/sequence_ops.py)."""
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_softmax",
        inputs={"X": [input], "XLen": [_seq_len(helper, input)]},
        outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param],
                "XLen": [_seq_len(helper, input)]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """Parity: fluid.layers.dynamic_lstm — input must be [.., 4*hidden]
    (pre-projected by an fc), size = 4*hidden. With use_peepholes=False,
    fp32 and the default activations the op runs the fused-LSTM kernel
    (ops/sequence_ops.py)."""
    helper = LayerHelper("dynamic_lstm", **locals())
    hidden = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, 4 * hidden], dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre_act = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias],
              "XLen": [_seq_len(helper, input)]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": [hidden_out], "Cell": [cell_out],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre_act]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden_out, cell_out


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None):
    """Parity: fluid.layers.dynamic_lstmp (reference lstmp_op.cc) — LSTM
    with recurrent projection: the projected state feeds back into the
    gates, so the recurrent Weight is [proj_size, 4*hidden]. param_attr
    may be a 2-list [weight_attr, proj_weight_attr]. With
    use_peepholes=False, fp32 and the default activations the op runs the
    fused-LSTMP kernel (ops/sequence_ops.py)."""
    helper = LayerHelper("dynamic_lstmp", **locals())
    hidden = size // 4
    w_attr, proj_attr = helper.multiple_param_attr(2)
    weight = helper.create_parameter(
        attr=w_attr, shape=[proj_size, 4 * hidden], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=proj_attr, shape=[hidden, proj_size], dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    projection = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre_act = helper.create_variable_for_type_inference(dtype)
    batch_hidden = helper.create_variable_for_type_inference(dtype)
    ordered_p0 = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight], "Bias": [bias],
              "XLen": [_seq_len(helper, input)]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstmp",
        inputs=inputs,
        outputs={"Projection": [projection], "Cell": [cell_out],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre_act],
                 "BatchHidden": [batch_hidden], "OrderedP0": [ordered_p0]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return projection, cell_out
