"""Sequence layers (LoD-aware).

Parity: the sequence_* / dynamic_* functions of python/paddle/fluid/layers/
nn.py and the JAX package's layers/sequence.py — same names, arguments and
op emission, so both packages build the same Program for the same calls.
"""
import warnings

from ..core.layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_conv", "sequence_expand",
           "sequence_reshape", "dynamic_lstm", "dynamic_lstmp",
           "dynamic_gru", "gru_unit", "lstm_unit", "lod_reset", "row_conv",
           "sequence_cache_write", "beam_search", "beam_search_decode"]


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


def sequence_expand(x, y, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y], "YLen": [_seq_len(helper, y)]},
        outputs={"Out": [out]})
    out.lod_level = max(y.lod_level, 1)
    out.seq_len_var = y.seq_len_var
    return out


def sequence_reshape(input, new_dim):
    """Parity: fluid.layers.sequence_reshape (sequence_reshape_op.cc) —
    repacks each sequence's row data to width new_dim; a length-L sequence
    of dim D becomes length L*D/new_dim. The op's rule reshapes
    the padded data (valid data is a contiguous row prefix, so it stays
    contiguous) and emits the integer-rescaled OutLen companion."""
    helper = LayerHelper("sequence_reshape", **locals())
    if helper.block.idx != 0:
        # inside a While/RNN sub-block the rule's per-sequence
        # divisibility assertion is not recorded (LowerCtx.add_error
        # records nothing inside a loop body): the reference op would
        # hard-error on a non-divisible tail, here it would be silently
        # truncated. Surface that at build time.
        warnings.warn(
            "sequence_reshape inside a control-flow sub-block: the "
            "per-sequence len*dim % new_dim divisibility check is not "
            "enforceable in-graph there; a non-divisible sequence tail "
            "would be silently dropped. Verify shapes statically.",
            stacklevel=2)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.block.create_var(
        name=out.name + "@SEQLEN", shape=[-1], dtype="int32",
        stop_gradient=True)
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input], "XLen": [_seq_len(helper, input)]},
        outputs={"Out": [out], "OutLen": [out_len]},
        attrs={"new_dim": new_dim})
    out.lod_level = 1
    out.seq_len_var = out_len.name
    return out


def lod_reset(x, y=None, target_lod=None):
    """Re-segment x's flat data stream (reference lod_reset_op.cc: new LoD
    from Y's own LoD, Y.data offsets, or attr target_lod [0, n1, n2...];
    plain per-sequence lengths are also accepted for target_lod — a list
    whose first element is 0 is ALWAYS read as offsets, per the reference,
    so an empty-first-sequence lengths list must be given as offsets)."""
    if y is None and not target_lod:
        raise ValueError(
            "lod_reset: either y or a non-empty target_lod must be "
            "provided (reference lod_reset_op enforces the same)")
    helper = LayerHelper("lod_reset", **locals())
    if helper.block.idx != 0:
        # inside a While/RNN sub-block the rule's length-sum assertion is
        # not recorded (LowerCtx.add_error records nothing inside a loop
        # body): a mismatched target would silently clip or drop rows.
        # Surface that at build time, like sequence_reshape above.
        warnings.warn(
            "lod_reset inside a control-flow sub-block: the target-"
            "segmentation length-sum check is not enforceable in-graph "
            "there; a mismatched target_lod would silently clip or drop "
            "rows. Verify lengths statically.", stacklevel=2)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.block.create_var(
        name=out.name + "@SEQLEN", shape=[-1], dtype="int32",
        stop_gradient=True)
    inputs = {"X": [x]}
    attrs = {}
    if getattr(x, "lod_level", 0):
        inputs["XLen"] = [_seq_len(helper, x)]
    if y is not None:
        if getattr(y, "lod_level", 0):
            inputs["Y"] = [y]
            inputs["YLen"] = [_seq_len(helper, y)]
        else:
            inputs["YData"] = [y]
    elif target_lod is not None:
        tl = [int(v) for v in target_lod]
        attrs["target_lens"] = (
            [b - a for a, b in zip(tl, tl[1:])]
            if tl and tl[0] == 0 and len(tl) > 1 else tl)
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs=attrs)
    out.lod_level = 1
    out.seq_len_var = out_len.name
    return out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None):
    """Parity: fluid.layers.dynamic_gru — input [.., 3*size]."""
    helper = LayerHelper("dynamic_gru", **locals())
    dtype = helper.input_dtype()
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_reset = helper.create_variable_for_type_inference(dtype)
    batch_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias],
              "XLen": [_seq_len(helper, input)]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs,
        outputs={"Hidden": [hidden], "BatchGate": [batch_gate],
                 "BatchResetHiddenPrev": [batch_reset],
                 "BatchHidden": [batch_hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """Parity: fluid.layers.gru_unit (one step; used in DynamicRNN decoders)."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = helper.input_dtype()
    size = size // 3
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Hidden": [updated_hidden], "Gate": [gate],
                 "ResetHiddenPrev": [reset_hidden_pre]},
        attrs={"activation": activation, "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Parity: fluid.layers.lstm_unit — fc(x_t ++ h_prev) then lstm_unit op."""
    from . import nn, tensor
    size = cell_t_prev.shape[-1]
    concat_out = tensor.concat(input=[x_t, hidden_t_prev], axis=-1)
    fc_out = nn.fc(input=concat_out, size=4 * size, param_attr=param_attr,
                   bias_attr=bias_attr)
    helper = LayerHelper("lstm_unit", **locals())
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias})
    return h, c


def sequence_cache_write(cache, x, pos, name=None):
    """Write each row of `x` [B, ...] into `cache` [B, T, ...] at that
    row's position `pos` [B] (the JAX package's addition: the KV-cache
    write of a decode step). Returns the updated cache; make `cache` (and
    `pos`) persistable state and assign the result back to keep the cache
    on the device across runs."""
    helper = LayerHelper("sequence_cache_write", **locals())
    out = helper.create_variable_for_type_inference(cache.dtype)
    helper.append_op(
        type="sequence_cache_write",
        inputs={"Cache": [cache], "X": [x], "Pos": [pos]},
        outputs={"Out": [out]})
    if cache.shape is not None:
        out.shape = tuple(cache.shape)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="row_conv",
        inputs={"X": [input], "Filter": [filter_param],
                "XLen": [_seq_len(helper, input)]},
        outputs={"Out": [out]})
    return helper.append_activation(out)


def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0,
                pre_scores=None, return_parent_idx=False, name=None):
    """One beam-search expansion step on the dense [batch, beam] layout.

    Parity: python/paddle/fluid/layers/nn.py beam_search /
    operators/beam_search_op.cc and the JAX package's layer. The
    reference keeps its beams in 2-level-LoD candidate lists; here each
    batch row always holds exactly `beam_size` beams, so the decode loop
    keeps static shapes.

    `scores` is [batch, beam, vocab] next-token log-probs, `pre_ids` and
    `pre_scores` [batch, beam]. Returns (selected_ids, selected_scores)
    and, with return_parent_idx, the [batch, beam] parent beam index
    beam_search_decode needs. `ids` (the reference's top-k candidates) is
    accepted and ignored: the op takes its own top-k over beam * vocab.

    At step 0, when every beam of a row starts the same (the usual
    [start_token] * beam), give pre_scores [0, -1e9, -1e9, ...] per row,
    not zeros: otherwise the top-k picks the best token once per
    duplicate beam and the search is beam_size copies of greedy
    decoding."""
    helper = LayerHelper("beam_search", **locals())
    if pre_scores is None:
        raise ValueError(
            "TPU beam_search needs pre_scores (cumulative log-probs); pass "
            "the previous step's selected_scores")
    selected_ids = helper.create_variable_for_type_inference(pre_ids.dtype)
    selected_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent_idx = helper.create_variable_for_type_inference("int32")
    for v in (selected_ids, selected_scores, parent_idx):
        v.shape = pre_ids.shape
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [selected_ids],
                 "selected_scores": [selected_scores],
                 "parent_idx": [parent_idx]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": level},
        infer_shape=False)
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, parent_idx=None, beam_size=None,
                       end_id=0, name=None):
    """Backtrack the per-step beam arrays into sentences.

    Parity: python/paddle/fluid/layers/nn.py beam_search_decode /
    operators/beam_search_decode_op.cc and the JAX package's layer.
    `ids` and `scores` are the arrays written at each step, `parent_idx`
    the array of parent beams from beam_search(return_parent_idx=True).
    Returns (sentence_ids [B, beam, T], end_id past each sentence's end;
    sentence_scores [B, beam])."""
    helper = LayerHelper("beam_search_decode", **locals())
    if parent_idx is None:
        raise ValueError("TPU beam_search_decode needs the parent_idx array "
                         "(beam_search(..., return_parent_idx=True))")
    sentence_ids = helper.create_variable_for_type_inference(ids.dtype)
    sentence_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "ParentIdx": [parent_idx], "Scores": [scores]},
        outputs={"SentenceIds": [sentence_ids],
                 "SentenceScores": [sentence_scores]},
        attrs={"end_id": int(end_id)},
        infer_shape=False)
    return sentence_ids, sentence_scores
