"""NN layers that build graph ops (the subset models/transformer.py,
models/understand_sentiment.py, models/machine_translation.py and the noam
schedule call).

Parity: python/paddle/fluid/layers/nn.py and the JAX package's layers/nn.py
— same function names, argument names and op emission, so both packages
build the same Program for the same calls.
"""
import numpy as np

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..core.initializer import ConstantInitializer

__all__ = ["fc", "embedding", "layer_norm", "fused_attention",
           "softmax_with_cross_entropy", "softmax", "cross_entropy",
           "accuracy", "one_hot", "reduce_sum", "autoincreased_step_counter",
           "matmul", "sequence_mask"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None, use_mkldnn=False):
    """Fully connected: one mul op per input + sum (if several) + bias +
    activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()

    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        flatten = num_flatten_dims
        if input_var.lod_level > 0 and num_flatten_dims == 1:
            # sequence input in padded [B, T, D] layout: a per-timestep
            # projection
            flatten = len(input_shape) - 1
        param_shape = [int(np.prod(input_shape[flatten:]))] + [size]
        w = helper.create_parameter(
            attr=param_attr, shape=param_shape, dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": flatten, "y_num_col_dims": 1})
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_activation = helper.append_bias_op(pre_bias, dim_start=flatten)
    return helper.append_activation(pre_activation)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table op over a [vocab, dim] parameter."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else \
        padding_idx if padding_idx >= 0 else (size[0] + padding_idx)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def fused_attention(q, k, v, causal=False, scale=None, kv_len=None,
                    block_q=None, block_k=None, sp_impl="ring", name=None):
    """Attention over [B, T, H, D] q/k/v through the flash kernel (see
    ops/nn_ops.py). kv_len: optional [B] / [B, 1] int32 Variable of true
    key lengths; defaults to k's sequence-lengths companion when k is a
    lod_level>0 sequence. block_q, block_k and sp_impl are recorded in the
    op's attrs as the JAX package records them (so both build the same
    Program); this port's rule does not read them."""
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(
            "fused_attention sp_impl must be 'ring' or 'ulysses', got %r"
            % (sp_impl,))
    helper = LayerHelper("fused_attention", **locals())
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if kv_len is None and getattr(k, "seq_len_var", None):
        kv_len = k.block.var_recursive(k.seq_len_var)
    if kv_len is not None:
        inputs["KVLen"] = [kv_len]
    helper.append_op(
        type="fused_attention", inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": bool(causal),
               "scale": None if scale is None else float(scale),
               "block_q": None if block_q is None else int(block_q),
               "block_k": None if block_k is None else int(block_k),
               "sp_impl": str(sp_impl)})
    if q.shape is not None:
        out.shape = tuple(q.shape)
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    """Fused, numerically stable softmax + cross-entropy; returns the Loss
    (the op's Softmax output is declared too, as in the reference)."""
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label})
    return loss


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False):
    """Cross-entropy of probabilities `input` against `label`."""
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: emits a topk and an accuracy op."""
    helper = LayerHelper("accuracy", **locals())
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="topk", inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32")
    if total is None:
        total = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"keep_dim": keep_dim, "reduce_all": dim is None,
                            "dim": dim if dim is not None else 0})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter incremented once per run, by an
    increment op placed first in the program; drives LR schedules."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True)
    if counter.op is None:
        helper.set_variable_initializer(
            counter, initializer=ConstantInitializer(value=begin - 1))
        counter.op = helper.main_program.global_block().prepend_op(
            type="increment",
            inputs={"X": [counter]},
            outputs={"Out": [counter]},
            attrs={"step": float(step)},
            infer_shape=False)
        counter.stop_gradient = True
    return counter


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[N] lengths -> [N, maxlen] 0/1 mask. Parity: fluid.layers.sequence_mask
    / sequence_mask_op.h. `maxlen` is an int or a Variable whose dim 1 gives
    the length (the padded time dim of a sequence)."""
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if isinstance(maxlen, Variable):
        inputs["MaxLenRef"] = [maxlen]
    elif maxlen is not None:
        attrs["maxlen"] = int(maxlen)
    else:
        raise ValueError("sequence_mask needs a static maxlen (int or a "
                         "Variable whose second dim provides it)")
    helper.append_op(type="sequence_mask", inputs=inputs,
                     outputs={"Y": [out]}, attrs=attrs, infer_shape=False)
    if isinstance(maxlen, Variable):
        m = maxlen.shape[1] if maxlen.shape is not None else -1
    else:
        m = int(maxlen)
    if x.shape is not None:
        out.shape = (x.shape[0], m)
    out.stop_gradient = True
    return out
