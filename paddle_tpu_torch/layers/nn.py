"""NN layers that build graph ops (the subset the port's models and the LR
schedules call).

Parity: python/paddle/fluid/layers/nn.py and the JAX package's layers/nn.py
— same function names, argument names and op emission, so both packages
build the same Program for the same calls.
"""
import numpy as np

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..core.initializer import ConstantInitializer, NormalInitializer
from ..core.param_attr import ParamAttr
from ..ops.nn_ops import pair as _pair

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "fused_attention",
           "softmax_with_cross_entropy", "softmax", "cross_entropy",
           "accuracy", "one_hot", "reduce_sum", "autoincreased_step_counter",
           "matmul", "sequence_mask", "cos_sim", "square_error_cost",
           "lrn", "transpose", "dropout", "split", "label_smooth",
           "conv2d_transpose", "smooth_l1", "topk", "reduce_mean",
           "reduce_max", "reduce_min", "reduce_prod", "l2_normalize",
           "multiplex", "maxout", "nce", "expand"]


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


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """A conv2d op over an NCHW input with an OIHW filter parameter
    (default init Normal(0, sqrt(2 / (k_h^2 * C_in)))), then the bias op
    over the channel axis (none with bias_attr=False) and the
    activation."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] ** 2 * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "dilations": list(dilation), "groups": groups,
               "use_cudnn": use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None):
    """A pool2d op (max or avg) over an NCHW input."""
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be 'max' or 'avg'")
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(_pair(pool_size)),
               "global_pooling": global_pooling,
               "strides": list(_pair(pool_stride)),
               "paddings": list(_pair(pool_padding)),
               "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """A batch_norm op: scale (init 1) and bias parameters, and the
    moving mean (init 0) and variance (init 1) as persistable parameters
    that are not trainable and take no gradient (the op itself writes
    them each training step). in_place is accepted and always gives a
    new output var, as in the JAX package."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    if data_layout == "NCHW":
        channel_num = input_shape[1] if len(input_shape) > 2 \
            else input_shape[-1]
    else:
        channel_num = input_shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name,
                       initializer=ConstantInitializer(0.0), trainable=False),
        shape=param_shape, dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name,
                       initializer=ConstantInitializer(1.0), trainable=False),
        shape=param_shape, dtype=dtype)
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    batch_norm_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [batch_norm_out], "MeanOut": [mean],
                 "VarianceOut": [variance], "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout})
    return helper.append_activation(batch_norm_out)


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


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"keep_dim": keep_dim,
                                "reduce_all": dim is None,
                                "dim": dim if dim is not None else 0})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


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


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="square_error_cost",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out]})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [N, 1] (the op also outputs both
    norms)."""
    helper = LayerHelper("cos_sim", **locals())
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across the channels of NCHW."""
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """Parity: fluid.layers.dropout (Mask output, downgrade_in_infer:
    clone(for_test=True) flips is_test, and Out is then X * (1 - p))."""
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """Parity: fluid.layers.split: `num_or_sections` an int (equal parts)
    or a list of section sizes along `dim`."""
    helper = LayerHelper("split", **locals())
    input_shape = input.shape
    dim = dim if dim >= 0 else dim + len(input_shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """Parity: fluid.layers.label_smooth, with or without a prior
    distribution."""
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": float(epsilon)})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None):
    """Transposed convolution (NCHW, filter [C_in, num_filters, kh, kw]);
    filter_size may be derived from output_size, as in fluid."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    input_channel = input.shape[1]
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is "
                             "None")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    else:
        filter_size = _pair(filter_size)
    img_filter = helper.create_parameter(
        dtype=dtype, shape=[input_channel, num_filters] + list(filter_size),
        attr=helper.param_attr)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [img_filter]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "dilations": list(dilation)})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1", **locals())
    diff = helper.create_variable_for_type_inference(x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss", inputs=inputs,
        outputs={"Diff": [diff], "Out": [loss]},
        attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def topk(input, k):
    """(values, int64 indices) of the k largest along the last dim."""
    helper = LayerHelper("topk", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="topk", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", **locals())
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    """Noise-contrastive estimation: W [classes, D] and b [classes, 1]
    parameters, the nce op, its cost over num_neg_samples + 1."""
    helper = LayerHelper("nce", **locals())
    dim = input.shape[1]
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, dim],
        dtype=input.dtype, is_bias=False)
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_total_classes, 1],
        dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce",
        inputs={"Input": [input], "Label": [label], "Weight": [w],
                "Bias": [b]},
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": num_neg_samples})
    return cost / (num_neg_samples + 1)


def expand(x, expand_times, name=None):
    """x tiled expand_times along each dim."""
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)})
    return out
