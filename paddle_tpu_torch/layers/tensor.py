"""Tensor creation layers: create_tensor, create_parameter,
create_global_var, cast, concat, sums, assign, fill_constant,
fill_constant_batch_size_like, zeros, ones and argmax.

Parity: python/paddle/fluid/layers/tensor.py and the JAX package's
layers/tensor.py, which build the same ops.
"""
import numpy as np

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..core.initializer import ConstantInitializer

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "zeros", "ones", "argmax"]


def create_tensor(dtype, name=None, persistable=False):
    """An empty variable of the current block, named after the layer."""
    helper = LayerHelper("create_tensor", **locals())
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..core.param_attr import ParamAttr
    helper = LayerHelper("create_parameter", **locals())
    attr = ParamAttr.to_attr(attr)
    if attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", **locals())
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name)
    helper.set_variable_initializer(
        var, initializer=ConstantInitializer(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": out.dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """Copy a Variable (an assign op) or a numpy array (an assign_value op
    holding its values) into `output`, a new var when none is given."""
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(input.dtype))
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                   "values": input.reshape(-1).tolist()},
            infer_shape=False)
        output.shape = tuple(input.shape)
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value)},
        infer_shape=False)
    out.shape = tuple(int(s) for s in shape)
    out.dtype = out.dtype or dtype
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A constant of `shape` whose dim output_dim_idx is input's dim
    input_dim_idx (the batch, as a whole)."""
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
