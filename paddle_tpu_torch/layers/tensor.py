"""Tensor creation layers (the subset the optimizers and the LR schedules
call: create_global_var, cast).

Parity: python/paddle/fluid/layers/tensor.py and the JAX package's
layers/tensor.py.
"""
from ..core.layer_helper import LayerHelper
from ..core.initializer import ConstantInitializer

__all__ = ["create_global_var", "cast"]


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
