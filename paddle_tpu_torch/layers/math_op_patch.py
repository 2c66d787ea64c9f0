"""Python operator overloading on Variable: + - * / ** (and the reversed
forms) and unary -.

Parity: python/paddle/fluid/layers/math_op_patch.py and the JAX package's
layers/math_op_patch.py (monkey_patch_variable), which build the same ops:
`x op y` appends elementwise_<op> (axis -1); a scalar operand of + - * on
the right becomes a `scale` op, any other scalar operand a fill_constant
[1] var. The comparison operators wait for the compare ops (ROADMAP A3).
"""
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper


def _create_scalar_op(value, dtype):
    helper = LayerHelper("scalar")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": [1], "dtype": dtype, "value": float(value)},
        infer_shape=False)
    out.shape = (1,)
    out.stop_gradient = True
    return out


def _elementwise_method(op_type, reverse=False, scalar_as_scale=None):
    def method(self, other):
        helper = LayerHelper(op_type)
        if isinstance(other, (int, float)):
            if scalar_as_scale and not reverse:
                out = helper.create_variable_for_type_inference(self.dtype)
                helper.append_op(type="scale", inputs={"X": [self]},
                                 outputs={"Out": [out]},
                                 attrs=dict(scalar_as_scale(other)))
                return out
            other = _create_scalar_op(other, self.dtype)
        x, y = (other, self) if reverse else (self, other)
        out = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out
    return method


def monkey_patch_variable():
    Variable.__add__ = _elementwise_method(
        "elementwise_add", scalar_as_scale=lambda c: {"scale": 1.0, "bias": c})
    Variable.__radd__ = Variable.__add__
    Variable.__sub__ = _elementwise_method(
        "elementwise_sub", scalar_as_scale=lambda c: {"scale": 1.0, "bias": -c})
    Variable.__rsub__ = _elementwise_method("elementwise_sub", reverse=True)
    Variable.__mul__ = _elementwise_method(
        "elementwise_mul", scalar_as_scale=lambda c: {"scale": c})
    Variable.__rmul__ = Variable.__mul__
    Variable.__truediv__ = _elementwise_method("elementwise_div")
    Variable.__rtruediv__ = _elementwise_method("elementwise_div",
                                                reverse=True)
    Variable.__pow__ = _elementwise_method("elementwise_pow")
    Variable.__rpow__ = _elementwise_method("elementwise_pow", reverse=True)
    Variable.__neg__ = lambda self: self * (-1.0)
