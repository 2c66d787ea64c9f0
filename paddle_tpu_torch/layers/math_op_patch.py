"""Python operator overloading on Variable (the subset the serving slice
uses: `+`).

Parity: python/paddle/fluid/layers/math_op_patch.py and the JAX package's
layers/math_op_patch.py: `x + y` appends elementwise_add (axis -1); a
scalar operand becomes a `scale` op with that bias.
"""
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper


def _add(self, other):
    helper = LayerHelper("elementwise_add")
    out = helper.create_variable_for_type_inference(self.dtype)
    if isinstance(other, (int, float)):
        helper.append_op(type="scale", inputs={"X": [self]},
                         outputs={"Out": [out]},
                         attrs={"scale": 1.0, "bias": other})
        return out
    helper.append_op(type="elementwise_add",
                     inputs={"X": [self], "Y": [other]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def monkey_patch_variable():
    Variable.__add__ = _add
    Variable.__radd__ = _add
