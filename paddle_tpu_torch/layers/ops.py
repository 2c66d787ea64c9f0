"""Thin layer wrappers over registered ops: mean, mul, reshape, scale,
squeeze, unsqueeze, sum, sigmoid_cross_entropy_with_logits, the 30
activations and the elementwise and logical families.

Parity: python/paddle/fluid/layers/ops.py + layer_function_generator.py
and the JAX package's layers/ops.py: generated from a slot-spec table;
both calling styles work, `scale(x)` and `scale(x=var, scale=2.0)`, and
every keyword that is not an input slot becomes an op attr; the random
layers take theirs (shape, dtype, min / max or mean / std, seed) so.
`fill_constant_batch_size_like` is layers/tensor.py's, as in the JAX
package, whose tensor module shadows its generated one.
"""
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..ops.basic import ACTIVATIONS as __activations__

_UNARY = [("X", "x", True)]
_BINARY = [("X", "x", True), ("Y", "y", True)]

_SPECS = {
    "mean": (_UNARY, ["Out"]),
    "mul": (_BINARY, ["Out"]),
    "reshape": (_UNARY, ["Out"]),
    "scale": (_UNARY, ["Out"]),
    "sigmoid_cross_entropy_with_logits":
        ([("X", "x", True), ("Label", "label", True)], ["Out"]),
    "clip": (_UNARY, ["Out"]),
    "clip_by_norm": (_UNARY, ["Out"]),
    "logical_not": (_UNARY, ["Out"]),
    "sum": ([("X", "x", True)], ["Out"]),
    "squeeze": (_UNARY, ["Out"]),
    "unsqueeze": (_UNARY, ["Out"]),
    "cumsum": (_UNARY, ["Out"]),
    "scatter": ([("X", "x", True), ("Ids", "ids", True),
                 ("Updates", "updates", True)], ["Out"]),
    "gather": ([("X", "x", True), ("Index", "index", True)], ["Out"]),
    "uniform_random": ([], ["Out"]),
    "gaussian_random": ([], ["Out"]),
    "uniform_random_batch_size_like": ([("Input", "input", True)], ["Out"]),
    "gaussian_random_batch_size_like": ([("Input", "input", True)], ["Out"]),
}
for _a in __activations__:
    _SPECS[_a] = (_UNARY, ["Out"])
for _e in ("elementwise_add", "elementwise_div", "elementwise_sub",
           "elementwise_mul", "elementwise_max", "elementwise_min",
           "elementwise_pow"):
    _SPECS[_e] = (_BINARY, ["Out"])
for _l in ("logical_and", "logical_or", "logical_xor"):
    _SPECS[_l] = (_BINARY, ["Out"])

__all__ = list(_SPECS)


def generate_layer_fn(op_type):
    in_slots, out_slots = _SPECS[op_type]

    def layer_fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        act = kwargs.pop("act", None)
        inputs = {}
        pos = list(args)
        dtype = kwargs.get("dtype")  # stays in kwargs -> reaches op attrs too
        for slot, kw, required in in_slots:
            v = kwargs.pop(kw, None)
            if v is None and pos:
                v = pos.pop(0)
            if v is None:
                if required:
                    raise ValueError("%s missing input %r" % (op_type, kw))
                continue
            inputs[slot] = v if isinstance(v, (list, tuple)) else [v]
            if dtype is None:
                first = inputs[slot][0]
                if isinstance(first, Variable):
                    dtype = first.dtype
        helper = LayerHelper(op_type, name=name, act=act)
        outs = {s: [helper.create_variable_for_type_inference(
            dtype or "float32")] for s in out_slots}
        helper.append_op(type=op_type, inputs=inputs, outputs=outs,
                         attrs=kwargs)
        return helper.append_activation(outs[out_slots[0]][0])

    layer_fn.__name__ = op_type
    return layer_fn


for _op in _SPECS:
    globals()[_op] = generate_layer_fn(_op)
