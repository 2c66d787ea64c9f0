"""Layer functions (the subset models/transformer.py calls)."""
from .io import data  # noqa: F401
from .nn import embedding, fc, fused_attention, layer_norm  # noqa: F401
from .ops import elementwise_add, mul, relu, reshape, scale  # noqa: F401
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
