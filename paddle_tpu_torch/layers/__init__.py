"""Layer functions (the subset models/transformer.py and its training
graph call)."""
from .io import data  # noqa: F401
from .nn import (autoincreased_step_counter, embedding, fc,  # noqa: F401
                 fused_attention, layer_norm, one_hot, reduce_sum,
                 softmax_with_cross_entropy)
from .ops import (elementwise_add, elementwise_div, elementwise_min,  # noqa: F401
                  elementwise_mul, elementwise_pow, elementwise_sub, mul,
                  relu, reshape, scale)
from .tensor import cast, create_global_var  # noqa: F401
from .learning_rate_scheduler import noam_decay  # noqa: F401
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
