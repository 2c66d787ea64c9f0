"""Layer functions (the subset models/transformer.py, its training graph,
models/understand_sentiment.py, models/machine_translation.py, a stacked
dynamic_lstmp acoustic model, models/recognize_digits.py and
models/image_classification.py call)."""
from .io import data  # noqa: F401
from .nn import (accuracy, autoincreased_step_counter,  # noqa: F401
                 batch_norm, conv2d, cross_entropy, embedding, fc,
                 fused_attention, layer_norm, matmul, one_hot, pool2d,
                 reduce_sum, sequence_mask, softmax,
                 softmax_with_cross_entropy)
from .ops import (elementwise_add, elementwise_div, elementwise_min,  # noqa: F401
                  elementwise_mul, elementwise_pow, elementwise_sub, mean,
                  mul, relu, reshape, scale, squeeze, tanh, unsqueeze)
from .sequence import (dynamic_lstm, dynamic_lstmp,  # noqa: F401
                       sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_pool, sequence_softmax)
from .control_flow import DynamicRNN, StaticRNN  # noqa: F401
from .tensor import cast, create_global_var  # noqa: F401
from .learning_rate_scheduler import noam_decay  # noqa: F401
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
