"""Layer functions (the subset the port's models, optimizers and LR
schedules call)."""
from .io import data  # noqa: F401
from .nn import (accuracy, autoincreased_step_counter,  # noqa: F401
                 batch_norm, conv2d, cos_sim, cross_entropy, dropout,
                 embedding, fc, fused_attention, label_smooth, layer_norm,
                 lrn, matmul, one_hot, pool2d, reduce_sum, sequence_mask,
                 softmax, softmax_with_cross_entropy, split,
                 square_error_cost, transpose)
from .ops import *  # noqa: F401,F403  (the generated op layers)
from .sequence import (dynamic_lstm, dynamic_lstmp,  # noqa: F401
                       sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_pool, sequence_softmax)
from .control_flow import (ConditionalBlock, DynamicRNN,  # noqa: F401
                           StaticRNN, Switch, equal, greater_equal,
                           greater_than, less_equal, less_than, not_equal)
from .tensor import (assign, cast, concat, create_global_var,  # noqa: F401
                     create_parameter, fill_constant, ones, sums, zeros)
from .learning_rate_scheduler import (exponential_decay,  # noqa: F401
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
