"""Layer functions (the subset the port's models, optimizers and LR
schedules call)."""
from .io import data  # noqa: F401
from .nn import (accuracy, autoincreased_step_counter,  # noqa: F401
                 batch_norm, conv2d, conv2d_transpose, cos_sim,
                 cross_entropy, dropout, embedding, expand, fc,
                 fused_attention, l2_normalize, label_smooth, layer_norm,
                 lrn, matmul, maxout, multiplex, nce, one_hot, pool2d,
                 reduce_max, reduce_mean, reduce_min, reduce_prod,
                 reduce_sum, sequence_mask, smooth_l1, softmax,
                 softmax_with_cross_entropy, split, square_error_cost,
                 topk, transpose)
from .ops import *  # noqa: F401,F403  (the generated op layers)
from .sequence import (dynamic_lstm, dynamic_lstmp,  # noqa: F401
                       sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_pool, sequence_softmax)
from .control_flow import (ConditionalBlock, DynamicRNN,  # noqa: F401
                           Print, StaticRNN, Switch, equal, greater_equal,
                           greater_than, increment, is_empty, less_equal,
                           less_than, not_equal)
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     create_global_var, create_parameter, create_tensor,
                     fill_constant, fill_constant_batch_size_like, ones,
                     sums, zeros)
from .learning_rate_scheduler import (exponential_decay,  # noqa: F401
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
