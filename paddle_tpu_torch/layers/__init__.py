"""Layer functions (the subset the port's models, optimizers and LR
schedules call)."""
from .io import (ListenAndServ, Recv, Send,  # noqa: F401
                 create_double_buffer_reader, create_multi_pass_reader,
                 create_shuffle_reader, data, double_buffer, multi_pass,
                 open_files, open_recordio_file, read_file, shuffle)
from .nn import (accuracy, autoincreased_step_counter,  # noqa: F401
                 batch_norm, chunk_eval, conv2d, conv2d_transpose, cos_sim,
                 crf_decoding, cross_entropy, ctc_greedy_decoder, dropout,
                 edit_distance, embedding, expand, fc, fused_attention,
                 im2sequence, l2_normalize, label_smooth, layer_norm,
                 linear_chain_crf, lrn, matmul, maxout, multiplex, nce,
                 one_hot, pool2d, reduce_max, reduce_mean, reduce_min,
                 reduce_prod, reduce_sum, sequence_erase, sequence_mask,
                 smooth_l1, softmax, softmax_with_cross_entropy, split,
                 square_error_cost, topk, transpose, warpctc)
from .ops import *  # noqa: F401,F403  (the generated op layers)
from .sequence import (beam_search, beam_search_decode,  # noqa: F401
                       dynamic_gru, dynamic_lstm,
                       dynamic_lstmp, gru_unit, lod_reset, lstm_unit,
                       row_conv, sequence_cache_write, sequence_conv,
                       sequence_expand, sequence_first_step,
                       sequence_last_step, sequence_pool, sequence_reshape,
                       sequence_softmax)
from .extras import sequence_concat, sequence_slice  # noqa: F401
from .control_flow import (ConditionalBlock, DynamicRNN,  # noqa: F401
                           IfElse, Print, StaticRNN, Switch, While,
                           WhileGuard, array_length, array_read,
                           array_to_lod_tensor, array_write, create_array,
                           equal, greater_equal, greater_than, increment,
                           is_empty, less_equal, less_than,
                           lod_rank_table, lod_tensor_to_array,
                           max_sequence_len, merge_lod_tensor, not_equal,
                           reorder_lod_tensor_by_rank, shrink_memory,
                           split_lod_tensor)
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
