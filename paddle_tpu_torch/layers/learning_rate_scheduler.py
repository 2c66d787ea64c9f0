"""Learning-rate schedules built as program sub-graphs (noam only).

Parity: python/paddle/fluid/layers/learning_rate_scheduler.py and the JAX
package's layers/learning_rate_scheduler.py: the schedule is ordinary ops
of the training program, driven by the persistable `@LR_DECAY_COUNTER@`
step counter, which the executor stores back after every run. The other
schedules (exponential, natural_exp, inverse_time, polynomial, piecewise)
are later work (ROADMAP A1).
"""
from . import nn
from . import ops
from . import tensor

__all__ = ["noam_decay"]


def _decay_step_counter():
    # the first global step is zero in learning rate decay; noam shifts by
    # +1 in-graph
    global_step = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=0, step=1)
    return tensor.cast(global_step, "float32")


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = learning_rate * d_model^-0.5 * min(step^-0.5, step*warmup^-1.5).

    The "Attention is All You Need" schedule (steps count from 1).
    """
    global_step = _decay_step_counter() + 1.0
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return learning_rate * (d_model ** -0.5) * ops.elementwise_min(a, b)
