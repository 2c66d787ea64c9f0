"""Learning-rate schedules built as program sub-graphs.

Parity: python/paddle/fluid/layers/learning_rate_scheduler.py and the JAX
package's layers/learning_rate_scheduler.py: exponential, natural_exp,
inverse_time, polynomial and piecewise decay, and noam (the transformer's
warm-up schedule). Each schedule is ordinary ops of the training program,
driven by the persistable `@LR_DECAY_COUNTER@` step counter they all
share, which the executor stores back after every run. polynomial_decay's
cycle form and piecewise_decay pick their values with a Switch, whose
conditional blocks select on the device (ops/control_ops.py): no schedule
reads the counter on the host.
"""
from . import control_flow
from . import nn
from . import ops
from . import tensor
from ..core import unique_name

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


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


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (global_step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * exp(-decay_rate * (global_step / decay_steps))."""
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * global_step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1 + decay_rate * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end_lr) * (1 - step/decay_steps)^power + end_lr. With cycle,
    decay_steps grows to the next multiple of itself above the step
    (ceil(step / decay_steps), 1 at step 0); without, the step stops at
    decay_steps."""
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / decay_steps)
        zero_var = tensor.fill_constant(shape=[1], dtype="float32", value=0.0)
        one_var = tensor.fill_constant(shape=[1], dtype="float32", value=1.0)
        with control_flow.Switch() as switch:
            with switch.case(control_flow.equal(global_step, zero_var)):
                tensor.assign(input=one_var, output=div_res)
        decay_steps_v = decay_steps * div_res
    else:
        decay_steps_var = tensor.fill_constant(
            shape=[1], dtype="float32", value=float(decay_steps))
        global_step = ops.elementwise_min(global_step, decay_steps_var)
        decay_steps_v = decay_steps
    return ((learning_rate - end_learning_rate) *
            ((1 - global_step / decay_steps_v) ** power) + end_learning_rate)


def piecewise_decay(boundaries, values):
    """Step function: values[i] while step < boundaries[i], else
    values[-1], in a persistable lr var that a Switch assigns."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) - len(boundaries) should be 1")
    global_step = _decay_step_counter()
    lr = tensor.create_global_var(
        shape=[1], value=0.0, dtype="float32", persistable=True,
        name=unique_name.generate("learning_rate"))
    with control_flow.Switch() as switch:
        for i in range(len(boundaries)):
            boundary_val = tensor.fill_constant(
                shape=[1], dtype="float32", value=float(boundaries[i]))
            value_var = tensor.fill_constant(
                shape=[1], dtype="float32", value=float(values[i]))
            with switch.case(control_flow.less_than(global_step,
                                                    boundary_val)):
                tensor.assign(value_var, lr)
        last_value_var = tensor.fill_constant(
            shape=[1], dtype="float32", value=float(values[-1]))
        with switch.default():
            tensor.assign(last_value_var, lr)
    return lr
