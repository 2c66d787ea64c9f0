"""Gradient and error clipping.

Parity: python/paddle/fluid/clip.py and the JAX package's clip.py: the
same classes, `error_clip_callback` and `append_gradient_clip_ops`, which
Optimizer.minimize calls, building the same ops (`clip`, `clip_by_norm`,
and per global-norm group `reduce_sum_square` per gradient, `sum`,
`global_norm_scale` and `elementwise_mul`; their rules are in
ops/basic.py and run on the device with no host sync). With no clip attr
on any parameter the (param, grad) pairs pass through unchanged. An error
clip on a variable is appended by core/backward.py on its fully
accumulated gradient, through `append_error_clip`.
"""
from .core.framework import default_main_program

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback"]


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


def append_error_clip(block, grad_name, error_clip):
    """Append to `block` the `clip` op that holds gradient `grad_name`, in
    place, within `error_clip`'s [min, max]: the one error-clip policy,
    which append_backward (core/backward.py) and error_clip_callback
    apply."""
    block.append_op(
        type="clip", inputs={"X": [grad_name]}, outputs={"Out": [grad_name]},
        attrs={"min": error_clip.min, "max": error_clip.max},
        infer_shape=False)


def error_clip_callback(block, context):
    """Parity: reference clip.py:62. Called per appended grad op with the
    grad_to_var map; clips the @GRAD outputs whose forward var carries an
    error_clip attr (append_error_clip). The built-in append_backward
    applies the same helper on each fully accumulated gradient; this
    callback is the hook for custom backward builders."""
    grad_to_var = context
    if not block.ops:
        return
    op = block.ops[-1]
    for grad_n in (n for ns in op.outputs.values() for n in ns
                   if n in grad_to_var):
        fwd_var = block.var_recursive(grad_to_var[grad_n])
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is None:
            continue
        if not isinstance(error_clip, BaseErrorClipAttr):
            raise TypeError("Variable's error_clip should be an instance "
                            "of BaseErrorClipAttr or None")
        append_error_clip(block, grad_n, error_clip)


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + "@CLIP")
        block.append_op(type="clip", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max},
                        infer_shape=False)
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + "@CLIP")
        block.append_op(type="clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm},
                        infer_shape=False)
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters in a group should share "
                             "clip_norm")
        context[self.group_name].append((param, grad))
        self.context = context

    def _create_operators(self, param, grad):
        # the group's scale min(1, clip_norm / global norm) is built once,
        # when its first gradient comes through, and read by the rest
        group = self.context[self.group_name]
        block = grad.block
        scale_name = self.group_name + "@CLIP_SCALE"
        if not block.has_var(scale_name):
            sums = []
            for _, g in group:
                sq = block.create_var(dtype=g.dtype, shape=(1,))
                block.append_op(type="reduce_sum_square", inputs={"X": [g]},
                                outputs={"Out": [sq]}, infer_shape=False)
                sums.append(sq)
            total = block.create_var(dtype=grad.dtype, shape=(1,),
                                     name=self.group_name + "@GLOBAL_NORM_SQ")
            block.append_op(type="sum", inputs={"X": sums},
                            outputs={"Out": [total]}, infer_shape=False)
            scale = block.create_var(dtype=grad.dtype, shape=(1,),
                                     name=scale_name)
            block.append_op(type="global_norm_scale", inputs={"X": [total]},
                            outputs={"Out": [scale]},
                            attrs={"clip_norm": self.clip_norm},
                            infer_shape=False)
        scale_var = block.var(scale_name)
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + "@CLIP")
        block.append_op(type="elementwise_mul",
                        inputs={"X": [grad], "Y": [scale_var]},
                        outputs={"Out": [out]}, attrs={"axis": -1},
                        infer_shape=False)
        return param, out


def set_gradient_clip(clip, param_list=None, program=None):
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip should be an instance of BaseGradientClipAttr")
    if program is None:
        program = default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    if all(isinstance(elem, str) for elem in param_list):
        param_list = [program.global_block().var(name) for name in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    for p, g in param_grad:
        clip_attr = p.gradient_clip_attr or NullGradientClipAttr()
        clip_attr._process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = p.gradient_clip_attr or NullGradientClipAttr()
        res.append(clip_attr._create_operators(param=p, grad=g))
    return res
