"""Gradient and error clipping.

Parity: python/paddle/fluid/clip.py and the JAX package's clip.py — the
same classes and `append_gradient_clip_ops`, which Optimizer.minimize
calls. With no clip attr on any parameter it passes the (param, grad)
pairs through unchanged. The clipping kinds build ops the port does not
have yet (clip, clip_by_norm, reduce_sum_square, global_norm_scale; ROADMAP
A3), so asking for one raises NotImplementedError when the program is
built, and so does an error clip on a variable (core/backward.py).
"""
from .core.framework import default_main_program

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class _UnportedClip(BaseGradientClipAttr):
    _ops = ()

    def _create_operators(self, param, grad):
        raise NotImplementedError(
            "%s needs the %s op(s), which paddle_tpu_torch does not have yet "
            "(ROADMAP A3)" % (type(self).__name__, ", ".join(self._ops)))


class GradientClipByValue(_UnportedClip):
    _ops = ("clip",)

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


class GradientClipByNorm(_UnportedClip):
    _ops = ("clip_by_norm",)

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class GradientClipByGlobalNorm(_UnportedClip):
    _ops = ("reduce_sum_square", "sum", "global_norm_scale")

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name


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
