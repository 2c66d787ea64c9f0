"""ParamAttr.

Parity: python/paddle/fluid/param_attr.py and the JAX package's
core/param_attr.py.
"""
from .initializer import ConstantInitializer, XavierInitializer


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(XavierInitializer())

    def set_default_bias_initializer(self):
        self.set_default_initializer(ConstantInitializer(0.0))

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if arg is False:  # before the int check: bool is an int subclass
            return False
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if hasattr(arg, "__call__"):  # bare initializer
            return ParamAttr(initializer=arg)
        if isinstance(arg, (float, int)) and not isinstance(arg, bool):
            return ParamAttr(learning_rate=float(arg))
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    """Weight normalization (parity: fluid.WeightNormParamAttr and the JAX
    package's): the parameter is w = g * v / ||v||, the norm over every
    axis but `dim` (dim=None: one scalar g). v keeps the initializer; g
    starts at ||v|| (a wn_norm op in the startup program), so the first w
    equals v. One `weight_norm` op computes w; autograd gives g and v
    their gradients."""

    # the derived w variables, as the reference lists them
    params_with_weight_norm = []

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
