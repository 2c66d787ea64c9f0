"""Parameter initializers.

Parity: python/paddle/fluid/initializer.py and the JAX package's
core/initializer.py — each initializer appends an init op to the STARTUP
program targeting the parameter (Constant -> fill_constant, Uniform ->
uniform_random, Normal -> gaussian_random, Xavier/MSRA -> uniform/gaussian
with fan-derived bounds, NumpyArray -> assign_value).
"""
import numpy as np


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "value": float(self.value),
                   "dtype": var.dtype},
            infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "min": float(self.low),
                   "max": float(self.high), "dtype": var.dtype,
                   "seed": self.seed},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "mean": float(self.mean),
                   "std": float(self.std), "dtype": var.dtype,
                   "seed": self.seed},
            infer_shape=False)


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / fi))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear-upsampling kernel of a conv2d_transpose weight [C_in,
    C_out, kh, kw], as one assign_value op (parity: fluid initializer.py
    Bilinear and the JAX package's)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D weight")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        size = shape[2] * shape[3]
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight[i // (shape[2] * shape[3] * shape[1]),
                   (i // size) % shape[1], y, x] = w
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "values": weight.reshape(-1).tolist()},
            infer_shape=False)


class NumpyArrayInitializer(Initializer):
    """Initialize a parameter from a fixed numpy array (e.g. sinusoid
    position-encoding tables, pretrained embeddings)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={"shape": list(self.value.shape),
                   # ndarray, NOT a python list: large tables must not be
                   # exploded into boxed floats per element
                   "values": self.value,
                   "dtype": var.dtype},
            infer_shape=False)


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
