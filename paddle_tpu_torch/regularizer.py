"""Weight-decay regularizers.

Parity: python/paddle/fluid/regularizer.py and a copy of the JAX package's
regularizer.py: append_regularization_ops adds the decay term onto each
parameter's gradient before the optimizer op. With no regularizer set it
passes the (param, grad) pairs through unchanged.
"""

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer(object):
    def append_regularization(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale", inputs={"X": [param]}, outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff}, infer_shape=False)
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]}, infer_shape=False)
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale", inputs={"X": [sign]}, outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff}, infer_shape=False)
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if param.regularizer is not None:
            regularization_term = param.regularizer.append_regularization(
                param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization.append_regularization(
                param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(dtype=param.dtype, shape=param.shape,
                                    name=grad.name + "@REGULARIZED")
        block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [regularization_term]},
            outputs={"Out": [new_grad]},
            attrs={"axis": -1},
            infer_shape=False)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
