"""Optimizers: graph-building classes appending update ops.

Parity: python/paddle/fluid/optimizer.py and a copy of the JAX package's
optimizer.py — same classes, same accumulator names, same minimize()
contract (append_backward -> clip -> regularization -> per-param update
ops), so both packages build the same training Program. The update ops
run as plain torch (ops/optimizer_ops.py); their ParamOut writes reach the
Scope through the executor's write-back of persistables. Adam and Adagrad
are ported; SGD, Momentum and the other optimizers are later work (ROADMAP
A1).
"""
from collections import defaultdict

from .core.framework import (Variable, default_main_program,
                             default_startup_program, program_guard)
from .core.layer_helper import LayerHelper
from .core.initializer import ConstantInitializer
from .core.backward import append_backward
from .core import unique_name
from . import regularizer as regularizer_mod

__all__ = ["Adam", "AdamOptimizer", "Adagrad", "AdagradOptimizer",
           "Optimizer"]


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None,
                 LARS_weight_decay=0.0):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None
        self._LARS_weight_decay = LARS_weight_decay

    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        from .layers import tensor
        self._learning_rate_map[program] = tensor.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=float(self._learning_rate),
            dtype="float32", persistable=True)

    def _global_learning_rate(self, program=None):
        if program is None:
            program = default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr.get("learning_rate", 1.0) \
            if param.optimize_attr else 1.0
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        return base * param_lr

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _add_accumulator(self, name, param, dtype="float32", fill_value=0.0,
                         shape=None):
        # called in the canonical sorted-param order of
        # _create_optimization_pass: the unique_name counter baked into the
        # accumulator's name (and so into the program bytes) must not
        # depend on a caller-assembled order
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if shape is None:
            shape = param.shape
        helper = LayerHelper(name)
        # persistable: the executor stores it back into the Scope after
        # every run, so the moments carry across steps
        var = helper.create_global_variable(
            name=unique_name.generate(name + "_" + param.name),
            persistable=True, dtype=dtype, shape=shape)
        helper.set_variable_initializer(
            var, initializer=ConstantInitializer(value=float(fill_value)))
        self._accumulators[name][param.name] = var
        var.block.program._accumulator_owner[var.name] = param.name
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        # canonical order: accumulators are created, and update ops
        # appended, in sorted-param-name order, never the order the caller
        # assembled (accumulator names carry unique_name counters, so this
        # order is part of the serialized program bytes)
        parameters_and_grads = sorted(parameters_and_grads,
                                      key=lambda pg: pg[0].name)
        names = [p.name for p, _ in parameters_and_grads]
        assert len(set(names)) == len(names), \
            "duplicate params break the canonical update order: %r" % names
        with program_guard(program, startup_program or
                           default_startup_program()):
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_accumulators(
                loss.block, [p[0] for p in parameters_and_grads])
            self._create_global_learning_rate()

            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if param_and_grad[0].trainable:
                    op = self._append_optimize_op(loss.block, param_and_grad)
                    optimize_ops.append(op)
            self._finish_update(loss.block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        from .clip import append_gradient_clip_ops
        with program_guard(loss.block.program, startup_program or
                           default_startup_program()):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = regularizer_mod.append_regularization_ops(
                params_grads, self.regularization)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [moment_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [moment_acc]},
            attrs={"epsilon": self._epsilon},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        self._beta1_pow_acc = self._add_global_accumulator(
            "beta1_pow_acc", self._beta1)
        self._beta2_pow_acc = self._add_global_accumulator(
            "beta2_pow_acc", self._beta2)

    def _add_global_accumulator(self, name, fill_value):
        helper = LayerHelper(name)
        var = helper.create_or_get_global_variable(
            name=unique_name.generate(name), persistable=True,
            dtype="float32", shape=[1])
        helper.set_variable_initializer(
            var, initializer=ConstantInitializer(value=float(fill_value)))
        # optimizer-global state (beta pows): owner "" in
        # program._accumulator_owner, as the JAX package records it
        var.block.program._accumulator_owner.setdefault(var.name, "")
        return var

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str,
                                        param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str,
                                        param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [moment1], "Moment2": [moment2],
                    "Beta1Pow": [self._beta1_pow_acc],
                    "Beta2Pow": [self._beta2_pow_acc]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "Moment1Out": [moment1], "Moment2Out": [moment2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block):
        block.append_op(
            type="adam_beta_pow_update",
            inputs={"Beta1Pow": [self._beta1_pow_acc],
                    "Beta2Pow": [self._beta2_pow_acc]},
            outputs={"Beta1PowOut": [self._beta1_pow_acc],
                     "Beta2PowOut": [self._beta2_pow_acc]},
            attrs={"beta1": self._beta1, "beta2": self._beta2},
            infer_shape=False)


Adam = AdamOptimizer
Adagrad = AdagradOptimizer
