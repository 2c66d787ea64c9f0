"""Optimizers: graph-building classes appending update ops.

Parity: python/paddle/fluid/optimizer.py and a copy of the JAX package's
optimizer.py — same classes, same accumulator names, same minimize()
contract (append_backward -> clip -> regularization -> per-param update
ops), so both packages build the same training Program. The update ops
run as plain torch (ops/optimizer_ops.py); their ParamOut writes reach the
Scope through the executor's write-back of persistables. ModelAverage
keeps running sums of the parameters in the program and swaps their
average into a Scope on apply().
"""
from collections import defaultdict

import torch

from .core.framework import (Variable, default_main_program,
                             default_startup_program, program_guard)
from .core.layer_helper import LayerHelper
from .core.initializer import ConstantInitializer
from .core.backward import append_backward
from .core import unique_name
from . import regularizer as regularizer_mod

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "SGDOptimizer", "MomentumOptimizer",
    "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "DecayedAdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
    "FtrlOptimizer", "ModelAverage", "Optimizer",
    "ProximalGD", "ProximalAdagrad", "ProximalGDOptimizer",
    "ProximalAdagradOptimizer", "scale_learning_rate",
    "persistable_lr_names"]


def persistable_lr_names(program):
    """Names of the persistable learning-rate variables the program's
    update ops read (in op order, each once). Empty for scheduler-derived
    rates, which are recomputed in the program each step."""
    names = []
    for op in program.global_block().ops:
        for n in op.inputs.get("LearningRate", ()):
            if n and n not in names:
                v = program.global_block().vars.get(n)
                if v is not None and v.persistable:
                    names.append(n)
    return names


def scale_learning_rate(program, scope, factor):
    """Scale every persistable learning rate the program's update ops read
    by `factor`, in the scope, on its device and in its dtype. Returns the
    scaled names; raises when no such rate holds a value (a
    scheduler-derived rate is recomputed each step and cannot be scaled
    this way)."""
    scaled = []
    for n in persistable_lr_names(program):
        val = scope.get(n)
        if val is None:
            continue
        scope.set(n, (val * factor).to(val.dtype))
        scaled.append(n)
    if not scaled:
        raise ValueError(
            "scale_learning_rate: no persistable learning-rate variable "
            "holds a value in the scope — scheduler-derived rates are "
            "recomputed in-graph each step and cannot be damped this "
            "way")
    return scaled


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


class SGDOptimizer(Optimizer):
    """param -= lr * grad (sgd_op.cc)."""

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]},
            infer_shape=False)


class MomentumOptimizer(Optimizer):
    """Momentum with a persistable velocity per parameter (momentum_op.cc),
    optionally Nesterov's."""
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(
            self._velocity_acc_str, param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Velocity": [velocity_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity_acc]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


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


class AdamaxOptimizer(AdamOptimizer):
    """Adam with the infinity norm (adamax_op.h); its one beta power is
    scaled by beta1 after every step."""
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
        self._beta1_pow_acc = self._add_global_accumulator(
            "beta1_pow_acc", self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type="adamax",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [self._beta1_pow_acc]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [moment], "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block):
        block.append_op(
            type="scale",
            inputs={"X": [self._beta1_pow_acc]},
            outputs={"Out": [self._beta1_pow_acc]},
            attrs={"scale": self._beta1},
            infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    """Its update op reads no learning rate (adadelta_op.h): the
    learning-rate var is created all the same, as in the JAX package."""
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        g = self._get_accumulator(self._avg_squared_grad_acc_str,
                                  param_and_grad[0])
        u = self._get_accumulator(self._avg_squared_update_acc_str,
                                  param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [g], "AvgSquaredUpdate": [u]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [g], "AvgSquaredUpdateOut": [u]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [momentum_acc],
                    "MeanSquare": [mean_square_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [momentum_acc],
                     "MeanSquareOut": [mean_square_acc]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        lin = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
            infer_shape=False)


class ProximalGDOptimizer(Optimizer):
    """proximal_gd_op.cc (FOBOS): prox = param - lr * grad; param =
    sign(prox) / (1 + lr*l2) * max(|prox| - lr*l1, 0)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super(ProximalGDOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="proximal_gd",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]},
            attrs={"l1": self._l1, "l2": self._l2},
            infer_shape=False)


class ProximalAdagradOptimizer(Optimizer):
    """proximal_adagrad_op.cc: the proximal step on an adagrad-scaled
    gradient."""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super(ProximalAdagradOptimizer, self).__init__(learning_rate,
                                                       **kwargs)
        self._l1 = l1
        self._l2 = l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type="proximal_adagrad",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [moment]},
            attrs={"l1": self._l1, "l2": self._l2},
            infer_shape=False)


class ModelAverage(Optimizer):
    """fluid.optimizer.ModelAverage (average_accumulates_op): built after
    the optimizer's minimize, it appends to the main program, for every
    parameter not marked do_model_average=False, a persistable sum that
    each run adds the updated parameter to, and one run counter.
    `apply(executor)` is a context manager that swaps each parameter for
    sum / max(counter, 1) in the scope and, with need_restore, swaps the
    parameters back on exit; `restore(executor)` swaps them back after an
    apply(need_restore=False). The sums, the counter and the averages stay
    tensors on the scope's device."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super(ModelAverage, self).__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._sums = {}
        self._backup = {}
        program = default_main_program()
        for param in program.global_block().all_parameters():
            if param.do_model_average is False:
                continue
            s = self._add_accumulator("sum_1", param)
            self._sums[param.name] = s
            program.current_block().append_op(
                type="elementwise_add",
                inputs={"X": [s], "Y": [param]},
                outputs={"Out": [s]},
                attrs={"axis": -1},
                infer_shape=False)
        self._counter = self._add_counter()

    def _add_counter(self):
        helper = LayerHelper("ma_counter")
        var = helper.create_or_get_global_variable(
            name=unique_name.generate("ma_counter"), persistable=True,
            dtype="float32", shape=[1])
        helper.set_variable_initializer(var, ConstantInitializer(0.0))
        var.block.program._accumulator_owner.setdefault(var.name, "")
        default_main_program().current_block().append_op(
            type="increment", inputs={"X": [var]}, outputs={"Out": [var]},
            attrs={"step": 1.0}, infer_shape=False)
        return var

    def apply(self, executor, need_restore=True, scope=None):
        """Context manager: the averaged parameters in `scope` (default
        the global scope) inside the with block."""
        import contextlib
        from .core.executor import global_scope
        scope = scope if scope is not None else global_scope()

        @contextlib.contextmanager
        def _ctx():
            counter = torch.clamp_min(scope.get(self._counter.name), 1.0)
            for pname, svar in self._sums.items():
                self._backup[pname] = scope.get(pname)
                s = scope.get(svar.name)
                scope.set(pname, (s / counter.to(s.device)).to(s.dtype))
            self._scope = scope
            yield
            if need_restore:
                self.restore(executor)
        return _ctx()

    def restore(self, executor):
        """Put back the parameters the last apply() replaced."""
        for pname, val in self._backup.items():
            self._scope.set(pname, val)
        self._backup = {}


# short aliases (fluid exposes both)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
