"""LayerHelper: shared plumbing for layer functions.

Parity: python/paddle/fluid/layer_helper.py and the JAX package's
core/layer_helper.py. Creates parameters in BOTH the startup program (with
their init op) and the main program, appends bias / activation ops, and
manufactures temp output variables.
"""
import copy

from . import unique_name
from .framework import (default_main_program, default_startup_program,
                        Variable)
from .param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input"
                             % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(param_attr) == 1 and length != 1:
            param_attr = [param_attr[0]] + [copy.deepcopy(param_attr[0])
                                            for _ in range(length - 1)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        if not isinstance(attr, ParamAttr):
            raise TypeError("create_parameter needs a ParamAttr, got %r"
                            % (attr,))
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))

        shape = [int(s) for s in shape]
        from .param_attr import WeightNormParamAttr
        if isinstance(attr, WeightNormParamAttr):
            if getattr(attr, "mesh_axes", None):
                raise NotImplementedError(
                    "mesh_axes on WeightNormParamAttr is not supported: the "
                    "weight-normalized w is a derived variable (g, v are "
                    "the parameters); shard via "
                    "ParallelExecutor(param_shardings=...) instead")
            return self._create_weight_normalized(attr, shape, dtype)
        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            # shared parameter (same ParamAttr name reused): one init op only
            existing = main_block.var(attr.name)
            if getattr(attr, "mesh_axes", None) and \
                    not getattr(existing, "mesh_axes", None):
                existing.mesh_axes = tuple(attr.mesh_axes)
            if existing.shape is not None and \
                    tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    "parameter %r reused with shape %s but was created with "
                    "shape %s" % (attr.name, shape, existing.shape))
            return existing
        # startup program: parameter + its init op
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs(with_initializer=True))
        if sp.initializer is not None:
            sp.initializer(sp, startup_block)
        # main program: the parameter itself
        p = main_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        if getattr(attr, "mesh_axes", None):
            p.mesh_axes = tuple(attr.mesh_axes)
            sp.mesh_axes = tuple(attr.mesh_axes)
        return p

    def _create_weight_normalized(self, attr, shape, dtype):
        """w = g * v / ||v||: parameters v (the user's initializer) and g
        ([shape[dim]], or [1] for dim=None), g set to ||v|| by a wn_norm
        op in the startup program, and w a derived main-program variable
        written by one weight_norm op."""
        from .initializer import ConstantInitializer
        from .param_attr import WeightNormParamAttr
        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            existing = main_block.var(attr.name)   # shared, like a param
            if existing.shape is not None and \
                    tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    "weight-norm parameter %r reused with shape %s but was "
                    "created with shape %s"
                    % (attr.name, shape, existing.shape))
            return existing
        dim = attr.dim
        base = dict(learning_rate=attr.learning_rate,
                    regularizer=attr.regularizer, trainable=attr.trainable,
                    gradient_clip=attr.gradient_clip)
        v = self.create_parameter(
            ParamAttr(name=attr.name + ".wn_v", initializer=attr.initializer,
                      **base), shape=shape, dtype=dtype)
        g = self.create_parameter(
            ParamAttr(name=attr.name + ".wn_g",
                      initializer=ConstantInitializer(1.0), **base),
            shape=[shape[dim]] if dim is not None else [1], dtype=dtype)
        self.startup_program.global_block().append_op(
            type="wn_norm", inputs={"X": [v.name]},
            outputs={"Out": [g.name]}, attrs={"dim": dim},
            infer_shape=False)
        w = main_block.create_var(name=attr.name, dtype=dtype)
        w.shape = tuple(shape)
        main_block.append_op(
            type="weight_norm", inputs={"G": [g], "V": [v]},
            outputs={"Out": [w]}, attrs={"dim": dim})
        WeightNormParamAttr.params_with_weight_norm.append(w)
        return w

    def create_variable_for_type_inference(self, dtype=None,
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    # reference name
    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        gb = self.main_program.global_block()
        if not gb.has_var(name):
            return self.create_global_variable(name=name, *args, **kwargs)
        return gb.var(name)

    def set_variable_initializer(self, var, initializer):
        """Declare `var` in the startup program and append its init op
        there (optimizer accumulators, step counters, global vars)."""
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)
        return sv

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act)
        return tmp
