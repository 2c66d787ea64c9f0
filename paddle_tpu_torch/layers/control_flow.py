"""Control-flow layers: StaticRNN, DynamicRNN, the compare layers and the
scalar conditional blocks (ConditionalBlock, Switch).

Parity: python/paddle/fluid/layers/control_flow.py and the JAX package's
layers/control_flow.py — the same graph-building API (a step sub-block
under a BlockGuard, step inputs, memories, outputs) emitting the same ONE
`rnn_scan` op in the parent block, so both packages build the same Program.
The op runs its step block once per time step (ops/control_ops.py). A
Switch case is a conditional_block op over a sub-block, run on the device
with no host sync (ops/control_ops.py).

While, IfElse (ROADMAP A6), tensor arrays, rank tables and beam search are
not ported yet: they come with the beam-search decode path. increment,
is_empty and Print are the scalar helpers of the same module.
"""
from ..core import unique_name
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper

__all__ = ["StaticRNN", "DynamicRNN", "BlockGuard", "ConditionalBlock",
           "ConditionalBlockGuard", "Switch", "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal",
           "increment", "is_empty", "Print"]


class BlockGuard(object):
    """Enter a new sub-block of `program`; pop back on exit.

    Parity: control_flow.py BlockGuard."""

    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.block = self.program.create_block()
        return self.block

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.program.rollback()
        return False


def _nested_blocks(block):
    """`block` and every block nested under it."""
    blocks = [block]
    for b in block.program.blocks:
        if any(b.parent_idx == p.idx for p in blocks):
            blocks.append(b)
    return blocks


def _written_names(block):
    """Names written by `block`'s ops (including nested sub-blocks)."""
    names = set()
    for b in _nested_blocks(block):
        for op in b.ops:
            names.update(n for n in op.all_output_vars() if n)
    return names


def _read_names(block):
    """Names read (in order, deduped) by `block`'s ops incl. nested blocks."""
    seen, order = set(), []
    for b in _nested_blocks(block):
        for op in b.ops:
            for n in op.all_input_vars():
                if n and n not in seen:
                    seen.add(n)
                    order.append(n)
    return order


class _RNNBase(object):
    """Shared machinery: records a step sub-block and its links, then emits
    one `rnn_scan` op in the parent block."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, layer_type, name=None):
        self.helper = LayerHelper(layer_type, name=name)
        self.status = self.BEFORE_RNN_BLOCK
        self._step_inputs = []    # (outer Variable, inner placeholder)
        self._memories = []       # dict(boot, pre, update)
        self._outputs = []        # (inner Variable, outer Variable)
        self._step_block = None
        self._seq_var = None      # first sequence step input (for SeqLen)
        self._masked = True

    # -- block guard --------------------------------------------------------
    def _assert_in_rnn_block(self, method):
        if self.status != self.IN_RNN_BLOCK:
            raise ValueError("you must invoke %s inside rnn block" % method)

    def step(self):
        return _RNNGuard(self)

    block = step  # DynamicRNN spells it block()

    # -- step API -----------------------------------------------------------
    def step_input(self, x, level=0):
        self._assert_in_rnn_block("step_input")
        if not isinstance(x, Variable):
            raise TypeError("step_input takes a Variable")
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("step input must be a [batch, time, ...] tensor")
        if self._seq_var is None and x.seq_len_var is not None:
            self._seq_var = x
        inner = self._step_block.create_var(
            name=unique_name.generate(self.helper.name + ".in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append((x, inner))
        return inner

    def static_input(self, x):
        self._assert_in_rnn_block("static_input")
        # statics are closed over by name: the step block reads the outer
        # var, and the rnn_scan op lists it among its Static inputs
        return x

    def memory(self, init=None, shape=None, value=0.0, init_value=0.0,
               batch_ref=None, need_reorder=False, dtype="float32",
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block("memory")
        program = self.helper.main_program
        parent_block = program.blocks[self._step_block.parent_idx]
        if init is None:
            ref = batch_ref if batch_ref is not None else (
                self._step_inputs[0][0] if self._step_inputs else None)
            if shape is None or ref is None:
                raise ValueError("memory without init needs shape and a "
                                 "step_input (or batch_ref) for the batch dim")
            boot = parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".mem_boot"),
                shape=[-1] + list(shape), dtype=dtype)
            parent_block.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]},
                outputs={"Out": [boot]},
                attrs={"value": float(value or init_value),
                       "shape": [-1] + list(shape), "dtype": dtype,
                       "input_dim_idx": 0, "output_dim_idx": 0},
                infer_shape=False)
            return self.memory(init=boot)
        pre = self._step_block.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            shape=init.shape, dtype=init.dtype)
        self._memories.append({"boot": init, "pre": pre, "update": None})
        return pre

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block("update_memory")
        for m in self._memories:
            if m["pre"] is ex_mem or m["pre"].name == ex_mem.name:
                m["update"] = new_mem
                return
        raise ValueError("update_memory: %r is not a memory of this RNN"
                         % ex_mem.name)

    def output(self, *outputs):
        self._assert_in_rnn_block("output")
        program = self.helper.main_program
        parent_block = program.blocks[self._step_block.parent_idx]
        for o in outputs:
            outer = parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".out"),
                dtype=o.dtype)
            if self._seq_var is not None:
                outer.lod_level = max(self._seq_var.lod_level, 1)
                outer.seq_len_var = self._seq_var.seq_len_var
            self._outputs.append((o, outer))

    step_output = output

    def __call__(self, *args, **kwargs):
        if self.status != self.AFTER_RNN_BLOCK:
            raise ValueError("rnn output accessible only after the rnn block")
        outs = [outer for _, outer in self._outputs]
        return outs[0] if len(outs) == 1 else outs

    # -- completion ---------------------------------------------------------
    def _complete(self):
        program = self.helper.main_program
        step_block = self._step_block
        parent_block = program.blocks[step_block.parent_idx]
        if not self._step_inputs:
            raise ValueError("RNN needs at least one step_input")
        for m in self._memories:
            if m["update"] is None:
                raise ValueError("memory %r never update_memory'd"
                                 % m["pre"].name)

        in_names = [inner.name for _, inner in self._step_inputs]
        pre_names = [m["pre"].name for m in self._memories]
        written = _written_names(step_block)
        placeholder = set(in_names) | set(pre_names)
        static_names = [
            n for n in _read_names(step_block)
            if n not in written and n not in placeholder
            and not step_block.has_var(n)
            and parent_block.has_var_recursive(n)]

        inputs = {"X": [x.name for x, _ in self._step_inputs],
                  "Boot": [m["boot"].name for m in self._memories],
                  "Static": static_names}
        if self._masked and self._seq_var is not None:
            inputs["SeqLen"] = [self._seq_var.seq_len_var]

        last_mems = []
        for m in self._memories:
            lm = parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".last_mem"),
                dtype=m["boot"].dtype)
            last_mems.append(lm)
        self.final_memories = last_mems

        parent_block.append_op(
            type="rnn_scan",
            inputs=inputs,
            outputs={"Out": [outer for _, outer in self._outputs],
                     "LastMem": last_mems},
            attrs={"sub_block": step_block.idx,
                   "in_names": in_names,
                   "static_names": static_names,
                   "pre_names": pre_names,
                   "update_names": [m["update"].name for m in self._memories],
                   "out_names": [o.name for o, _ in self._outputs],
                   "max_len": None})


class _RNNGuard(BlockGuard):
    def __init__(self, rnn):
        super(_RNNGuard, self).__init__(rnn.helper.main_program)
        self.rnn = rnn

    def __enter__(self):
        self.rnn.status = self.rnn.IN_RNN_BLOCK
        blk = super(_RNNGuard, self).__enter__()
        self.rnn._step_block = blk
        return blk

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.rnn.status = self.rnn.AFTER_RNN_BLOCK
        self.rnn._complete()
        return super(_RNNGuard, self).__exit__(exc_type, exc_val, exc_tb)


class StaticRNN(_RNNBase):
    """Fixed-length RNN over [batch, time, ...] inputs (no length masking).

    Parity: control_flow.py StaticRNN / recurrent_op.cc. One rnn_scan op;
    backpropagation through time comes from autograd through its steps."""

    def __init__(self, name=None):
        super(StaticRNN, self).__init__("static_rnn", name)
        self._masked = False


class DynamicRNN(_RNNBase):
    """Variable-length RNN over padded sequences: memories freeze and
    outputs zero past each row's true length.

    Parity: control_flow.py DynamicRNN (which expands to lod_rank_table +
    lod_tensor_to_array + While + shrink_memory in the reference). Here, as
    in the JAX package, it is one masked rnn_scan op: the same math over
    the padded batch, no sorting or shrinking of rows."""

    def __init__(self, name=None):
        super(DynamicRNN, self).__init__("dynamic_rnn", name)

    def step_input(self, x, level=0):
        if x.seq_len_var is None:
            raise ValueError(
                "DynamicRNN.step_input needs a sequence (lod_level>0) input")
        return super(DynamicRNN, self).step_input(x, level)


# ------------------------------------------------------------ compare --

def _compare(op_type):
    def fn(x, y, cond=None, **ignored):
        helper = LayerHelper(op_type, x=x, y=y)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
            cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond
    fn.__name__ = op_type
    return fn


less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")
equal = _compare("equal")
not_equal = _compare("not_equal")


# ------------------------------------------------------------- Switch --

class ConditionalBlock(object):
    """Scalar-condition conditional block (the building block of Switch).

    Parity: control_flow.py ConditionalBlock / conditional_block_op.cc.
    The op lists the out vars' previous values as OutPrev inputs too, so
    a persistable one reads its value from the Scope. Only the scalar
    form runs in this port; the IfElse form (is_scalar_condition=False)
    builds and raises when run (ROADMAP A6)."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    def block(self):
        return ConditionalBlockGuard(self)

    def complete(self):
        program = self.helper.main_program
        inside_block = program.current_block()
        parent_block = program.blocks[inside_block.parent_idx]
        out_names = [n for n in sorted(_written_names(inside_block))
                     if not inside_block.has_var(n)
                     and parent_block.has_var_recursive(n)]
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [v.name for v in self.inputs],
                    "OutPrev": out_names},
            outputs={"Out": out_names},
            attrs={"sub_block": inside_block.idx,
                   "out_names": out_names,
                   "is_scalar_condition": self.is_scalar_condition},
            infer_shape=False)


class ConditionalBlockGuard(BlockGuard):
    def __init__(self, cond_block):
        super(ConditionalBlockGuard, self).__init__(
            cond_block.helper.main_program)
        self.cond_block = cond_block

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None:
            self.cond_block.complete()
        return super(ConditionalBlockGuard, self).__exit__(
            exc_type, exc_val, exc_tb)


class Switch(object):
    """switch { case(cond): ... default: ... }: the first matching case
    wins.

    Parity: control_flow.py `Switch` (the LR schedules use it). Each case
    is a conditional_block guarded by cond_i AND NOT(any earlier cond)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_taken = None  # Variable: no earlier case matched

    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case should be called inside with")
        from . import ops
        if self.pre_not_taken is None:
            eff = condition
            self.pre_not_taken = ops.logical_not(x=condition)
        else:
            eff = ops.logical_and(x=self.pre_not_taken, y=condition)
            self.pre_not_taken = ops.logical_and(
                x=self.pre_not_taken, y=ops.logical_not(x=condition))
        return ConditionalBlock([eff], is_scalar_condition=True).block()

    def default(self):
        if self.pre_not_taken is None:
            raise ValueError("there should be at least one case before "
                             "default")
        return ConditionalBlock([self.pre_not_taken],
                                is_scalar_condition=True).block()

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        return False


def increment(x, value=1.0, in_place=True):
    """x + value, written back into x unless in_place=False."""
    helper = LayerHelper("increment", **locals())
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)},
                     infer_shape=False)
    return out


def is_empty(x, cond=None, **ignored):
    """A bool: whether x holds no element."""
    helper = LayerHelper("is_empty", x=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]}, infer_shape=False)
    return cond


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """The input through an identity `print` op that prints `message` and
    the value each time it runs (ops/basic.py); gradients pass through.
    Returns the op's output, so the print stays live in the graph."""
    helper = LayerHelper("print", name=None)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="print", inputs={"In": [input]}, outputs={"Out": [out]},
        attrs={"first_n": int(first_n), "message": message or "",
               "summarize": int(summarize),
               "print_tensor_name": bool(print_tensor_name),
               "print_tensor_type": bool(print_tensor_type),
               "print_tensor_shape": bool(print_tensor_shape),
               "print_phase": str(print_phase),
               "var_name": input.name})
    if input.shape is not None:
        out.shape = tuple(input.shape)
    return out
