"""Graph IR: Program / Block / Operator / Variable / Parameter.

Parity: python/paddle/fluid/framework.py and paddle/fluid/framework/{program_desc,
block_desc,op_desc,var_desc}.{cc,h} in the reference, and the JAX package's
core/framework.py, whose IR this module copies so that programs built or
saved by either package load in the other. Same define-then-run model:
layer functions append Operators to the current Block of the default
Program; an Executor later runs the Program (here: op by op over torch
tensors, see core/lowering.py).
"""
import contextlib
import copy
import itertools

import numpy as np

from . import unique_name

GRAD_SUFFIX = "@GRAD"

_dtype_aliases = {
    "float32": "float32",
    "float64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "bool": "bool",
}


def convert_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, str):
        key = dtype.lower()
    else:
        key = np.dtype(dtype).name
    if key not in _dtype_aliases:
        raise ValueError("unsupported dtype: %s" % dtype)
    return _dtype_aliases[key]


def grad_var_name(name):
    return name + GRAD_SUFFIX


class Variable(object):
    """A named tensor in a Block.

    Parity: fluid.framework.Variable. Carries static shape (-1 = dynamic batch
    dim), dtype string, lod_level, persistable (lives in the Scope across
    runs) and stop_gradient flags.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, initializer=None, type=None, capacity=None):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        self.error_clip = None  # BaseErrorClipAttr; read by append_backward
        # name of the int32 [num_seqs] companion tensor holding true sequence
        # lengths; set for lod_level>0 vars
        self.seq_len_var = None
        # type: None (dense tensor) | 'tensor_array' | 'rank_table'
        self.type = type
        self.capacity = capacity
        self.op = None  # producer op, set by append_op

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s, lod=%d%s)" % (
            self.name, self.shape, self.dtype, self.lod_level,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """Trainable persistable Variable.

    Parity: fluid.framework.Parameter — carries optimize/regularizer/clip attrs.
    """

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        kwargs.setdefault("persistable", True)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.stop_gradient = False


class Operator(object):
    """A node in the op graph.

    Parity: fluid.framework.Operator / op_desc.cc. inputs/outputs map slot
    names to lists of Variable *names* (string refs into the Block), matching
    the reference's OpDesc. attrs are plain Python values.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        # Stable, PROGRAM-local op identity: salts the per-op random
        # generator (core/lowering.LowerCtx.rng), so a given program draws
        # the same random inits no matter what other programs exist.
        self.uid = block.program._next_op_uid()
        self.inputs = {}   # slot -> [var name]
        self.outputs = {}  # slot -> [var name]
        self.attrs = dict(attrs) if attrs else {}
        if inputs:
            for slot, vs in inputs.items():
                self.inputs[slot] = [v.name if isinstance(v, Variable) else v
                                     for v in _as_list(vs)]
        if outputs:
            for slot, vs in outputs.items():
                self.outputs[slot] = [v.name if isinstance(v, Variable) else v
                                      for v in _as_list(vs)]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_names(self):
        return list(self.inputs)

    @property
    def output_names(self):
        return list(self.outputs)

    def all_input_vars(self):
        return [n for vs in self.inputs.values() for n in vs]

    def all_output_vars(self):
        return [n for vs in self.outputs.values() for n in vs]

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def __repr__(self):
        ins = ", ".join("%s=%s" % (k, v) for k, v in self.inputs.items())
        outs = ", ".join("%s=%s" % (k, v) for k, v in self.outputs.items())
        return "{%s} = %s(%s) attrs=%s" % (outs, self.type, ins, self.attrs)


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Block(object):
    """A sequence of Operators plus a symbol table of Variables.

    Parity: fluid.framework.Block / block_desc.cc, including parent-block
    variable lookup for sub-blocks of control-flow ops.
    """

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, shape, dtype, name=None, **kwargs):
        if name is None:
            name = unique_name.generate("_param")
        p = Parameter(self, shape=shape, dtype=dtype, name=name, **kwargs)
        self.vars[name] = p
        self.program._bump_version()
        return p

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent_block
        return False

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise ValueError("Variable %r not found (searched up from block %d)"
                         % (name, self.idx))

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # ops whose outputs are per-sequence (not per-timestep): do not inherit lod
    _LOD_CLEARING_OPS = frozenset([
        "sequence_pool", "sequence_last_step", "sequence_first_step",
        "reduce_sum", "reduce_mean", "mean", "cross_entropy", "topk",
        "accuracy", "lod_tensor_to_array",
    ])

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        out_vars = []
        for vs in (outputs or {}).values():
            for v in _as_list(vs):
                if isinstance(v, Variable):
                    v.op = op
                    out_vars.append(v)
        # propagate sequence structure: timestep-preserving ops hand their
        # first sequence-input's lod/lengths to outputs
        if type not in Block._LOD_CLEARING_OPS:
            for vs in (inputs or {}).values():
                src = next((v for v in _as_list(vs) if isinstance(v, Variable)
                            and v.lod_level > 0), None)
                if src is not None:
                    for ov in out_vars:
                        if ov.lod_level == 0:
                            ov.lod_level = src.lod_level
                            ov.seq_len_var = src.seq_len_var
                    break
        self.program._bump_version()
        if infer_shape:
            from . import registry
            registry.infer_and_set_shapes(self, op)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None,
                   infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        if infer_shape:
            from . import registry
            registry.infer_and_set_shapes(self, op)
        return op

    def __repr__(self):
        lines = ["block %d (parent %d):" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program(object):
    """A list of Blocks; block 0 is the global block.

    Parity: fluid.framework.Program / program_desc.cc. `_version` is bumped on
    every mutation.
    """

    _uid_counter = itertools.count(1)

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self.random_seed = 0
        self._op_uid_counter = 0
        self._amp = False  # bf16 mixed precision flag (kept for the desc)
        # accumulator-var -> param-name map (optimizers; kept for the desc)
        self._accumulator_owner = {}
        # process-unique identity (id() of a collected program is recycled)
        self._uid = next(Program._uid_counter)

    def _next_op_uid(self):
        self._op_uid_counter += 1
        return self._op_uid_counter

    def _bump_version(self):
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        """Append a sub-block (a control-flow op's body) whose parent is
        the current block, or `parent_idx`, and make it current."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx
        self._bump_version()

    def block(self, index):
        return self.blocks[index]

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    # ---- clone / prune (parity: Program.clone, Program.prune) --------
    def clone(self, for_test=False):
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)  # a clone is a distinct program
        if for_test:
            p._set_test_mode()
        return p

    def _set_test_mode(self):
        for blk in self.blocks:
            for op in blk.ops:
                if "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    op.attrs["is_test"] = True

    def prune(self, targets, for_test=False):
        """Return a copy containing only the ops/vars the targets depend on
        (parity: fluid.framework.Program.prune) — the inference-serving
        subgraph. Sub-blocks of kept control-flow ops survive intact;
        orphaned sub-blocks are emptied (block indices stay stable)."""
        p = self.clone(for_test=for_test)
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        needed = set()
        for t in targets:
            name = t.name if isinstance(t, Variable) else t
            needed.add(name)
            v = p.global_block().vars.get(name)
            if v is not None and getattr(v, "seq_len_var", None):
                needed.add(v.seq_len_var)

        def op_reads(op):
            names = [n for ns in op.inputs.values() for n in ns if n]
            for idx in _sub_block_indices(op):
                for sop in p.blocks[idx].ops:
                    names.extend(op_reads(sop))
            return names

        kept = []
        for op in reversed(p.global_block().ops):
            if any(n in needed
                   for ns in op.outputs.values() for n in ns if n):
                kept.append(op)
                needed.update(op_reads(op))
        kept.reverse()
        p.global_block().ops = kept

        reachable = {0}
        frontier = list(kept)
        while frontier:
            op = frontier.pop()
            for idx in _sub_block_indices(op):
                if idx not in reachable:
                    reachable.add(idx)
                    frontier.extend(p.blocks[idx].ops)
        for blk in p.blocks:
            if blk.idx not in reachable:
                blk.ops = []
                blk.vars = {}

        used = set(needed)
        for op in kept:
            for ns in op.outputs.values():
                used.update(n for n in ns if n)
        blk = p.global_block()
        blk.vars = {k: v for k, v in blk.vars.items() if k in used}
        p._bump_version()
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(repr(b) for b in self.blocks)

    __repr__ = to_string
    __str__ = to_string


def _sub_block_indices(op):
    """Block indices an op's attrs reference (sub_block is the convention)."""
    out = []
    for key, val in op.attrs.items():
        if key.endswith("sub_block") and isinstance(val, int):
            out.append(val)
        elif key == "fwd_attrs" and isinstance(val, dict) \
                and isinstance(val.get("sub_block"), int):
            out.append(val["sub_block"])
    return out


# ops that behave differently at inference time
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "nce": ("is_test",),
}

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def find_var(program, name):
    """Look a var up across all blocks of a program (None if absent)."""
    for block in program.blocks:
        if name in block.vars:
            return block.vars[name]
    return None
