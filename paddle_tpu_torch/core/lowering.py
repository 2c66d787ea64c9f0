"""Program interpreter: runs a Block op by op over torch tensors.

Parity: the reference's op-by-op interpreter (paddle/fluid/framework/
executor.cc: Executor::RunPreparedContext walks the BlockDesc and launches
a kernel per OpDesc). The JAX package traces the whole Program into one XLA
computation instead (its core/lowering.py); PyTorch runs eagerly, so here
each op's rule is called in program order and its outputs land in an Env —
the same names, the same rules, no trace. Inference needs no gradient
machinery, remat or multi-step loop, so none of those exist here yet.
"""
import torch

from . import registry


class LowerCtx(object):
    """Per-run context handed to op rules: the run's device and a seeded
    random generator per op."""

    is_abstract = False

    def __init__(self, program, device, run_seed=0, is_startup=False):
        self.program = program
        self.device = device
        self.run_seed = int(run_seed)
        self.is_startup = is_startup
        self._op_salt = 0
        self._op_calls = 0

    def begin_op(self, salt):
        self._op_salt = salt
        self._op_calls = 0

    def rng(self, salt=0, seed=0):
        """A torch.Generator on the run's device, seeded from (program
        seed, run seed, op uid, call index within the op). A nonzero user
        `seed` (the op's seed attr — fluid's reproducibility contract)
        pins the stream independent of the run counter. The streams are
        the port's own: they do not reproduce the JAX package's bits."""
        self._op_calls += 1
        if seed:
            base = int(seed)
        else:
            base = int(getattr(self.program, "random_seed", 0) or 0) \
                * 1000003 + self.run_seed
        g = torch.Generator(device=self.device)
        g.manual_seed((base * 1000003 + self._op_salt * 97
                       + self._op_calls * 7 + salt) & 0x7FFFFFFFFFFFFFFF)
        return g


class EnvReadError(KeyError):
    """Env.read miss: a variable read before anything wrote it."""


class Env(object):
    """Name -> tensor mapping for one run. A persistable var that no op of
    this run has written yet reads through to the Scope (parameters), moved
    to the run's device."""

    def __init__(self, scope=None, persistable=(), device=None):
        self.values = {}
        self._scope = scope
        self._persistable = persistable
        self._device = device

    def read(self, name):
        if name in self.values:
            return self.values[name]
        if self._scope is not None and name in self._persistable:
            v = self._scope.get(name)
            if v is not None:
                v = v.to(self._device)
                self.values[name] = v
                return v
        raise EnvReadError("variable %r read before it was written; "
                           "is it fed / initialized?" % name)

    def write(self, name, value):
        self.values[name] = value


def lower_block(ctx, block, env):
    for op in block.ops:
        lower_op(ctx, op, env)


def lower_op(ctx, op, env):
    try:
        _lower_op_inner(ctx, op, env)
    except EnvReadError as e:
        raise RuntimeError("%s\n  [while running op %r (uid %d)]"
                           % (e.args[0], op.type, op.uid)) from e
    except Exception as e:
        if e.args and isinstance(e.args[0], str):
            e.args = (e.args[0] + "\n  [while running op %r (uid %d)]"
                      % (op.type, op.uid),) + e.args[1:]
        raise


def _lower_op_inner(ctx, op, env):
    od = registry.get(op.type)
    ins = {slot: [env.read(n) for n in names]
           for slot, names in op.inputs.items()}
    ctx.begin_op(op.uid)
    outs = od.lower(ctx, ins, op.attrs)
    _write_outputs(op, outs, env)


def _write_outputs(op, outs, env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if name:
                env.write(name, val)
