"""Executor + Scope.

Parity: python/paddle/fluid/executor.py, paddle/fluid/framework/
{executor.cc,scope.cc} and the JAX package's core/executor.py. Same
`Executor(place).run(program, feed, fetch_list)` surface; a run walks the
Program op by op (core/lowering.py) on one torch device. The device is
the card unless the caller asks for the CPU (`"cpu"` or `CPUPlace()`):
with no card, construction raises — nothing falls back to the CPU
silently. Scopes nest as the JAX package's do (`new_scope`, parent
lookup, `drop_kids`); `scope_guard` / `switch_scope` swap the global
scope that runs and `fetch_var` read by default.
"""
import contextlib

import numpy as np
import torch

from .framework import convert_dtype, default_main_program, find_var
from .lod import LoDTensor
from .lowering import Env, LowerCtx, lower_block, unread_outputs
from .registry import torch_dtype


def resolve_device(device=None):
    """The torch device an entry point runs on: `device` when given
    ("cuda", "cuda:1", "cpu", a torch.device, or a Place: CPUPlace() the
    CPU, CUDAPlace(i) and TPUPlace(i) card i), else the current CUDA
    device. Raises when a CUDA device is asked for (explicitly or by
    default) and none is available."""
    from ..places import Place
    if device is None:
        device = "cuda"
    if isinstance(device, Place):
        device = device.torch_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device unless asked "
                "otherwise, and torch.cuda.is_available() is False here; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (use 'cuda' or 'cpu')"
                         % (device,))
    return dev


def to_tensor(value, dtype=None, device=None):
    """Host array / tensor -> torch tensor of the declared dtype on
    `device` (the feed and parameter-load conversion)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(convert_dtype(dtype), copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(torch_dtype(convert_dtype(dtype)))
    if device is not None:
        t = t.to(device)
    return t


def to_numpy(t):
    """A tensor as a host numpy array. numpy has no bfloat16: a bf16
    tensor (a mixed-precision activation) comes back as float32, which
    holds every bf16 value exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def convert_feeds(program, feed):
    """Expand a feed dict (parity: the JAX package's
    core/executor.convert_feeds): a LoDTensor becomes its zero-padded
    [num_seqs, max_len, ...] data plus `name@SEQLEN` int32 lengths; a
    sequence var (lod_level > 0) fed any other way needs a padded array
    of its declared rank AND its `@SEQLEN` lengths in the same feed."""
    out = {}
    for name, value in feed.items():
        var = find_var(program, name)
        if isinstance(value, LoDTensor):
            out[name], out[name + "@SEQLEN"] = value.to_padded()
            continue
        if var is not None and var.lod_level > 0:
            try:  # ragged python lists make np.ndim itself raise
                ndim = np.ndim(value)
            except ValueError:
                ndim = -1
            if ndim != len(var.shape or ()) or \
                    name + "@SEQLEN" not in feed:
                raise TypeError(
                    "variable %r is a sequence (lod_level=%d): feed a "
                    "LoDTensor (fluid.create_lod_tensor / "
                    "LoDTensor.from_sequences), or a padded [num_seqs, "
                    "max_len, ...] array plus %r lengths" %
                    (name, var.lod_level, name + "@SEQLEN"))
        out[name] = value
    return out


class _ScopeVar(object):
    """A named slot of a Scope (parity: framework::Variable as the
    reference's scope.find_var / scope.var return it)."""

    def __init__(self, scope, name):
        self.scope = scope
        self.name = name

    def get_tensor(self):
        return self.scope._vars.get(self.name)

    def set(self, value, place=None):
        self.scope.set(self.name, value)


class Scope(object):
    """Name -> torch tensor store (parity: framework::Scope, with the
    kid-scope tree: new_scope, lookup through the parents, drop_kids)."""

    def __init__(self, parent=None):
        self._vars = {}
        self._rng_counter = 0
        self._parent = parent
        self._kids = []

    def new_scope(self):
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def parent(self):
        return self._parent

    def drop_kids(self):
        self._kids = []

    def set(self, name, value):
        self._vars[name] = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))

    def get(self, name):
        if name in self._vars:
            return self._vars[name]
        return self._parent.get(name) if self._parent is not None else None

    def has(self, name):
        return name in self._vars or (
            self._parent is not None and self._parent.has(name))

    def find_var(self, name):
        """This scope's slot `name`, else the nearest parent's, else None
        (parity: Scope::FindVar)."""
        if name in self._vars:
            return _ScopeVar(self, name)
        return self._parent.find_var(name) if self._parent is not None \
            else None

    def var(self, name):
        """This scope's slot `name`, created empty if missing."""
        self._vars.setdefault(name, None)
        return _ScopeVar(self, name)

    def names(self):
        return list(self._vars)

    def next_seed(self):
        self._rng_counter += 1
        return self._rng_counter


_global_scope = Scope()


def global_scope():
    return _global_scope


def switch_scope(scope):
    """Make `scope` the global scope, returning the previous one (parity:
    fluid.executor.switch_scope)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old


@contextlib.contextmanager
def scope_guard(scope):
    """The global scope is `scope` inside the block (parity:
    fluid.executor.scope_guard)."""
    old = switch_scope(scope)
    try:
        yield
    finally:
        switch_scope(old)


def fetch_var(name, scope=None, return_numpy=True):
    """A variable's value from `scope` (default: the global scope), as
    numpy or as the tensor (parity: fluid.executor.fetch_var)."""
    if scope is None:
        scope = _global_scope
    v = scope.find_var(name)
    if v is None or v.get_tensor() is None:
        raise RuntimeError(
            "cannot find variable %r in the scope; only persistable vars "
            "survive Executor.run (set persistable=True or fetch it in "
            "fetch_list)" % name)
    val = v.get_tensor()
    return to_numpy(val) if return_numpy else val


class Executor(object):
    """Runs Programs on one device. `place`: "cuda" (default), "cuda:N",
    "cpu", a torch.device or a Place (CPUPlace, CUDAPlace, TPUPlace)."""

    def __init__(self, place=None):
        self.device = resolve_device(place)
        # (program uid, program version, fetch names) -> the global-block
        # outputs nothing reads in such a run (lowering.unread_outputs)
        self._unread = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run `program` once: feeds convert to their declared dtypes on
        this executor's device (a LoDTensor feed expands as in
        `convert_feeds`), parameters read from `scope`, every
        persistable the program writes is stored back into `scope`.
        Returns the fetches as numpy arrays, or as device tensors with
        return_numpy=False (no host sync)."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        persistable = {v.name for v in program.list_vars() if v.persistable}
        env = Env(scope, persistable, self.device)
        for name, value in convert_feeds(program, feed).items():
            var = find_var(program, name)
            env.write(name, to_tensor(
                value, var.dtype if var is not None else None, self.device))
        key = (program._uid, program._version, tuple(fetch_names))
        if key not in self._unread:
            self._unread[key] = unread_outputs(program, fetch_names)
        ctx = LowerCtx(program, self.device, run_seed=scope.next_seed(),
                       unread=self._unread[key])
        with torch.no_grad():
            lower_block(ctx, program.global_block(), env)
        for op in program.global_block().ops:
            for name in op.all_output_vars():
                if name in persistable:
                    scope.set(name, env.values[name])
        fetches = [env.read(n) for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
