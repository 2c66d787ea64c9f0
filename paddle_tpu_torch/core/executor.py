"""Executor + Scope.

Parity: python/paddle/fluid/executor.py, paddle/fluid/framework/
{executor.cc,scope.cc} and the JAX package's core/executor.py. Same
`Executor(place).run(program, feed, fetch_list)` surface; a run walks the
Program op by op (core/lowering.py) on one torch device. The device is
the card unless the caller asks for the CPU: with no card and no explicit
`"cpu"`, construction raises — nothing falls back to the CPU silently.
"""
import numpy as np
import torch

from .framework import convert_dtype, default_main_program, find_var
from .lod import LoDTensor
from .lowering import Env, LowerCtx, lower_block, unread_outputs
from .registry import torch_dtype


def resolve_device(device=None):
    """The torch device an entry point runs on: `device` when given
    ("cuda", "cuda:1", "cpu", a torch.device), else the current CUDA
    device. Raises when a CUDA device is asked for (explicitly or by
    default) and none is available."""
    if device is None:
        device = "cuda"
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


class Scope(object):
    """Name -> torch tensor store (parity: framework::Scope)."""

    def __init__(self):
        self._vars = {}
        self._rng_counter = 0

    def set(self, name, value):
        self._vars[name] = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))

    def get(self, name):
        return self._vars.get(name)

    def has(self, name):
        return name in self._vars

    def names(self):
        return list(self._vars)

    def next_seed(self):
        self._rng_counter += 1
        return self._rng_counter


_global_scope = Scope()


def global_scope():
    return _global_scope


class Executor(object):
    """Runs Programs on one device. `place`: "cuda" (default), "cuda:N",
    "cpu" or a torch.device."""

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
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches
