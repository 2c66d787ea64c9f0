"""Model persistence: parameters and inference models.

Parity: python/paddle/fluid/io.py and the JAX package's io.py — the same
on-disk format, so each package loads the other's saved models: a
directory of .npy files (one per var) plus a JSON manifest, and for an
inference model the versioned JSON program desc (`__model__`,
core/program_desc.py) and `__model_meta__.json` naming feeds and fetches.
Each function takes the Scope it reads or fills (default: the global
scope).
"""
import json
import os

import numpy as np

from .core import program_desc as _program_desc
from .core.executor import Scope, global_scope, to_tensor
from .core.framework import Parameter, Variable, default_main_program

__all__ = ["save_vars", "save_params", "load_vars", "load_params",
           "save_inference_model", "load_inference_model",
           "scope_from_numpy"]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _var_list(main_program, predicate, vars):
    if main_program is None:
        main_program = default_main_program()
    if vars is not None:
        return [v if isinstance(v, Variable) else
                main_program.global_block().var(v) for v in vars]
    return [v for v in main_program.list_vars() if predicate(v)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, scope=None):
    """Write `vars` (or the program's vars matching `predicate`, default
    persistables) as .npy files + a manifest. A var with no value in the
    scope raises: the file set would silently omit it. Everything is
    checked before the first byte is written."""
    scope = scope if scope is not None else global_scope()
    to_write = []
    for v in _var_list(main_program, predicate or is_persistable, vars):
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError(
                "save_vars: variable %r has no value in the scope; run the "
                "startup program first" % v.name)
        to_write.append((v, val))
    os.makedirs(dirname, exist_ok=True)
    manifest = {}
    for v, val in to_write:
        arr = val.detach().cpu().numpy()
        safe = v.name.replace("/", "__")
        np.save(os.path.join(dirname, safe + ".npy"), arr)
        manifest[v.name] = {"file": safe + ".npy", "shape": list(arr.shape),
                            "dtype": str(arr.dtype),
                            "is_param": is_parameter(v)}
    with open(os.path.join(dirname, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def save_params(executor, dirname, main_program=None, vars=None,
                scope=None):
    save_vars(executor, dirname, main_program, vars, is_parameter,
              scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, scope=None, params_only=False):
    """Restore vars from a save_vars directory onto the executor's device.
    A requested var the manifest does not carry raises (it would silently
    keep its init value)."""
    scope = scope if scope is not None else global_scope()
    with open(os.path.join(dirname, "manifest.json")) as f:
        manifest = json.load(f)
    want = None
    if vars is not None or main_program is not None:
        want = set(v.name for v in
                   _var_list(main_program, predicate or is_persistable, vars))
        absent = sorted(want - set(manifest))
        if absent:
            raise RuntimeError(
                "load_vars: %d requested variable(s) are not in the manifest "
                "at %r: %s" % (len(absent), dirname, absent))
    for name, meta in manifest.items():
        if want is not None and name not in want:
            continue
        if params_only and want is None and not meta.get("is_param", True):
            continue
        arr = np.load(os.path.join(dirname, meta["file"]))
        scope.set(name, to_tensor(arr, device=executor.device))


def load_params(executor, dirname, main_program=None, scope=None):
    load_vars(executor, dirname, main_program, None, is_parameter,
              scope=scope, params_only=True)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None, scope=None):
    """Prune `main_program` to the subgraph the targets need (for_test),
    and store the program desc, the feed/fetch names and the parameters
    the pruned program reads. Returns the pruned program."""
    if main_program is None:
        main_program = default_main_program()
    target_names = [v if isinstance(v, str) else v.name for v in target_vars]
    inference_program = main_program.prune(target_names, for_test=True)
    os.makedirs(dirname, exist_ok=True)
    meta = {"feed": list(feeded_var_names), "fetch": target_names}
    with open(os.path.join(dirname, "__model_meta__.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(dirname, model_filename or "__model__"), "wb") as f:
        f.write(_program_desc.program_to_bytes(inference_program))
    save_params(executor, dirname, inference_program, scope=scope)
    return inference_program


def load_inference_model(dirname, executor, model_filename=None, scope=None):
    """Load a save_inference_model directory written by either package:
    returns (program, feed_names, fetch_vars), parameters loaded into
    `scope` on the executor's device."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        program = _program_desc.program_from_bytes(f.read())
    with open(os.path.join(dirname, "__model_meta__.json")) as f:
        meta = json.load(f)
    load_params(executor, dirname, scope=scope)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch"]]
    return program, meta["feed"], fetch_vars


def scope_from_numpy(arrays, device, program=None):
    """A Scope holding `arrays` ({name: np.ndarray}) as tensors on
    `device` — state carried over by name from the JAX package, which
    uses the same names and layouts (mul weights [in, out], embeddings
    [V, D], layer-norm scale/bias [D], Adam moments like their
    parameters). With `program`, every persistable of the program —
    parameters, optimizer accumulators, beta pows, learning-rate vars,
    step counters — must be present with its declared shape, or this
    raises before anything is converted; values then take the declared
    dtypes (the JAX package's int32 counters become the declared
    int64)."""
    from .core.executor import resolve_device
    device = resolve_device(device)
    declared = {}
    if program is not None:
        declared = {v.name: v for v in program.list_vars() if v.persistable}
        problems = []
        for name, v in declared.items():
            if name not in arrays:
                problems.append("%s: missing" % name)
                continue
            got = tuple(np.shape(arrays[name]))
            if v.shape is not None and got != tuple(v.shape):
                problems.append("%s: shape %s, program declares %s"
                                % (name, got, tuple(v.shape)))
        if problems:
            raise ValueError("scope_from_numpy: arrays do not match the "
                             "program:\n  " + "\n  ".join(problems))
    scope = Scope()
    for name, arr in arrays.items():
        var = declared.get(name)
        scope.set(name, to_tensor(arr, var.dtype if var is not None else None,
                                  device))
    return scope
