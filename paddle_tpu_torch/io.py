"""Model persistence: parameters and inference models.

Parity: python/paddle/fluid/io.py and the JAX package's io.py — the same
on-disk format, so each package loads the other's saved models: a
directory of .npy files (one per var) plus a JSON manifest, and for an
inference model the versioned JSON program desc (`__model__`,
core/program_desc.py) and `__model_meta__.json` naming feeds and fetches.
Each function takes the Scope it reads or fills (default: the global
scope, which `scope_guard` sets). The JAX package's keywords are taken
too: `filename` and `params_filename` (accepted, as there: one file per
var) and `allow_missing` (a partial save or load on purpose).
"""
import json
import os

import numpy as np

from .core import program_desc as _program_desc
from .core.executor import Scope, global_scope, to_numpy, to_tensor
from .core.readers import ReaderBase, is_host_io_op
from .core.framework import Parameter, Variable, default_main_program

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "get_inference_program",
           "get_parameter_value", "get_parameter_value_by_name",
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


def _reader_var_names(program):
    """Names wired into host-io (reader) ops anywhere in `program`, the
    JAX package's rule: in-graph reader vars are persistable, but their
    scope value is a host-side reader, never checkpoint payload, on the
    save and the load side alike. Found from the OPS, so the rule
    survives a program_desc round trip."""
    names = set()
    if program is None:
        return names
    for block in program.blocks:
        for op in block.ops:
            if is_host_io_op(op.type):
                for slot in list(op.inputs.values()) + \
                        list(op.outputs.values()):
                    if op.type == "read" and slot is op.outputs.get("Out"):
                        continue  # the data outputs ARE tensors
                    names.update(slot)
    return names


def _is_reader_var(v, reader_names=()):
    return hasattr(v, "reader_shapes") or v.name in reader_names


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, allow_missing=False,
              scope=None):
    """Write `vars` (or the program's vars matching `predicate`, default
    persistables) as .npy files + a manifest. A var with no value in the
    scope raises (the file set would silently omit it) unless
    allow_missing=True. Everything is checked before the first byte is
    written."""
    scope = scope if scope is not None else global_scope()
    reader_names = _reader_var_names(main_program)
    to_write = []
    for v in _var_list(main_program, predicate or is_persistable, vars):
        val = scope.get(v.name)
        if isinstance(val, ReaderBase):
            continue  # live reader state: runtime plumbing, not a tensor
        if val is None:
            if allow_missing or _is_reader_var(v, reader_names):
                continue
            raise RuntimeError(
                "save_vars: variable %r has no value in the scope; run the "
                "startup program first, or pass allow_missing=True for an "
                "intentionally partial save" % v.name)
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
                filename=None, allow_missing=False, scope=None):
    save_vars(executor, dirname, main_program, vars, is_parameter, filename,
              allow_missing, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      allow_missing=False, scope=None):
    """Every persistable of the program: parameters, optimizer state,
    learning-rate vars and step counters (what a resumed run needs)."""
    save_vars(executor, dirname, main_program, None, is_persistable,
              filename, allow_missing, scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, params_only=False,
              allow_missing=False, scope=None):
    """Restore vars from a save_vars directory onto the executor's device.
    A requested var the manifest does not carry raises (it would silently
    keep its init value) unless allow_missing=True; nothing is restored
    before that check."""
    scope = scope if scope is not None else global_scope()
    with open(os.path.join(dirname, "manifest.json")) as f:
        manifest = json.load(f)
    want = None
    if vars is not None or main_program is not None:
        reader_names = _reader_var_names(main_program)
        want = set(v.name for v in
                   _var_list(main_program, predicate or is_persistable, vars)
                   if not _is_reader_var(v, reader_names))
        absent = sorted(want - set(manifest))
        if absent and not allow_missing:
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


def load_params(executor, dirname, main_program=None, filename=None,
                allow_missing=False, scope=None):
    load_vars(executor, dirname, main_program, None, is_parameter, filename,
              params_only=True, allow_missing=allow_missing, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      allow_missing=False, scope=None):
    load_vars(executor, dirname, main_program, None, is_persistable,
              filename, allow_missing=allow_missing, scope=scope)


def get_inference_program(target_vars, main_program=None):
    """The program cloned for inference (dropout and batch_norm in test
    mode), as the JAX package gives it."""
    if main_program is None:
        main_program = default_main_program()
    return main_program.clone(for_test=True)


def get_parameter_value(para, executor, scope=None):
    """A Parameter's current value as numpy (parity: fluid.io
    get_parameter_value; values live in the scope, no fetch program
    needed)."""
    scope = scope if scope is not None else global_scope()
    val = scope.get(para.name)
    if val is None:
        raise ValueError("parameter %r not initialized in the current "
                         "scope; run the startup program first" % para.name)
    return to_numpy(val)


def get_parameter_value_by_name(name, executor, program=None, scope=None):
    """The Parameter `name` of `program` (default: the main program) as
    numpy; a variable that is not a Parameter raises."""
    program = program or default_main_program()
    var = program.global_block().var(name)
    if not isinstance(var, Parameter):
        raise TypeError("variable %r is not a Parameter" % name)
    return get_parameter_value(var, executor, scope=scope)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None):
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


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
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
