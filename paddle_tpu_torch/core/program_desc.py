"""Versioned, self-describing Program serialization.

Parity: the reference persists a ProgramDesc protobuf inside
save_inference_model; the JAX package's core/program_desc.py writes plain
JSON instead. This module writes and reads the SAME JSON bytes and
FORMAT_VERSION, so each package loads the other's saved models.
"""
import base64
import json

import numpy as np

from .framework import Block, Operator, Parameter, Program, Variable

FORMAT_VERSION = 1

__all__ = ["FORMAT_VERSION", "program_to_bytes", "program_from_bytes"]


def _encode_attr(v):
    if isinstance(v, np.ndarray):
        return {"__kind__": "ndarray", "dtype": str(v.dtype),
                "shape": list(v.shape),
                "data": base64.b64encode(np.ascontiguousarray(v).tobytes())
                .decode("ascii")}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [_encode_attr(x) for x in v]
    if isinstance(v, dict):
        return {"__kind__": "dict",
                "items": {str(k): _encode_attr(x) for k, x in v.items()}}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(
        "op attr of type %s is not serializable; inference programs should "
        "only carry plain-data attrs (got %r)" % (type(v).__name__, v))


def _decode_attr(v):
    if isinstance(v, dict):
        kind = v.get("__kind__")
        if kind == "ndarray":
            arr = np.frombuffer(base64.b64decode(v["data"]),
                                dtype=np.dtype(v["dtype"]))
            return arr.reshape(v["shape"]).copy()
        if kind == "dict":
            return {k: _decode_attr(x) for k, x in v["items"].items()}
    if isinstance(v, list):
        return [_decode_attr(x) for x in v]
    return v


def _var_desc(v):
    return {
        "name": v.name,
        "shape": list(v.shape) if v.shape is not None else None,
        "dtype": v.dtype,
        "lod_level": v.lod_level,
        "persistable": bool(v.persistable),
        "stop_gradient": bool(v.stop_gradient),
        "is_data": bool(getattr(v, "is_data", False)),
        "is_parameter": isinstance(v, Parameter),
        "trainable": bool(getattr(v, "trainable", False)),
        "seq_len_var": v.seq_len_var,
        "type": v.type,
        "capacity": v.capacity,
        "mesh_axes": list(getattr(v, "mesh_axes", None) or []) or None,
    }


def _op_desc(op):
    return {
        "type": op.type,
        "uid": op.uid,
        "inputs": {k: list(ns) for k, ns in op.inputs.items()},
        "outputs": {k: list(ns) for k, ns in op.outputs.items()},
        "attrs": {k: _encode_attr(v) for k, v in op.attrs.items()},
    }


def program_to_bytes(program):
    desc = {
        "format_version": FORMAT_VERSION,
        "random_seed": program.random_seed,
        "amp": bool(getattr(program, "_amp", False)),
        "op_uid_counter": program._op_uid_counter,
        "accumulator_owner": dict(
            getattr(program, "_accumulator_owner", {})),
        "blocks": [{
            "idx": blk.idx,
            "parent_idx": blk.parent_idx,
            "vars": [_var_desc(v) for v in blk.vars.values()],
            "ops": [_op_desc(op) for op in blk.ops],
        } for blk in program.blocks],
    }
    return json.dumps(desc, indent=1).encode("utf-8")


def program_from_bytes(data):
    desc = json.loads(data.decode("utf-8"))
    version = desc.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError("unsupported program desc format version %r "
                         "(this build reads version %d)" %
                         (version, FORMAT_VERSION))
    p = Program()
    p.random_seed = desc.get("random_seed", 0)
    p._amp = bool(desc.get("amp", False))
    for bd in desc["blocks"]:
        if bd["idx"] == 0:
            blk = p.global_block()
            blk.parent_idx = bd["parent_idx"]
        else:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            p.blocks.append(blk)
        for vd in bd["vars"]:
            cls_kwargs = dict(
                name=vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                lod_level=vd["lod_level"], persistable=vd["persistable"],
                stop_gradient=vd["stop_gradient"], is_data=vd["is_data"],
                type=vd["type"], capacity=vd["capacity"])
            if vd["is_parameter"]:
                shape = cls_kwargs.pop("shape")
                dtype = cls_kwargs.pop("dtype")
                v = Parameter(blk, shape, dtype,
                              trainable=vd.get("trainable", True),
                              **cls_kwargs)
            else:
                v = Variable(blk, **cls_kwargs)
            v.seq_len_var = vd.get("seq_len_var")
            if vd.get("mesh_axes"):
                v.mesh_axes = tuple(a if a is None else str(a)
                                    for a in vd["mesh_axes"])
            blk.vars[v.name] = v
        for od in bd["ops"]:
            op = Operator(blk, od["type"], None, None,
                          {k: _decode_attr(v)
                           for k, v in od["attrs"].items()})
            op.inputs = {k: list(ns) for k, ns in od["inputs"].items()}
            op.outputs = {k: list(ns) for k, ns in od["outputs"].items()}
            # preserve op identity: uids salt the per-op random streams
            op.uid = od.get("uid", op.uid)
            blk.ops.append(op)
    p._op_uid_counter = desc.get("op_uid_counter", p._op_uid_counter)
    p._accumulator_owner = dict(desc.get("accumulator_owner", {}))
    p._bump_version()
    return p
