"""Whole-parameter pserver placement (parity:
python/paddle/fluid/distribute_transpiler_simple.py).

The simple transpiler places each trainable parameter WHOLE on one pserver
(no block splitting) chosen by a split_method over (param, grad) pairs —
`round_robin` or `hash_name_to_server` — then:
  * trainer program: update ops dropped, one `send` marker op carrying the
    grad -> endpoint placement;
  * pserver program: this endpoint's params + their update ops behind a
    `recv` marker (multi-trainer gradient merge = mean of per-trainer
    copies, as the reference appended sum+scale ops).
The execution path is the full transpiler's: the markers document the
placement, and ParallelExecutor(param_shardings=...) realizes it as
sharded state, the gradient summed and cut onto the owner's shard and the
param gathered at the next step, instead of send/recv RPCs. A copy of the
JAX package's module, building the same program bytes.
"""
import zlib

from ..core.framework import Program, default_main_program

__all__ = ["SimpleDistributeTranspiler", "round_robin",
           "hash_name_to_server"]


def _placement_map(params_grads, pserver_endpoints, order):
    """endpoint -> {"params": [...], "grads": [...]} with `order` giving the
    endpoint index per trainable (param, grad) pair."""
    out = {}
    for (param, grad), idx in zip(params_grads, order):
        if idx is None:
            continue
        ep = pserver_endpoints[idx]
        slot = out.setdefault(ep, {"params": [], "grads": []})
        slot["params"].append(param)
        slot["grads"].append(grad)
    return out


def round_robin(params_grads, pserver_endpoints):
    order, i = [], 0
    for param, grad in params_grads:
        if getattr(param, "trainable", True) and grad is not None:
            order.append(i % len(pserver_endpoints))
            i += 1
        else:
            order.append(None)
    return _placement_map(params_grads, pserver_endpoints, order)


def hash_name_to_server(params_grads, pserver_endpoints):
    order = []
    for param, grad in params_grads:
        if getattr(param, "trainable", True) and grad is not None:
            # stable across processes (builtin hash() is salted per run);
            # full-name digest — long generated names sharing a prefix must
            # not all land on one pserver
            h = zlib.crc32(param.name.encode("utf-8"))
            order.append(h % len(pserver_endpoints))
        else:
            order.append(None)
    return _placement_map(params_grads, pserver_endpoints, order)


class SimpleDistributeTranspiler(object):
    """transpile(optimize_ops, params_grads, ...) then get_trainer_program()
    / get_pserver_program(endpoint, optimize_ops)."""

    def transpile(self, optimize_ops, params_grads, program=None,
                  pservers="127.0.0.1:6174", trainers=1,
                  split_method=round_robin):
        if program is None:
            program = default_main_program()
        self.program = program
        self.trainers = trainers
        self.optimize_ops = list(optimize_ops)
        self.pserver_endpoints = [ep.strip() for ep in pservers.split(",")]
        self.param_grad_map = split_method(params_grads,
                                           self.pserver_endpoints)
        # grad name -> endpoint, for the send marker
        self._epmap = {}
        for ep, slot in self.param_grad_map.items():
            for g in slot["grads"]:
                self._epmap[g.name] = [ep]
        return self

    def get_trainer_program(self):
        """Clone of the main program with update ops removed and a `send`
        marker appended (reference: delete_ops + send op)."""
        prog = self.program.clone()
        block = prog.global_block()
        drop_types = {op.type for op in self.optimize_ops}
        block.ops = [op for op in block.ops if op.type not in drop_types]
        block.append_op(
            type="send",
            inputs={"X": sorted(self._epmap)},
            outputs={},
            attrs={"endpoints": self.pserver_endpoints,
                   "epmap": dict(self._epmap), "sync_mode": True},
            infer_shape=False)
        prog._bump_version()
        return prog

    def get_pserver_program(self, endpoint, optimize_ops):
        """This endpoint's params + the update ops touching them, behind a
        recv marker. Multi-trainer: grads arrive as per-trainer copies and
        are merged by mean before the update (an attr on the recv marker)."""
        prog = Program()
        block = prog.global_block()
        src_block = self.program.global_block()
        slot = self.param_grad_map.get(endpoint, {"params": [], "grads": []})
        my_params = {p.name for p in slot["params"]}
        my_grads = {g.name for g in slot["grads"]}

        for v in slot["params"] + slot["grads"]:
            block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                             persistable=v.name in my_params)

        for op in optimize_ops:
            pnames = op.inputs.get("Param", [])
            if pnames and pnames[0] not in my_params:
                continue
            # materialize any other referenced vars (lr, accumulators)
            for names in list(op.inputs.values()) + list(op.outputs.values()):
                for n in names:
                    if not block.has_var_recursive(n):
                        src = src_block.var(n) if src_block.has_var_recursive(
                            n) else None
                        block.create_var(
                            name=n,
                            shape=getattr(src, "shape", None),
                            dtype=getattr(src, "dtype", "float32"),
                            persistable=True)
            block.append_op(type=op.type, inputs=dict(op.inputs),
                            outputs=dict(op.outputs), attrs=dict(op.attrs),
                            infer_shape=False)

        block.prepend_op(
            type="recv",
            inputs={},
            outputs={"Out": sorted(my_grads)},
            attrs={"endpoint": endpoint,
                   "ParamList": sorted(my_params),
                   "GradList": sorted(my_grads),
                   "Trainers": self.trainers,
                   "merge": "mean"},
            infer_shape=False)
        prog._bump_version()
        return prog
