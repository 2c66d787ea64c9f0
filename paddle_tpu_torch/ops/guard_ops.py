"""Numerical-guard op rules (resilience.install_numeric_guards).

Parity: the JAX package's ops/guard_ops.py. Three ops turn a training
program into one that protects itself, without touching an optimizer
rule:

  * `check_finite_guard` — all-finite checks over the watched vars (the
    loss, the parameter gradients, optionally the parameters). Emits a
    [1] bool "all finite" flag and the sticky assertion flags of the
    in-graph error channel (`ctx.add_error`), so the host pays ONE read
    of the combined flag a run, the flags OR across a steps=K call, and
    the executor raises NumericalGuardError naming the non-finite vars.
    With `grad_norm_vars` it also puts the f32 global L2 norm of those
    vars on the stat channel (GRAD_NORM_STAT), which rides the same read.
  * `guard_backup` — the pre-step value of a state var, by alias: the
    update rules are functional (they return new tensors), so the input
    tensor stays the pre-step value; under steps=K it is the runner's
    buffer, which nothing overwrites before the step's copy-back.
  * `guard_select_all` — the gate: each gated var becomes its updated
    value where the step was all-finite and its backup where it was not,
    decided on the device (no host read, so it captures into the steps=K
    CUDA graph): csrc/guard_restore.cu writes the backups over the
    updated values in place where the flag is false, one launch a few
    dozen vars, and does nothing else on a healthy step. A tripped step
    leaves every gated persistable bit-identical to not having run, and a
    fetch of one after the gate reads the pre-step value.

The checks are plain torch calls (multi-tensor norms), as XLA computed
them in the JAX package; the gate is the port's hand kernel: its plain
form, a `torch.where` a var, cost more than the checks on the card
(PERF.md).
"""
import math

import torch

from ..core.lowering import GUARD_STAT_PREFIX
from ..core.registry import register, single
from . import cuda_kernels as ck

# stat-channel key of the sentinel's global gradient norm (resilience/
# sentinel.py): a float scalar on the guard error channel, moved into
# Executor.last_stats by the run's one flag read
GRAD_NORM_STAT = GUARD_STAT_PREFIX + "grad_norm"


def finite_checks(vals):
    """([N] bool nonfinite flags, [N] f32 L2 norms) of the float tensors
    `vals`: flag i is exactly ~isfinite(vals[i]).all(). Two multi-tensor
    norms decide it: the max |v| is inf where v holds an infinity, and
    the sum of squares is NaN where v holds a NaN (a sum of finite
    squares may overflow to inf, never to NaN). So a healthy 3e38 that
    overflows the sum of squares trips nothing, and a max that dropped
    NaN would still leave the NaN in the sum. An empty tensor is finite
    (the infinity norm refuses one). f64 norms stay f64: the multi-tensor
    norm refuses to narrow."""
    live = [i for i, v in enumerate(vals) if v.numel()]
    zero = torch.zeros((), dtype=torch.float32, device=vals[0].device)
    flags, norms = [zero.bool()] * len(vals), [zero] * len(vals)
    if live:
        lv = [vals[i] for i in live]
        wide = any(v.dtype == torch.float64 for v in lv)
        l2 = torch._foreach_norm(lv, 2, dtype=None if wide else torch.float32)
        amax = torch._foreach_norm(lv, math.inf)
        bad = torch.stack(l2).isnan() | torch.stack(amax).float().isinf()
        if len(live) == len(vals):
            return bad, l2
        for j, i in enumerate(live):
            flags[i], norms[i] = bad[j], l2[j]
    return torch.stack(flags), norms


@register("check_finite_guard")
def _check_finite_guard(ctx, ins, attrs):
    names = attrs.get("var_names") or []
    floats = [(n, v) for n, v in zip(names, ins.get("X", []))
              if v.is_floating_point()]
    if not floats:
        return {"Out": [torch.ones((1,), dtype=torch.bool,
                                   device=ctx.device)]}
    bad, norms = finite_checks([v for _, v in floats])
    if attrs.get("grad_norm_vars"):
        # ONE f32 global L2 norm over the watched parameter gradients,
        # from the per-var norms the flags came from: the stat channel
        # rides the flag read, so the sentinel's watch costs no host read
        watch = frozenset(attrs["grad_norm_vars"])
        sq = [norms[i].float() for i, (n, _) in enumerate(floats)
              if n in watch]
        if sq:
            ctx.add_error(GRAD_NORM_STAT,
                          torch.linalg.vector_norm(torch.stack(sq)))
    if attrs.get("granular", True):
        # per-var flags, packed as ONE [N] vector under ONE \x00-joined
        # message key: the trip names exactly which var went bad
        msgs = ["numerical guard: non-finite value detected in %r "
                "(this step's state updates were skipped in-graph)" % n
                for n, _ in floats]
        ctx.add_error("\x00".join(msgs), bad)
        return {"Out": [(~bad.any()).reshape(1)]}
    # granular=False: one combined message over the watched set (the
    # JAX package reduces their concatenation; the per-var flags' OR is
    # the same predicate without the concatenation's copy)
    ok = ~bad.any()
    ctx.add_error(
        "numerical guard: non-finite value detected among %s (this "
        "step's state updates were skipped in-graph)"
        % [n for n, _ in floats], ~ok)
    return {"Out": [ok.reshape(1)]}


@register("guard_backup")
def _guard_backup(ctx, ins, attrs):
    return {"Out": [single(ins, "X")]}


def _exclusive(xs, ys):
    """The updated values, each cloned where it shares memory with a
    backup or another updated value, or does not own its whole storage
    (the gate writes them in place)."""
    taken = {y.untyped_storage().data_ptr() for y in ys}
    out = []
    for x in xs:
        st = x.untyped_storage()
        if st.data_ptr() in taken or not x.is_contiguous() or \
                x.storage_offset() or \
                st.nbytes() != x.numel() * x.element_size():
            x = x.clone(memory_format=torch.contiguous_format)
            st = x.untyped_storage()
        taken.add(st.data_ptr())
        out.append(x)
    return out


@register("guard_select_all")
def _guard_select_all(ctx, ins, attrs):
    """Updated value where the step was all-finite, backup where not: the
    update rules return new tensors, so the gate (ops/cuda_kernels.
    guard_restore) writes each backup over its updated value in place
    where the flag is false, on the device, with no host read."""
    xs = _exclusive(ins["X"], ins["Y"])
    ys = [y if y.dtype == x.dtype and y.is_contiguous()
          else y.to(x.dtype).contiguous() for x, y in zip(xs, ins["Y"])]
    ck.guard_restore(single(ins, "Cond"), xs, ys)
    return {"Out": xs}
