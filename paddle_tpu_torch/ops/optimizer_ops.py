"""Optimizer update-rule op rules: adam, adam_beta_pow_update and adagrad.

Parity: paddle/fluid/operators/adam_op.{cc,h} and the JAX package's
ops/optimizer_ops.py. Each writes ParamOut (and the moment outs) under the
same var name as its input, so the executor's write-back of persistables
updates the Scope. The rules allocate new tensors rather than updating in
place: a run's kept graphs and its fetches may still hold the old ones.
Plain torch, as XLA computed these outside any Pallas kernel. The other
optimizers' rules (sgd, momentum, rmsprop, ...) are not ported yet.
"""
import torch

from ..core.registry import register, single


@register("adam")
def _adam(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    m = single(ins, "Moment1")
    v = single(ins, "Moment2")
    lr = single(ins, "LearningRate").reshape(())
    b1p = single(ins, "Beta1Pow").reshape(())
    b2p = single(ins, "Beta2Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.float()
    m_out = b1 * m + (1 - b1) * gf
    v_out = b2 * v + (1 - b2) * gf * gf
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return {"ParamOut": [p_out.to(p.dtype)],
            "Moment1Out": [m_out], "Moment2Out": [v_out]}


@register("adam_beta_pow_update")
def _adam_beta_pow(ctx, ins, attrs):
    return {"Beta1PowOut": [single(ins, "Beta1Pow") * attrs.get("beta1", 0.9)],
            "Beta2PowOut": [single(ins, "Beta2Pow")
                            * attrs.get("beta2", 0.999)]}


@register("adagrad")
def _adagrad(ctx, ins, attrs):
    """moment += g^2; param -= lr * g / (sqrt(moment) + epsilon)."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    mom = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    eps = attrs.get("epsilon", 1e-6)
    m_out = mom + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [m_out]}
