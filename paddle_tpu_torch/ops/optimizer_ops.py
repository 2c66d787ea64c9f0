"""Optimizer update-rule op rules: sgd, momentum, adam,
adam_beta_pow_update, adagrad, adamax, decayed_adagrad, adadelta,
rmsprop, ftrl, proximal_gd and proximal_adagrad.

Parity: paddle/fluid/operators/{sgd_op,momentum_op,adam_op,adagrad_op,
adamax_op,decayed_adagrad_op,adadelta_op,rmsprop_op,ftrl_op,proximal_gd_op,
proximal_adagrad_op}.{cc,h} and the JAX package's ops/optimizer_ops.py
(proximal_gd and proximal_adagrad: its ops/tail_ops.py). Each writes
ParamOut (and the accumulator outs) under the same var name as its input,
so the executor's write-back of persistables updates the Scope. The rules
allocate new tensors rather than updating in place: a run's kept graphs
and its fetches may still hold the old ones. Plain torch, as XLA computed
these outside any Pallas kernel; the learning rate and the beta power stay
tensors on the device (no host sync).
"""
import torch

from ..core.registry import register, single


@register("sgd")
def _sgd(ctx, ins, attrs):
    """param -= lr * grad."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").reshape(())
    return {"ParamOut": [(p - lr * g).to(p.dtype)]}


@register("momentum")
def _momentum(ctx, ins, attrs):
    """velocity = mu * velocity + grad; param -= lr * velocity, or with
    use_nesterov param -= lr * (grad + mu * velocity)."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    v = single(ins, "Velocity")
    lr = single(ins, "LearningRate").reshape(())
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out.to(p.dtype)], "VelocityOut": [v_out]}


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


@register("adamax")
def _adamax(ctx, ins, attrs):
    """moment = b1 m + (1 - b1) g; inf_norm = max(b2 n, |g| + eps);
    param -= lr / (1 - b1^t) * moment / inf_norm."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    m = single(ins, "Moment")
    inf_norm = single(ins, "InfNorm")
    lr = single(ins, "LearningRate").reshape(())
    b1p = single(ins, "Beta1Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    n_out = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    p_out = p - (lr / (1 - b1p)) * (m_out / n_out)
    return {"ParamOut": [p_out.to(p.dtype)],
            "MomentOut": [m_out], "InfNormOut": [n_out]}


@register("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    """moment = decay m + (1 - decay) g^2; param -= lr g / (sqrt(moment)
    + eps)."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    mom = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * mom + (1 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [m_out]}


@register("adadelta")
def _adadelta(ctx, ins, attrs):
    """The rule reads no learning rate: update = -sqrt((E[u^2] + eps) /
    (E[g^2] + eps)) g with both averages decayed by rho."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    avg_sq_g = single(ins, "AvgSquaredGrad")
    avg_sq_u = single(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": [(p + update).to(p.dtype)],
            "AvgSquaredGradOut": [g2], "AvgSquaredUpdateOut": [u2]}


@register("rmsprop")
def _rmsprop(ctx, ins, attrs):
    """mean_square = decay ms + (1 - decay) g^2; moment = momentum mom +
    lr g / sqrt(mean_square + eps); param -= moment."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    ms = single(ins, "MeanSquare")
    mom = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * g * g
    mom_out = momentum * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [(p - mom_out).to(p.dtype)],
            "MeanSquareOut": [ms_out], "MomentOut": [mom_out]}


@register("ftrl")
def _ftrl(ctx, ins, attrs):
    """FTRL-proximal (ftrl_op.h): the squared and linear accumulators,
    then param = (clip(lin, -l1, l1) - lin) / (new_sq^-lr_power / lr +
    2 l2); lr_power -0.5 takes square roots, as the JAX rule does."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    sq_acc = single(ins, "SquaredAccumulator")
    lin_acc = single(ins, "LinearAccumulator")
    lr = single(ins, "LearningRate").reshape(())
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq_acc + g * g
    if power == -0.5:
        new_pow, old_pow = torch.sqrt(new_sq), torch.sqrt(sq_acc)
    else:
        new_pow, old_pow = torch.pow(new_sq, -power), torch.pow(sq_acc,
                                                                -power)
    sigma = (new_pow - old_pow) / lr
    new_lin = lin_acc + g - sigma * p
    denom = new_pow / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return {"ParamOut": [(pre / denom).to(p.dtype)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [new_lin]}


def _proximal_step(lr, l1, l2, prox):
    return (torch.sign(prox) / (1.0 + lr * l2)
            * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0))


@register("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    """prox = param - lr g; param = sign(prox) / (1 + lr l2) *
    max(|prox| - lr l1, 0) (proximal_gd_op.h, FOBOS)."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").reshape(())
    out = _proximal_step(lr, attrs.get("l1", 0.0), attrs.get("l2", 0.0),
                         p - lr * g)
    return {"ParamOut": [out.to(p.dtype)]}


@register("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    """The proximal step of proximal_gd on an adagrad-scaled gradient:
    moment += g^2, prox = param - lr g / sqrt(moment)."""
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    m = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    m_out = m + g * g
    out = _proximal_step(lr, attrs.get("l1", 0.0), attrs.get("l2", 0.0),
                         p - lr * g / torch.sqrt(m_out))
    return {"ParamOut": [out.to(p.dtype)], "MomentOut": [m_out]}
