"""Optimizer update ops: the sixteen of the reference.

Port of ``paddle_tpu/ops/optimizer_ops.py``: ``sgd``, ``momentum``,
``adam``, ``adamw``, ``lamb``, ``lars_momentum``, ``rmsprop``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``adamax``, ``ftrl``,
``dpsgd``, ``average_accumulates``, ``check_finite_and_unscale`` and
``update_loss_scaling``, under the reference's op types, slots and
attrs. Each is plain torch code: none was a Pallas kernel in the JAX
package. Non-differentiable; the optimizer calls them under ``no_grad``.

Dtypes follow JAX's promotion. A 0-d array (the learning rate, a beta
power, a trust ratio) takes part in JAX's promotion, so a bf16 parameter
updated with an f32 learning rate comes out f32; in torch a 0-d tensor
does not promote a tensor with dimensions, so :func:`jax_promote` casts the
other operand first wherever such a pair meets.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.registry import register_op

_ND = ("Param", "Grad", "LearningRate", "Velocity", "Moment", "Moment1",
       "Moment2", "Beta1Pow", "Beta2Pow", "MasterParam", "MeanSquare",
       "MeanGrad", "AvgSquaredGrad", "AvgSquaredUpdate", "InfNorm",
       "SquaredAccumulator", "LinearAccumulator")


def jax_promote(x, *scalars):
    """``x`` in the dtype JAX gives it against the 0-d tensors
    ``scalars`` (Python numbers are weak and ignored, as in JAX)."""
    dt = x.dtype
    for s in scalars:
        if isinstance(s, torch.Tensor):
            dt = torch.promote_types(dt, s.dtype)
    return x if dt == x.dtype else x.to(dt)


def _g(inputs):
    return inputs["Grad"][0]


def _lr(inputs, attrs=None):
    """LearningRate input, or the learning_rate attr when the caller feeds
    none. Neither present is a wiring bug: fail loudly."""
    lrs = inputs.get("LearningRate") or ()
    if not len(lrs):
        attrs = attrs or {}
        if "learning_rate" not in attrs:
            raise KeyError(
                "optimizer op got neither a LearningRate input nor a "
                "learning_rate attr — the LR wiring is broken")
        return torch.tensor(attrs["learning_rate"], dtype=torch.float32)
    lr = lrs[0]
    return lr.reshape(()) if getattr(lr, "ndim", 0) else lr


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@register_op("sgd", non_differentiable_inputs=_ND)
def sgd(inputs, attrs):
    p, lr = inputs["Param"][0], _lr(inputs, attrs)
    return {"ParamOut": [p - lr * jax_promote(_g(inputs), lr)]}


@register_op("momentum", non_differentiable_inputs=_ND)
def momentum(inputs, attrs):
    p, v, g = inputs["Param"][0], inputs["Velocity"][0], _g(inputs)
    mu = attrs.get("mu", 0.9)
    lr = _lr(inputs, attrs)
    rd = attrs.get("regularization_coeff", 0.0)
    if attrs.get("regularization_method", "") == "l2_decay":
        g = g + rd * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - jax_promote(g + mu * v_out, lr) * lr
    else:
        p_out = p - lr * jax_promote(v_out, lr)
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam", non_differentiable_inputs=_ND)
def adam(inputs, attrs):
    p, g = inputs["Param"][0], _g(inputs)
    m1, m2 = inputs["Moment1"][0], inputs["Moment2"][0]
    b1p, b2p = inputs["Beta1Pow"][0], inputs["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    if inputs.get("Beta1Tensor"):
        beta1 = inputs["Beta1Tensor"][0].reshape(())
    if inputs.get("Beta2Tensor"):
        beta2 = inputs["Beta2Tensor"][0].reshape(())
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(inputs, attrs)
    m1_out = beta1 * jax_promote(m1, beta1) + (1 - beta1) * jax_promote(g, beta1)
    m2_out = beta2 * jax_promote(m2, beta2) + (1 - beta2) * jax_promote(torch.square(g),
                                                        beta2)
    # Beta1Pow/Beta2Pow start at beta^1, so at step t they hold beta^t
    # (fluid contract: the pow is advanced after the step)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t * jax_promote(m1_out, lr_t) / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * beta1], "Beta2PowOut": [b2p * beta2]}


@register_op("adamw", non_differentiable_inputs=_ND)
def adamw(inputs, attrs):
    """Decoupled weight decay (paddle.optimizer.AdamW)."""
    coeff = attrs.get("coeff", 0.01)
    p = inputs["Param"][0]
    out = adam(inputs, attrs)
    if attrs.get("with_decay", True):
        decay = _lr(inputs, attrs) * coeff
        out["ParamOut"] = [out["ParamOut"][0] - decay * jax_promote(p, decay)]
    return out


@register_op("lamb", non_differentiable_inputs=_ND)
def lamb(inputs, attrs):
    """ref: operators/optimizers/lamb_op.cc — layerwise adaptive large
    batch."""
    p, g = inputs["Param"][0], _g(inputs)
    m1, m2 = inputs["Moment1"][0], inputs["Moment2"][0]
    b1p, b2p = inputs["Beta1Pow"][0], inputs["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    lr = _lr(inputs, attrs)
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    c1, c2 = 1 - b1p.reshape(()), 1 - b2p.reshape(())
    m1_hat = jax_promote(m1_out, c1) / c1
    m2_hat = jax_promote(m2_out, c2) / c2
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    step = lr * trust
    p_out = p - step * jax_promote(r, step)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * beta1], "Beta2PowOut": [b2p * beta2]}


@register_op("lars_momentum", non_differentiable_inputs=_ND)
def lars_momentum(inputs, attrs):
    """ref: operators/optimizers/lars_momentum_op.cc."""
    p, v, g = inputs["Param"][0], inputs["Velocity"][0], _g(inputs)
    mu = attrs.get("mu", 0.9)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(inputs, attrs)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_out = mu * v + local_lr * jax_promote(g + wd * p, local_lr)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_op("rmsprop", non_differentiable_inputs=_ND)
def rmsprop(inputs, attrs):
    p, g = inputs["Param"][0], _g(inputs)
    ms, mom = inputs["MeanSquare"][0], inputs["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(inputs, attrs)
    outs = {}
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg = inputs["MeanGrad"][0]
        mg_out = rho * mg + (1 - rho) * g
        mom_out = mu * mom + lr * jax_promote(g, lr) / torch.sqrt(
            ms_out - torch.square(mg_out) + eps)
        outs["MeanGradOut"] = [mg_out]
    else:
        mom_out = mu * mom + lr * jax_promote(g, lr) / torch.sqrt(ms_out + eps)
    outs.update({"ParamOut": [p - mom_out], "MomentOut": [mom_out],
                 "MeanSquareOut": [ms_out]})
    return outs


@register_op("adagrad", non_differentiable_inputs=_ND)
def adagrad(inputs, attrs):
    p, g, mom = inputs["Param"][0], _g(inputs), inputs["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(inputs, attrs)
    mom_out = mom + torch.square(g)
    return {"ParamOut": [p - lr * jax_promote(g, lr) / (torch.sqrt(mom_out) + eps)],
            "MomentOut": [mom_out]}


@register_op("decayed_adagrad", non_differentiable_inputs=_ND)
def decayed_adagrad(inputs, attrs):
    p, g, mom = inputs["Param"][0], _g(inputs), inputs["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(inputs, attrs)
    mom_out = decay * mom + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - lr * jax_promote(g, lr) / (torch.sqrt(mom_out) + eps)],
            "MomentOut": [mom_out]}


@register_op("adadelta", non_differentiable_inputs=_ND)
def adadelta(inputs, attrs):
    p, g = inputs["Param"][0], _g(inputs)
    asg, asu = inputs["AvgSquaredGrad"][0], inputs["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * asg + (1 - rho) * torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("adamax", non_differentiable_inputs=_ND)
def adamax(inputs, attrs):
    p, g = inputs["Param"][0], _g(inputs)
    m, inf = inputs["Moment"][0], inputs["InfNorm"][0]
    b1p = inputs["Beta1Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(inputs, attrs)
    m_out = beta1 * m + (1 - beta1) * g
    inf_out = torch.maximum(beta2 * inf, torch.abs(g))
    lr_t = lr / (1 - b1p.reshape(()))
    # the reference's departure from fluid: the op advances Beta1Pow itself
    return {"ParamOut": [p - lr_t * jax_promote(m_out, lr_t) / (inf_out + eps)],
            "MomentOut": [m_out], "InfNormOut": [inf_out],
            "Beta1PowOut": [b1p * beta1]}


@register_op("ftrl", non_differentiable_inputs=_ND)
def ftrl(inputs, attrs):
    p, g = inputs["Param"][0], _g(inputs)
    sq, lin = inputs["SquaredAccumulator"][0], inputs["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(inputs, attrs)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = jax_promote(torch.sqrt(new_sq) - torch.sqrt(sq), lr) / lr
        denom = jax_promote(torch.sqrt(new_sq), lr) / lr + 2 * l2
    else:
        sigma = jax_promote(torch.pow(new_sq, -lr_power) -
                    torch.pow(sq, -lr_power), lr) / lr
        denom = jax_promote(torch.pow(new_sq, -lr_power), lr) / lr + 2 * l2
    lin_out = lin + g - sigma * p
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


@register_op("dpsgd", non_differentiable_inputs=_ND)
def dpsgd(inputs, attrs):
    """Differentially-private SGD (ref: optimizers/dpsgd_op.cc), with the
    reference's optional Step input: the noise of a step is seeded from
    (seed, step, param_id), so steps and parameters draw apart. The
    numbers are torch's Philox, not JAX's threefry: equal in
    distribution, not in value."""
    p, g = inputs["Param"][0], _g(inputs)
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    lr = _lr(inputs, attrs)
    g = g / torch.clamp_min(_norm(g) / clip, 1.0)
    step = inputs.get("Step", [None])[0]
    seed = int(attrs.get("seed", 0) or 0)
    if step is not None:
        gen = torch.Generator(device=g.device)
        gen.manual_seed(hash((seed, int(step.reshape(())),
                              int(attrs.get("param_id", 0)))) & (2 ** 62 - 1))
    else:
        gen = rng.op_generator(seed, g.device)
    noise = torch.randn(g.shape, generator=gen, device=g.device,
                        dtype=g.dtype) * (sigma * clip)
    out = {"ParamOut": [p - lr * jax_promote(g + noise / batch_size, lr)]}
    if step is not None:
        out["StepOut"] = [step + 1]
    return out


@register_op("average_accumulates", non_differentiable_inputs=_ND)
def average_accumulates(inputs, attrs):
    """ModelAverage support op (ref: average_accumulates_op.h): sum_1
    accumulates the param each step; every 16384 updates sum_1 spills
    into sum_2; when the window outgrows min(max_average_window,
    num_updates * average_window) the sums roll into sum_3 and the
    window restarts. Branchless, as the reference."""
    p = inputs["param"][0]
    s1, s2, s3 = (inputs["in_sum_1"][0], inputs["in_sum_2"][0],
                  inputs["in_sum_3"][0])
    num_acc = inputs["in_num_accumulates"][0]
    old_acc = inputs["in_old_num_accumulates"][0]
    num_upd = inputs["in_num_updates"][0]
    avg_window = float(attrs.get("average_window", 0.0))
    max_w = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    k_max = 16384     # kMaxNumAccumulates

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    spill = ((num_upd % k_max) == 0).reshape(())
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)
    window = torch.clamp_max(num_upd.to(torch.float32) * avg_window,
                             float(max_w))
    full = ((num_acc >= min_w) & (num_acc >= window)).reshape(())
    s3 = torch.where(full, s1 + s2, s3)
    s1 = torch.where(full, torch.zeros_like(s1), s1)
    s2 = torch.where(full, torch.zeros_like(s2), s2)
    old_acc = torch.where(full, num_acc, old_acc)
    num_acc = torch.where(full, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [num_acc],
            "out_old_num_accumulates": [old_acc],
            "out_num_updates": [num_upd]}


@register_op("check_finite_and_unscale",
             non_differentiable_inputs=("X", "Scale"))
def check_finite_and_unscale(inputs, attrs):
    """AMP grad unscale + finiteness probe (ref:
    operators/amp/check_finite_and_unscale_op.cc): every grad divided by
    Scale; FoundInfinite is the OR of non-finiteness over every element
    of every grad, left on the device."""
    inv = 1.0 / inputs["Scale"][0]
    xs = inputs["X"]
    found = torch.zeros((), dtype=torch.bool, device=inv.device)
    for x in xs:
        found = found | ~torch.all(torch.isfinite(x))
    outs = [(x.to(torch.float32) * inv).to(x.dtype) for x in xs]
    return {"Out": outs, "FoundInfinite": [found]}


@register_op("update_loss_scaling",
             non_differentiable_inputs=("X", "FoundInfinite",
                                        "PrevLossScaling", "InGoodSteps",
                                        "InBadSteps"))
def update_loss_scaling(inputs, attrs):
    """Dynamic loss-scale state machine (ref: update_loss_scaling_op.cc):
    after incr_every_n_steps clean steps the scale grows by incr_ratio,
    after decr_every_n_nan_or_inf bad ones it shrinks by decr_ratio (not
    under 1); on overflow the grads are zeroed. Branchless."""
    found = inputs["FoundInfinite"][0]
    scale = inputs["PrevLossScaling"][0]
    good = inputs["InGoodSteps"][0]
    bad = inputs["InBadSteps"][0]
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    new_good = torch.where(found, 0, good + 1)
    new_bad = torch.where(found, bad + 1, 0)
    grown = torch.where(new_good >= incr_every, scale * incr_ratio, scale)
    good_after = torch.where(new_good >= incr_every, 0, new_good)
    shrunk = torch.where(new_bad >= decr_every,
                         torch.clamp_min(scale * decr_ratio, 1.0), grown)
    bad_after = torch.where(new_bad >= decr_every, 0, new_bad)
    new_scale = torch.where(found, shrunk, grown)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in inputs["X"]]
    return {"Out": outs, "LossScaling": [new_scale],
            "OutGoodSteps": [good_after], "OutBadSteps": [bad_after]}
