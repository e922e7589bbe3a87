"""Optimizer update ops: ``sgd`` and ``momentum``.

Port of ``paddle_tpu/ops/optimizer_ops.py:49-68``. Non-differentiable;
the optimizer calls them under ``no_grad``.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_ND = ("Param", "Grad", "LearningRate", "Velocity")


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


@register_op("sgd", non_differentiable_inputs=_ND)
def sgd(inputs, attrs):
    p = inputs["Param"][0]
    return {"ParamOut": [p - _lr(inputs, attrs) * inputs["Grad"][0]]}


@register_op("momentum", non_differentiable_inputs=_ND)
def momentum(inputs, attrs):
    p, v, g = inputs["Param"][0], inputs["Velocity"][0], inputs["Grad"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(inputs, attrs)
    rd = attrs.get("regularization_coeff", 0.0)
    if attrs.get("regularization_method", "") == "l2_decay":
        g = g + rd * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}
