"""Math / elementwise / activation / reduction ops.

Port of the op types of ``paddle_tpu/ops/math.py`` that a BERT
pretraining step, a ResNet training step and YOLOv3 inference run. Paddle's elementwise
``axis`` broadcast (y aligned to x starting at ``axis``) is kept. Plain
torch ops: the JAX package left these to XLA, and the port leaves them
to torch's own kernels.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _x(inputs, slot="X"):
    return inputs[slot][0]


def _bcast_y(x, y, axis):
    """Paddle elementwise broadcast: y's dims align to x at ``axis``
    (ref: operators/elementwise/elementwise_op_function.h GetMidDims)."""
    if x.ndim <= y.ndim:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    new_shape = [1] * axis + list(y.shape) + [1] * (x.ndim - axis - y.ndim)
    return y.reshape(new_shape)


def _elementwise(name, fn):
    @register_op(name)
    def _op(inputs, attrs, _fn=fn):
        x, y = inputs["X"][0], inputs["Y"][0]
        y = _bcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}
    return _op


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)


@register_op("scale")
def scale(inputs, attrs):
    x = _x(inputs)
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register_op("matmul_v2")
def matmul_v2(inputs, attrs):
    x, y = inputs["X"][0], inputs["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    if x.dtype != y.dtype:            # jnp.matmul promotes; torch raises
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return {"Out": [torch.matmul(x, y)]}


@register_op("reduce_sum")
def reduce_sum(inputs, attrs):
    x = _x(inputs)
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        out = x.sum()
        return {"Out": [out.reshape([1] * x.ndim) if keep else out]}
    axes = attrs.get("dim", [0])
    axes = [a % x.ndim for a in
            (axes if isinstance(axes, (list, tuple)) else [axes])]
    return {"Out": [x.sum(dim=axes, keepdim=keep)]}


@register_op("mean")
def mean(inputs, attrs):
    return {"Out": [_x(inputs).mean()]}


@register_op("gelu")
def gelu(inputs, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(_x(inputs),
                                             approximate=approximate)]}


@register_op("relu")
def relu(inputs, attrs):
    return {"Out": [torch.relu(_x(inputs))]}


@register_op("relu6")
def relu6(inputs, attrs):
    """clip(x, 0, threshold); no gradient at either end (lax.clamp's)."""
    return {"Out": [torch.nn.functional.hardtanh(
        _x(inputs), 0.0, attrs.get("threshold", 6.0))]}


@register_op("leaky_relu")
def leaky_relu(inputs, attrs):
    """x where x > 0, else alpha * x (the reference's default alpha is
    0.02). The gradient at exactly 0 is alpha here and 1 in the
    reference (``jnp.where(x >= 0, ...)``); values are equal."""
    return {"Out": [torch.nn.functional.leaky_relu(
        _x(inputs), attrs.get("alpha", 0.02))]}


@register_op("tanh")
def tanh(inputs, attrs):
    return {"Out": [torch.tanh(_x(inputs))]}


@register_op("not_equal", non_differentiable_inputs=("X", "Y"))
def not_equal(inputs, attrs):
    return {"Out": [torch.ne(inputs["X"][0], inputs["Y"][0])]}
