"""Math / elementwise / activation / reduction ops.

Port of the op types of ``paddle_tpu/ops/math.py`` that a BERT
pretraining step, a ResNet training step, YOLOv3 inference and the
static graph (``mul`` for ``fc``, ``sum`` for gradient accumulation,
``square``, ``top_k`` and ``accuracy``) run. Paddle's elementwise
``axis`` broadcast (y aligned to x starting at ``axis``) is kept. Plain
torch ops: the JAX package left these to XLA, and the port leaves them
to torch's own kernels.
"""
from __future__ import annotations

import math

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


@register_op("sum")
def sum_op(inputs, attrs):
    """Multi-input add, used for grad accumulation (ref: sum_op.cc)."""
    xs = inputs["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


def _promoted(x, y):
    if x.dtype != y.dtype:            # jnp.matmul promotes; torch raises
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return x, y


@register_op("mul")
def mul(inputs, attrs):
    """Flattening matmul (ref: operators/mul_op.cc): x flattened to 2-D at
    x_num_col_dims, y at y_num_col_dims."""
    x, y = _promoted(inputs["X"][0], inputs["Y"][0])
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    out = torch.matmul(x.reshape(-1, math.prod(xs[xnc:])),
                       y.reshape(math.prod(ys[:ync]), -1))
    return {"Out": [out.reshape(xs[:xnc] + ys[ync:])]}


@register_op("matmul_v2")
def matmul_v2(inputs, attrs):
    x, y = inputs["X"][0], inputs["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    x, y = _promoted(x, y)
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


@register_op("square")
def square(inputs, attrs):
    return {"Out": [torch.square(_x(inputs))]}


@register_op("tanh")
def tanh(inputs, attrs):
    return {"Out": [torch.tanh(_x(inputs))]}


@register_op("not_equal", non_differentiable_inputs=("X", "Y"))
def not_equal(inputs, attrs):
    return {"Out": [torch.ne(inputs["X"][0], inputs["Y"][0])]}


@register_op("top_k", non_differentiable_inputs=("X",))
def top_k(inputs, attrs):
    """The k largest along the last axis, ties in index order as
    ``lax.top_k`` gives them: a stable sort (``torch.topk`` has no tie
    order on the card). ``K``, when given, is read on the host."""
    x = _x(inputs)
    k = attrs.get("k", 1)
    if inputs.get("K"):
        k = int(inputs["K"][0])
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [values[..., :k]], "Indices": [indices[..., :k]]}


@register_op("accuracy", non_differentiable_inputs=("Out", "Indices",
                                                    "Label"))
def accuracy(inputs, attrs):
    """ref: operators/metrics/accuracy_op.cc: top-k accuracy from
    Indices. The count divides by a device constant: CUDA's division by a
    Python number is 1 ulp off the CPU's."""
    indices = inputs["Indices"][0]
    label = inputs["Label"][0].reshape(-1, 1)
    num_correct = (indices == label).any(dim=1).to(torch.float32).sum()
    n = indices.shape[0]
    total = torch.full((1,), n, dtype=torch.int32, device=indices.device)
    return {"Accuracy": [(num_correct / total.to(torch.float32)).reshape(1)],
            "Correct": [num_correct.to(torch.int32).reshape(1)],
            "Total": [total]}
