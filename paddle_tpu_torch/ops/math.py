"""Math / elementwise / activation / reduction ops.

Port of every op type of ``paddle_tpu/ops/math.py``. Paddle's
elementwise ``axis`` broadcast (y aligned to x starting at ``axis``) is
kept. Plain torch ops: the JAX package left these to XLA, and the port
leaves them to torch's own kernels. Where the two libraries differ the
op follows ``jnp``: modulo and floor division take the divisor's sign
(``torch.remainder``, not ``fmod``); a max or min reduction splits the
gradient between ties (``amax``/``amin``); ``top_k*`` are stable sorts,
so ties come in index order as ``lax.top_k`` gives them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
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
        if "scale_x" in attrs or "scale_y" in attrs:
            x = x * attrs.get("scale_x", 1.0)
            y = y * attrs.get("scale_y", 1.0)
        out = _fn(x, y)
        if "scale_out" in attrs:
            out = out * attrs.get("scale_out", 1.0)
        return {"Out": [out]}
    return _op


class _FloorDivide(torch.autograd.Function):
    """``torch.floor_divide`` with the zero gradient ``jnp.floor_divide``
    has (torch defines none)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.shapes = (x.shape, y.shape)
        return torch.floor_divide(x, y)

    @staticmethod
    def backward(ctx, g):
        return tuple(g.new_zeros(s) for s in ctx.shapes)


def _floor_divide(x, y):
    if (x.requires_grad or y.requires_grad) and torch.is_grad_enabled():
        return _FloorDivide.apply(x, y)
    return torch.floor_divide(x, y)


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)
_elementwise("elementwise_mod", torch.remainder)
_elementwise("elementwise_floordiv", _floor_divide)


@register_op("scale")
def scale(inputs, attrs):
    x = _x(inputs)
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if inputs.get("ScaleTensor"):
        s = inputs["ScaleTensor"][0]
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



@register_op("matmul")
def matmul(inputs, attrs):
    """ref: operators/matmul_op.cc: transpose flags and an alpha scale."""
    x, y = inputs["X"][0], inputs["Y"][0]
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    x, y = _promoted(x, y)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    return {"Out": [out * alpha if alpha != 1.0 else out]}


@register_op("bmm")
def bmm(inputs, attrs):
    return {"Out": [torch.matmul(*_promoted(inputs["X"][0],
                                            inputs["Y"][0]))]}


@register_op("dot")
def dot(inputs, attrs):
    x, y = inputs["X"][0], inputs["Y"][0]
    return {"Out": [(x * y).sum(dim=-1, keepdim=x.ndim > 1)]}


@register_op("addmm")
def addmm(inputs, attrs):
    """Beta * Input + Alpha * (X @ Y), in the reference's order."""
    inp, x, y = inputs["Input"][0], inputs["X"][0], inputs["Y"][0]
    return {"Out": [attrs.get("Beta", 1.0) * inp +
                    attrs.get("Alpha", 1.0) * torch.matmul(x, y)]}


# ---- reductions (ref: operators/reduce_ops/) ----
def _reduce_axes(x, attrs):
    """The reduced dims, or None for all of them."""
    if attrs.get("reduce_all", False):
        return None
    axes = attrs.get("dim", [0])
    return tuple(a % x.ndim for a in
                 (axes if isinstance(axes, (list, tuple)) else [axes]))


def _reduce(name, fn):
    @register_op(name)
    def _op(inputs, attrs, _fn=fn):
        x = _x(inputs)
        keep = attrs.get("keep_dim", False)
        axes = _reduce_axes(x, attrs)
        if axes is None:
            out = _fn(x, tuple(range(x.ndim)), keep) if x.ndim else x
            return {"Out": [out]}
        return {"Out": [_fn(x, axes, keep)]}
    return _op


def _prod(x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = x.prod(dim=a, keepdim=keep)
    return x


_reduce("reduce_mean", lambda x, axes, keep: x.mean(dim=axes, keepdim=keep))
_reduce("reduce_max", lambda x, axes, keep: x.amax(dim=axes, keepdim=keep))
_reduce("reduce_min", lambda x, axes, keep: x.amin(dim=axes, keepdim=keep))
_reduce("reduce_prod", _prod)


@register_op("squared_l2_norm")
def squared_l2_norm(inputs, attrs):
    return {"Out": [torch.square(_x(inputs)).sum().reshape(1)]}


@register_op("p_norm")
def p_norm(inputs, attrs):
    """(sum (|x| + epsilon)^p)^(1/p) over ``axis`` (all when absent)."""
    x = _x(inputs)
    p = attrs.get("porder", 2.0)
    axis = attrs.get("axis", None)
    keep = attrs.get("keepdim", False)
    eps = attrs.get("epsilon", 1e-12)
    t = torch.pow(x.abs() + eps, p)
    t = t.sum() if axis is None and not keep else t.sum(
        dim=tuple(range(x.ndim)) if axis is None else axis, keepdim=keep)
    return {"Out": [torch.pow(t, 1.0 / p)]}


# ---- activations (ref: operators/activation_op.cc) ----
def _activation(name, fn):
    @register_op(name)
    def _op(inputs, attrs, _fn=fn):
        return {"Out": [_fn(_x(inputs), attrs)]}
    return _op


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


_activation("sigmoid", lambda x, a: torch.sigmoid(x))
_activation("sqrt", lambda x, a: torch.sqrt(x))
_activation("rsqrt", lambda x, a: torch.rsqrt(x))
_activation("exp", lambda x, a: torch.exp(x))
_activation("log", lambda x, a: torch.log(x))
_activation("log2", lambda x, a: torch.log2(x))
_activation("log10", lambda x, a: torch.log10(x))
_activation("log1p", lambda x, a: torch.log1p(x))
_activation("abs", lambda x, a: torch.abs(x))
_activation("reciprocal", lambda x, a: 1.0 / x)
_activation("floor", lambda x, a: torch.floor(x))
_activation("ceil", lambda x, a: torch.ceil(x))
_activation("round", lambda x, a: torch.round(x))      # half to even
_activation("sin", lambda x, a: torch.sin(x))
_activation("cos", lambda x, a: torch.cos(x))
_activation("tan", lambda x, a: torch.tan(x))
_activation("asin", lambda x, a: torch.asin(x))
_activation("acos", lambda x, a: torch.acos(x))
_activation("atan", lambda x, a: torch.atan(x))
_activation("sinh", lambda x, a: torch.sinh(x))
_activation("cosh", lambda x, a: torch.cosh(x))
_activation("softplus", lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_activation("softsign", lambda x, a: F.softsign(x))
_activation("elu", lambda x, a: F.elu(x, alpha=a.get("alpha", 1.0)))
_activation("selu", lambda x, a: F.selu(x))
_activation("silu", lambda x, a: F.silu(x))
_activation("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_activation("hard_swish", lambda x, a: x * _clip01(
    x / a.get("scale", 6.0) + a.get("offset", 3.0) / a.get("scale", 6.0)))
_activation("hard_sigmoid", lambda x, a: _clip01(
    a.get("slope", 0.2) * x + a.get("offset", 0.5)))
_activation("logsigmoid", lambda x, a: F.logsigmoid(x))
_activation("erf", lambda x, a: torch.erf(x))
_activation("mish", lambda x, a: x * torch.tanh(
    torch.logaddexp(x, torch.zeros_like(x))))
_activation("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_activation("hard_shrink", lambda x, a: torch.where(
    x.abs() > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_activation("soft_shrink", lambda x, a: torch.sign(x) * torch.clamp_min(
    x.abs() - a.get("lambda", 0.5), 0.0))
_activation("tanh_shrink", lambda x, a: x - torch.tanh(x))
_activation("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))


@register_op("pow")
def pow_op(inputs, attrs):
    x = _x(inputs)
    factor = attrs.get("factor", 1.0)
    if inputs.get("FactorTensor"):
        factor = inputs["FactorTensor"][0]
    return {"Out": [torch.pow(x, factor)]}


@register_op("clip")
def clip(inputs, attrs):
    x = _x(inputs)
    lo = inputs["Min"][0] if inputs.get("Min") else attrs.get("min")
    hi = inputs["Max"][0] if inputs.get("Max") else attrs.get("max")
    return {"Out": [torch.clamp(x, lo, hi)]}


@register_op("clip_by_norm")
def clip_by_norm(inputs, attrs):
    x = _x(inputs)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.square(x).sum())
    return {"Out": [torch.where(norm > max_norm, x * (max_norm / norm), x)]}


@register_op("sign")
def sign(inputs, attrs):
    return {"Out": [torch.sign(_x(inputs))]}


@register_op("maximum")
def maximum(inputs, attrs):
    return {"Out": [torch.maximum(inputs["X"][0], inputs["Y"][0])]}


@register_op("minimum")
def minimum(inputs, attrs):
    return {"Out": [torch.minimum(inputs["X"][0], inputs["Y"][0])]}


# ---- comparison / logical (non-differentiable) ----
def _compare(name, fn):
    @register_op(name, non_differentiable_inputs=("X", "Y"))
    def _op(inputs, attrs, _fn=fn):
        return {"Out": [_fn(inputs["X"][0], inputs["Y"][0])]}
    return _op


_compare("equal", torch.eq)
_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("logical_and", torch.logical_and)
_compare("logical_or", torch.logical_or)
_compare("logical_xor", torch.logical_xor)


@register_op("logical_not", non_differentiable_inputs=("X",))
def logical_not(inputs, attrs):
    return {"Out": [torch.logical_not(_x(inputs))]}


@register_op("isfinite", non_differentiable_inputs=("X",))
def isfinite(inputs, attrs):
    """ref: operators/isfinite_op.cc: one flag, every element finite."""
    return {"Out": [torch.isfinite(_x(inputs)).all().reshape(1)]}


@register_op("isfinite_v2", non_differentiable_inputs=("X",))
def isfinite_v2(inputs, attrs):
    return {"Out": [torch.isfinite(_x(inputs))]}


@register_op("isnan_v2", non_differentiable_inputs=("X",))
def isnan_v2(inputs, attrs):
    return {"Out": [torch.isnan(_x(inputs))]}


@register_op("isinf_v2", non_differentiable_inputs=("X",))
def isinf_v2(inputs, attrs):
    return {"Out": [torch.isinf(_x(inputs))]}


# ---- argmax / top-k (non-differentiable index ops) ----
def _arg(name, fn):
    @register_op(name, non_differentiable_inputs=("X",))
    def _op(inputs, attrs, _fn=fn):
        """The first index of the extreme along ``axis`` (the reference
        reads no ``flatten`` attr); ``dtype`` int64 unless given."""
        x = _x(inputs)
        axis = attrs.get("axis", -1)
        out = _fn(x, dim=axis, keepdim=attrs.get("keepdims", False))
        return {"Out": [out.to(dtypes.convert_dtype(
            attrs.get("dtype", "int64")))]}
    return _op


_arg("arg_max", torch.argmax)
_arg("arg_min", torch.argmin)


@register_op("top_k_v2", non_differentiable_inputs=("X",))
def top_k_v2(inputs, attrs):
    """The k largest (or smallest) along ``axis``, ties in index order:
    a stable sort, as ``lax.top_k`` orders ties."""
    x = _x(inputs)
    k = attrs.get("k", 1)
    axis = attrs.get("axis", -1) % x.ndim
    values, indices = torch.sort(x, dim=axis,
                                 descending=attrs.get("largest", True),
                                 stable=True)
    return {"Out": [values.narrow(axis, 0, k)],
            "Indices": [indices.narrow(axis, 0, k)]}


@register_op("cumsum")
def cumsum(inputs, attrs):
    x = _x(inputs)
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if attrs.get("reverse", False):
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


@register_op("increment")
def increment(inputs, attrs):
    """x + step in x's dtype (an int64 loop counter stays int64)."""
    x = _x(inputs)
    step = attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}
