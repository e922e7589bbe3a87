"""Tensor ops: creation (fill_constant, gaussian_random, uniform_random),
assign, dtype cast, reshape, flatten, transpose and concat.

Port of the op types of ``paddle_tpu/ops/tensor_ops.py`` that a BERT
pretraining step, a ResNet training step, YOLOv3 inference and the
static graph (startup programs, the loss seed of ``append_backward``,
``flatten``) run. An op with no tensor input creates its output on
``device.creation_device()``: the static executor's device, or ``meta``
while a builder infers shapes. The random ops draw on the CPU (from
``core/rng.random_generator``) and move the result, so one seed gives
the same values on every device.
"""
from __future__ import annotations

import math

import torch

from ..core import dtype as dtypes, rng
from ..core.registry import register_op
from ..device import creation_device


def _dtype_attr(attrs, default="float32"):
    return dtypes.convert_dtype(attrs.get("dtype", default))


def _shape_attr(attrs):
    return tuple(int(s) for s in attrs.get("shape", [1]))


@register_op("fill_constant")
def fill_constant(inputs, attrs):
    """``ShapeTensor`` and ``ValueTensor``, when given, override the
    attrs (``ShapeTensor`` is read on the host, as the reference does)."""
    shape = _shape_attr(attrs)
    if inputs.get("ShapeTensor"):
        shape = tuple(int(s) for s in inputs["ShapeTensor"][0].tolist())
    dt = _dtype_attr(attrs)
    if inputs.get("ValueTensor"):
        v = inputs["ValueTensor"][0]
        return {"Out": [torch.broadcast_to(v.to(dt), shape).clone()]}
    value = attrs.get("value", 0.0)
    if dt == torch.bool:
        value = bool(value)
    elif not dt.is_floating_point:
        value = int(value)                 # jnp.full truncates a float
    return {"Out": [torch.full(shape, value, dtype=dt,
                               device=creation_device())]}


def _random(attrs, draw):
    shape, dev = _shape_attr(attrs), creation_device()
    if dev.type == "meta":                 # shape inference draws nothing
        return torch.empty(shape, dtype=_dtype_attr(attrs), device=dev)
    out = draw(shape, rng.random_generator(attrs.get("seed", 0) or 0))
    return out.to(_dtype_attr(attrs)).to(dev)


@register_op("gaussian_random")
def gaussian_random(inputs, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return {"Out": [_random(attrs, lambda shape, gen: mean + std * torch.randn(
        shape, generator=gen, dtype=torch.float32))]}


@register_op("uniform_random")
def uniform_random(inputs, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [_random(attrs, lambda shape, gen: torch.empty(
        shape, dtype=torch.float32).uniform_(lo, hi, generator=gen))]}


@register_op("assign")
def assign(inputs, attrs):
    return {"Out": [inputs["X"][0]]}


@register_op("cast")
def cast(inputs, attrs):
    out_dtype = dtypes.convert_dtype(attrs.get("out_dtype", attrs.get(
        "dtype", "float32")))
    return {"Out": [inputs["X"][0].to(out_dtype)]}


def _infer_reshape(x, shape):
    shape = [int(s) for s in shape]
    for i, s in enumerate(shape):
        if s == 0:  # 0 = copy input dim (fluid semantics)
            shape[i] = x.shape[i]
    return shape


@register_op("reshape")
def reshape(inputs, attrs):
    x = inputs["X"][0]
    shape = attrs.get("shape")
    if inputs.get("Shape"):
        shape = [int(s) for s in inputs["Shape"][0].tolist()]
    return {"Out": [x.reshape(_infer_reshape(x, shape))]}


@register_op("flatten2", intermediate_outputs=("XShape",))
def flatten2(inputs, attrs):
    """Dims before ``axis`` into the rows, the rest into the columns;
    ``XShape`` is the reference's empty tensor carrying the input shape,
    allocated with no bytes."""
    x = inputs["X"][0]
    lead = math.prod(x.shape[:attrs.get("axis", 1)])
    return {"Out": [x.reshape((lead, -1))],
            "XShape": [x.new_empty((0,) + tuple(x.shape))]}


@register_op("flatten_contiguous_range", intermediate_outputs=("XShape",))
def flatten_contiguous_range(inputs, attrs):
    """Dims start_axis..stop_axis into one. ``XShape`` (an empty tensor
    that carries the input shape to the reference's grad op) has no use
    under torch autograd and is not made."""
    x = inputs["X"][0]
    start = attrs.get("start_axis", 1) % max(x.ndim, 1)
    stop = attrs.get("stop_axis", -1) % max(x.ndim, 1)
    mid = math.prod(x.shape[start:stop + 1])
    return {"Out": [x.reshape(tuple(x.shape[:start]) + (mid,)
                              + tuple(x.shape[stop + 1:]))]}


@register_op("transpose2", intermediate_outputs=("XShape",))
def transpose2(inputs, attrs):
    """``Out`` is a permuted view (no copy); ``XShape`` is the reference's
    empty tensor that carries the input shape, allocated with no bytes."""
    x = inputs["X"][0]
    return {"Out": [x.permute(*attrs["axis"])],
            "XShape": [x.new_empty((0,) + tuple(x.shape))]}


@register_op("concat")
def concat(inputs, attrs):
    """``AxisTensor``, when given, overrides the ``axis`` attr (read on
    the host, as the reference does)."""
    axis = attrs.get("axis", 0)
    if inputs.get("AxisTensor"):
        axis = int(inputs["AxisTensor"][0])
    return {"Out": [torch.cat(inputs["X"], dim=axis)]}
