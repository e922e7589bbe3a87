"""Tensor ops: dtype cast, reshape, flatten, transpose and concat.

Port of the op types of ``paddle_tpu/ops/tensor_ops.py`` that a BERT
pretraining step, a ResNet training step and YOLOv3 inference run.
"""
from __future__ import annotations

import math

import torch

from ..core import dtype as dtypes
from ..core.registry import register_op


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
