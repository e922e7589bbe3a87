"""Tensor ops: dtype cast and reshape.

Port of the op types of ``paddle_tpu/ops/tensor_ops.py`` that a BERT
pretraining step runs.
"""
from __future__ import annotations

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
