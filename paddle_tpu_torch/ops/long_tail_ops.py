"""Long-tail ops.

Port of the op types of ``paddle_tpu/ops/long_tail_ops.py`` that the 2.0
tensor API reaches (``unique``) and that the ``nn`` layers call
(``adaptive_pool2d`` / ``adaptive_pool3d``, ``brelu``,
``bilinear_tensor_product``). The rest of the module waits for ROADMAP
Queue 1 item 4e.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _adaptive_pool(inputs, attrs, nd):
    """Output cell i pools the input over [floor(i in / out), ceil((i + 1)
    in / out)) along each dim, the bins of the reference's double loop
    (``long_tail_ops.py:24-70``) and of torch's adaptive pools."""
    x = inputs["X"][0]
    size = [int(v) for v in attrs["pool_size"]]
    ptype = attrs.get("pooling_type", attrs.get("pool_type", "max"))
    if ptype == "max":
        fn = F.adaptive_max_pool2d if nd == 2 else F.adaptive_max_pool3d
    else:
        fn = F.adaptive_avg_pool2d if nd == 2 else F.adaptive_avg_pool3d
    return {"Out": [fn(x, size)]}


@register_op("adaptive_pool2d")
def adaptive_pool2d(inputs, attrs):
    """ref: fluid/layers/nn.py adaptive_pool2d (pool_op adaptive=true)."""
    return _adaptive_pool(inputs, attrs, 2)


@register_op("adaptive_pool3d")
def adaptive_pool3d(inputs, attrs):
    """ref: fluid/layers/nn.py adaptive_pool3d."""
    return _adaptive_pool(inputs, attrs, 3)


@register_op("brelu")
def brelu(inputs, attrs):
    """ref: operators/activation_op.cc BRelu: clip(x, t_min, t_max)."""
    return {"Out": [inputs["X"][0].clamp(float(attrs.get("t_min", 0.0)),
                                         float(attrs.get("t_max", 24.0)))]}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(inputs, attrs):
    """ref: operators/bilinear_tensor_product_op.cc: out[b, s] = x[b] W[s]
    y[b]^T (+ bias)."""
    out = torch.einsum("bm,smn,bn->bs", inputs["X"][0],
                       inputs["Weight"][0], inputs["Y"][0])
    if inputs.get("Bias"):
        out = out + inputs["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("unique", non_differentiable_inputs=("X",))
def unique(inputs, attrs):
    """ref: operators/unique_op.cc over the flattened input: the unique
    values in the order they first appear (``Out``), each element's row
    among them (``Index``), each value's first position (``Indices``) and
    count (``Counts``), all int64. The count of values depends on the
    data, so it is read on the host (one sync on the card)."""
    x = inputs["X"][0].reshape(-1)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    pos = torch.arange(x.shape[0], device=x.device)
    first = torch.full((vals.shape[0],), x.shape[0], dtype=torch.int64,
                       device=x.device).scatter_reduce(0, inv, pos, "amin")
    order = torch.argsort(first)
    remap = torch.empty_like(order)
    remap[order] = torch.arange(order.shape[0], device=x.device)
    return {"Out": [vals[order]], "Index": [remap[inv]],
            "Indices": [first[order]], "Counts": [counts[order]]}
