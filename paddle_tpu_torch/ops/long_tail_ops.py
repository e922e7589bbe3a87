"""Long-tail ops.

Port of the op types of ``paddle_tpu/ops/long_tail_ops.py`` that the 2.0
tensor API reaches: ``unique``. The rest of the module waits for ROADMAP
Queue 1 item 4e.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


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
