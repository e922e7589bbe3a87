"""Loss ops.

Port of the op types of ``paddle_tpu/ops/loss_ops.py`` that the static
graph's book programs run (``cos_sim``) and the 2.0 tensor API reaches
(``dist``). The rest of the module waits for ROADMAP Queue 1 item 4b.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("cos_sim")
def cos_sim(inputs, attrs):
    """ref: cos_sim_op.h: row-wise cosine similarity; Y may have one row
    broadcast against X's batch."""
    x, y = inputs["X"][0], inputs["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    return {"Out": [dot / (xn * yn)], "XNorm": [xn], "YNorm": [yn]}


@register_op("dist")
def dist(inputs, attrs):
    """ref: dist_op.cc: the p-norm of the broadcast difference, 0-d
    (p = inf / -inf: the largest / smallest |x - y|; p = 0: the count of
    nonzero differences)."""
    x, y = inputs["X"][0], inputs["Y"][0]
    p = float(attrs.get("p", 2.0))
    d = torch.abs(x - y)
    if p == float("inf"):
        out = d.amax()
    elif p == float("-inf"):
        out = d.amin()
    elif p == 0:
        out = (d != 0).to(x.dtype).sum()
    else:
        out = torch.pow(torch.pow(d, p).sum(), 1.0 / p)
    return {"Out": [out.reshape(())]}
