"""Loss ops.

Port of the op types of ``paddle_tpu/ops/loss_ops.py`` that the static
graph's book programs run: ``cos_sim``. The rest of the module waits for
the op-set item of ROADMAP Queue 1.
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
