"""Recurrent and context-window ops.

Port of the op types of ``paddle_tpu/ops/rnn_ops.py`` that the static
graph's book programs run: ``sequence_conv``. The rest of the module
waits for the op-set item of ROADMAP Queue 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("sequence_conv")
def sequence_conv(inputs, attrs):
    """Context-window sequence conv (ref: sequence_conv_op.cc): X dense
    [B, T, D], Filter [context_length*D, F]; zero-padded context
    starting at context_start."""
    x = inputs["X"][0]
    filt = inputs["Filter"][0]
    ctx_len = int(attrs.get("contextLength",
                            attrs.get("context_length", 3)))
    ctx_start = int(attrs.get("contextStart",
                              attrs.get("context_start", -1)))
    t = x.shape[1]
    cols = []
    for j in range(ctx_len):
        shift = ctx_start + j
        if shift < 0:
            cols.append(F.pad(x, (0, 0, -shift, 0))[:, :t])
        else:
            cols.append(F.pad(x, (0, 0, 0, shift))[:, shift:])
    col = torch.cat(cols, dim=-1)                  # [B, T, ctx_len*D]
    return {"Out": [col @ filt]}
