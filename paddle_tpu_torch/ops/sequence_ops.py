"""Sequence ops over dense padded tensors plus a length vector.

Port of the op types of ``paddle_tpu/ops/sequence_ops.py`` that the
static graph's book programs run: ``sequence_pool``. As in the JAX
package, a ragged batch is [batch, max_len, ...] with a ``Length``
[batch] vector and no LoD; the rest of the module waits for the op-set
item of ROADMAP Queue 1.
"""
from __future__ import annotations

import torch

from ..core.enforce import InvalidArgumentError
from ..core.registry import register_op

NEG_INF = -1e30


def _mask(length, max_len, dtype):
    """[B, T] validity mask from lengths."""
    t = torch.arange(max_len, device=length.device)
    return (t[None, :] < length[:, None]).to(dtype)


@register_op("sequence_pool", non_differentiable_inputs=("Length",))
def sequence_pool(inputs, attrs):
    """ref: sequence_ops/sequence_pool_op.cc. X: [B, T, ...dense],
    Length: [B]. pooltype: SUM/AVERAGE/MAX/MIN/LAST/FIRST/SQRT.
    Out: [B, ...dense]. MAX and MIN split the gradient evenly between
    tied elements (``amax``), as the reference's ``jnp.max`` does."""
    x = inputs["X"][0]
    length = inputs["Length"][0].to(torch.int32)
    pooltype = attrs.get("pooltype", "SUM").upper()
    b, t = x.shape[0], x.shape[1]
    tail = (1,) * (x.ndim - 2)
    m = _mask(length, t, x.dtype).reshape((b, t) + tail)
    safe_len = torch.clamp_min(length, 1).reshape((b,) + tail)
    nonempty = (length > 0).reshape(safe_len.shape)
    if pooltype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif pooltype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / safe_len
    elif pooltype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(safe_len.to(x.dtype))
    elif pooltype == "MAX":
        out = torch.amax(torch.where(m > 0, x, NEG_INF), dim=1)
        out = torch.where(nonempty, out, 0.0)
    elif pooltype == "MIN":
        out = torch.amin(torch.where(m > 0, x, -NEG_INF), dim=1)
        out = torch.where(nonempty, out, 0.0)
    elif pooltype == "LAST":
        idx = torch.clamp_min(length - 1, 0).long()
        out = torch.take_along_dim(
            x, idx.reshape((b, 1) + tail), dim=1).squeeze(1)
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise InvalidArgumentError(f"unknown pooltype {pooltype!r}")
    return {"Out": [out.to(x.dtype)]}
