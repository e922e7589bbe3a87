"""MoE routing + expert FFN op (GShard-style dense dispatch).

Port of ``paddle_tpu/ops/moe_ops.py``. Top-k gating, per-expert
capacity, the load-balance aux loss and the expert FFN are dense einsums
and elementwise torch ops: XLA compiled the reference's op, so the port
leaves it to torch's own kernels. The arithmetic and dtypes are the
reference's: the gate logits, softmax, dispatch and combine in fp32, the
expert products accumulated in fp32 (``preferred_element_type``) and
``xin`` and the activation rounded to x's dtype.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

# jax.nn.gelu's default is the tanh form (approximate=True); the dense
# MLP's F.gelu is the erf form
_ACT = {"gelu": lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
        "relu": torch.relu, "silu": torch.nn.functional.silu}


def _f32(t):
    return t.to(torch.float32)


@register_op("moe_ffn")
def moe_ffn(inputs, attrs):
    """X: [B, S, D]; GateW: [D, E]; W1: [E, D, F]; B1: [E, F];
    W2: [E, F, D]; B2: [E, D]. Out: [B, S, D]; AuxLoss: scalar
    load-balancing loss (GShard eq.4 style: E * sum_e mean_prob_e *
    mean_dispatch_e)."""
    x = inputs["X"][0]
    gate_w = inputs["GateW"][0]
    w1, b1 = inputs["W1"][0], inputs["B1"][0]
    w2, b2 = inputs["W2"][0], inputs["B2"][0]
    top_k = attrs.get("top_k", 2)
    cap_factor = attrs.get("capacity_factor", 1.25)
    act = _ACT[attrs.get("activation", "gelu")]
    norm_topk = attrs.get("norm_topk_prob", True)

    b, s, d = x.shape
    e = gate_w.shape[1]
    n = b * s
    xt = x.reshape(n, d)
    logits = torch.einsum("nd,de->ne", _f32(xt), _f32(gate_w))
    gates = torch.softmax(logits, dim=-1)                    # [N, E]

    capacity = int(max(top_k * n * cap_factor / e, 1))

    # iterative top-k expert choice (argmax takes the first index on a
    # tie, in torch as in jnp) with per-expert capacity positions
    masks, g = [], gates
    for _ in range(top_k):
        m = torch.nn.functional.one_hot(torch.argmax(g, dim=-1), e).to(
            gates.dtype)                                     # [N, E]
        masks.append(m)
        g = g * (1.0 - m)
    prev = gates.new_zeros((e,))
    dispatch = gates.new_zeros((n, e, capacity))
    combine = gates.new_zeros((n, e, capacity))
    denom = gates.new_zeros((n,))
    for m in masks:
        pos = torch.cumsum(m, dim=0) - 1.0 + prev[None, :]   # [N, E]
        prev = prev + m.sum(dim=0)
        keep = m * (pos < capacity)                          # dropped → 0
        pos_i = pos.to(torch.int32).clamp(0, capacity - 1).long()
        oh = torch.nn.functional.one_hot(pos_i, capacity).to(gates.dtype)
        d_k = keep[..., None] * oh                           # [N, E, C]
        dispatch = dispatch + d_k
        gate_k = (gates * keep).sum(dim=-1)                  # [N]
        combine = combine + d_k * gate_k[:, None, None]
        denom = denom + gate_k
    if norm_topk:
        combine = combine / torch.clamp_min(denom, 1e-9)[:, None, None]

    # aux load-balance loss from the FIRST choice (GShard convention)
    aux = e * (gates.mean(dim=0) * masks[0].mean(dim=0)).sum()

    xin = torch.einsum("nec,nd->ecd", dispatch, _f32(xt)).to(x.dtype)
    h = torch.einsum("ecd,edf->ecf", _f32(xin), _f32(w1))
    h = h + b1[:, None, :]
    h = act(h).to(x.dtype)
    y = torch.einsum("ecf,efd->ecd", _f32(h), _f32(w2))
    y = y + b2[:, None, :]
    out = torch.einsum("nec,ecd->nd", combine, y)
    return {"Out": [out.reshape(b, s, d).to(x.dtype)],
            "AuxLoss": [aux.to(torch.float32)]}
