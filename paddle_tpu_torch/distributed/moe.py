"""Mixture-of-Experts layer.

Port of ``paddle_tpu/distributed/moe.py``. The routing and expert
compute is the ``moe_ffn`` op (``ops/moe_ops.py``); this module is the
user-facing Layer. The expert weights carry the reference's
``partition_spec`` (``("ep", None, ...)``) as metadata: nothing reads it
on one device, and expert parallelism is not ported yet.
"""
from __future__ import annotations

from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from ..nn import initializer


class MoELayer(Layer):
    """Expert FFN block, a drop-in for a transformer MLP:

        moe = MoELayer(d_model=512, d_hidden=2048, num_experts=8)
        y = moe(x)                     # x: [B, S, D]
        loss = task_loss + 0.01 * moe.aux_loss
    """

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu",
                 norm_topk_prob=True, ep_axis="ep"):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.norm_topk_prob = norm_topk_prob
        self.gate_weight = self.create_parameter(
            (d_model, num_experts),
            default_initializer=initializer.XavierUniform())
        self.w1 = self.create_parameter(
            (num_experts, d_model, d_hidden),
            default_initializer=initializer.XavierUniform())
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        is_bias=True)
        self.w2 = self.create_parameter(
            (num_experts, d_hidden, d_model),
            default_initializer=initializer.XavierUniform())
        self.b2 = self.create_parameter((num_experts, d_model),
                                        is_bias=True)
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.partition_spec = (ep_axis,) + (None,) * (p.ndim - 1)
        self.aux_loss = None

    def forward(self, x):
        out, aux = trace_op(
            "moe_ffn",
            {"X": [x], "GateW": [self.gate_weight], "W1": [self.w1],
             "B1": [self.b1], "W2": [self.w2], "B2": [self.b2]},
            {"top_k": self.top_k, "capacity_factor": self.capacity_factor,
             "activation": self.activation,
             "norm_topk_prob": self.norm_topk_prob},
            out_slots=["Out", "AuxLoss"])
        self.aux_loss = aux
        return out
