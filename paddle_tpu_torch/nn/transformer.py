"""Transformer encoder layers over the fused flash_attention op.

Port of ``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder`` from ``paddle_tpu/nn/transformer.py``. Attention
dispatches to the registered ``flash_attention`` op (the Hopper kernels
on the card); a mask travels as an additive bias. Layout [batch, seq,
embed]. The KV cache and sequence parallelism are not ported yet.
"""
from __future__ import annotations

import copy

import torch

from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from . import functional as F
from . import initializer


def _convert_attn_mask(mask):
    """Paddle contract: bool mask (True = keep) or float additive mask."""
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, -1e30).to(torch.float32)
    return mask.to(torch.float32)


class MultiHeadAttention(Layer):
    """paddle.nn.MultiHeadAttention parity over the fused kernel.

    forward(query, key=None, value=None, attn_mask=None); inputs
    [B, S, E]. ``causal=True`` uses the fused causal kernel with no
    materialized mask."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, causal=False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.causal = causal

        def mk():
            w = self.create_parameter(
                (embed_dim, embed_dim),
                default_initializer=initializer.XavierUniform())
            return w, self.create_parameter((embed_dim,), is_bias=True)

        self.q_weight, self.q_bias = mk()
        self.k_weight, self.k_bias = mk()
        self.v_weight, self.v_bias = mk()
        self.out_weight, self.out_bias = mk()

    def _shape(self, x):
        return x.reshape((x.shape[0], x.shape[1], self.num_heads,
                          self.head_dim))

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(F.linear(query, self.q_weight, self.q_bias))
        k = self._shape(F.linear(key, self.k_weight, self.k_bias))
        v = self._shape(F.linear(value, self.v_weight, self.v_bias))
        inputs = {"Q": [q], "K": [k], "V": [v]}
        if attn_mask is not None:
            mask = _convert_attn_mask(attn_mask)
            while mask.ndim < 4:
                mask = mask.unsqueeze(0)
            inputs["Bias"] = [mask]
        out = trace_op("flash_attention", inputs,
                       {"causal": self.causal, "q_offset": 0},
                       out_slots=["Out"])[0]
        # the fused kernel never materializes the [S, S] probabilities, so
        # attention dropout drops the attention OUTPUT (as the reference)
        if self.dropout:
            out = F.dropout(out, self.dropout, training=self.training)
        out = out.reshape((out.shape[0], out.shape[1], self.embed_dim))
        return F.linear(out, self.out_weight, self.out_bias)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", normalize_before=False):
        super().__init__()
        from . import LayerNorm, Linear
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = dropout
        self.activation = activation

    def _ffn(self, x):
        h = getattr(F, self.activation)(self.linear1(x))
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        return self.linear2(h)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        if self.dropout:
            src = F.dropout(src, self.dropout, training=self.training)
        src = residual + src
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self._ffn(src)
        if self.dropout:
            src = F.dropout(src, self.dropout, training=self.training)
        src = residual + src
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer``: every layer starts
    with the same weights, as in the reference."""

    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        self.layers = [encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)]
        for i, lyr in enumerate(self.layers):
            self.add_sublayer(f"layer_{i}", lyr)
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return out
