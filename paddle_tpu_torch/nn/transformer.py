"""Transformer layers over the fused flash_attention op.

Port of ``paddle_tpu/nn/transformer.py``, the whole file:
``MultiHeadAttention`` (with its ``Cache`` and the cached route),
``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``.
Attention dispatches to the registered ``flash_attention`` op (the
Hopper kernels on the card); a mask travels as an additive bias, and a
cached call passes the cache's length as ``q_offset``, so both take the
op's blockwise route, as in the reference. Layout [batch, seq, embed].
Sequence parallelism (``sp_axis``) is kept on the layer and raises in
the op.
"""
from __future__ import annotations

import collections
import copy

import torch

from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from ..dygraph.varbase import to_variable
from . import functional as F
from . import initializer


def _convert_attn_mask(mask):
    """Paddle contract: bool mask (True = keep) or float additive mask,
    as an fp32 bias."""
    if mask is None:
        return None
    mask = to_variable(mask)
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, -1e30).to(torch.float32)
    return mask.to(torch.float32)


class MultiHeadAttention(Layer):
    """paddle.nn.MultiHeadAttention parity over the fused kernel.

    forward(query, key=None, value=None, attn_mask=None, cache=None);
    inputs [B, S, E]. ``causal=True`` uses the fused causal kernel with
    no materialized mask. With ``cache`` (a ``Cache``; ``Cache(None,
    None)`` to start one) the new keys and values are appended to it, the
    queries sit at positions past its end, and forward returns
    ``(out, new_cache)``."""

    Cache = collections.namedtuple("Cache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, causal=False, sp_axis=None,
                 sp_mode="ring"):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        if need_weights:
            raise NotImplementedError(
                "need_weights=True is unsupported: the fused flash "
                "kernel never materializes the [S, S] attention matrix")
        self.need_weights = need_weights
        self.causal = causal
        # the mesh axis that shards the sequence (ring / ulysses)
        self.sp_axis = sp_axis
        self.sp_mode = sp_mode

        def mk(in_dim, out_dim):
            w = self.create_parameter(
                (in_dim, out_dim), attr=weight_attr,
                default_initializer=initializer.XavierUniform())
            b = None
            if bias_attr is not False:
                b = self.create_parameter((out_dim,), is_bias=True,
                                          attr=bias_attr)
            return w, b

        self.q_weight, self.q_bias = mk(embed_dim, embed_dim)
        self.k_weight, self.k_bias = mk(self.kdim, embed_dim)
        self.v_weight, self.v_bias = mk(self.vdim, embed_dim)
        self.out_weight, self.out_bias = mk(embed_dim, embed_dim)

    def _shape(self, x):
        return x.reshape((x.shape[0], x.shape[1], self.num_heads,
                          self.head_dim))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(F.linear(query, self.q_weight, self.q_bias))
        k = self._shape(F.linear(key, self.k_weight, self.k_bias))
        v = self._shape(F.linear(value, self.v_weight, self.v_bias))
        new_cache = None
        past_len = 0
        if cache is not None:
            if isinstance(cache, self.Cache) and cache.k is not None:
                past_len = cache.k.shape[1]
                k = trace_op("concat", {"X": [cache.k, k]}, {"axis": 1},
                             out_slots=["Out"])[0]
                v = trace_op("concat", {"X": [cache.v, v]}, {"axis": 1},
                             out_slots=["Out"])[0]
            new_cache = self.Cache(k=k, v=v)
        inputs = {"Q": [q], "K": [k], "V": [v]}
        mask = _convert_attn_mask(attn_mask)
        if mask is not None:
            while mask.ndim < 4:
                mask = mask.unsqueeze(0)
            inputs["Bias"] = [mask]
        # causal holds across a cached decode too: the queries sit at
        # positions past_len..past_len+Sq-1 over the concatenated keys
        attrs = {"causal": self.causal, "q_offset": past_len}
        if self.sp_axis and mask is None and cache is None:
            attrs["sp_axis"] = self.sp_axis
            attrs["sp_mode"] = self.sp_mode
        out = trace_op("flash_attention", inputs, attrs,
                       out_slots=["Out"])[0]
        # the fused kernel never materializes the [S, S] probabilities, so
        # attention dropout drops the attention OUTPUT (as the reference)
        if self.dropout:
            out = F.dropout(out, self.dropout, training=self.training)
        out = out.reshape((out.shape[0], out.shape[1], self.embed_dim))
        out = F.linear(out, self.out_weight, self.out_bias)
        if cache is not None:
            return out, new_cache
        return out


def _ffn_forward(layer, x):
    """The FFN block of the encoder and decoder layers: act(linear1) →
    act_dropout → linear2."""
    h = getattr(F, layer.activation)(layer.linear1(x))
    if layer.act_dropout:
        h = F.dropout(h, layer.act_dropout, training=layer.training)
    return layer.linear2(h)


def _residual(layer, x, norm, sublayer):
    """x + dropout(sublayer(x')), with x' = norm(x) before (pre-LN) or
    the sum normalized after (post-LN)."""
    h = sublayer(norm(x) if layer.normalize_before else x)
    if layer.dropout:
        h = F.dropout(h, layer.dropout, training=layer.training)
    x = x + h
    return x if layer.normalize_before else norm(x)


class TransformerEncoderLayer(Layer):
    """ref 2.0 surface: python/paddle/nn/layer/transformer.py."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        from . import LayerNorm, Linear
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward,
                              weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model,
                              weight_attr=weight_attr, bias_attr=bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = dropout
        self.act_dropout = act_dropout if act_dropout is not None else dropout
        self.activation = activation

    def _ffn(self, x):
        return _ffn_forward(self, x)

    def forward(self, src, src_mask=None):
        src = _residual(self, src, self.norm1,
                        lambda h: self.self_attn(h, attn_mask=src_mask))
        return _residual(self, src, self.norm2, self._ffn)


class _Stack(Layer):
    """``num_layers`` deep copies of ``layer`` (every layer starts with the
    same weights, as in the reference), then ``norm`` when given."""

    def __init__(self, layer, num_layers, norm=None):
        super().__init__()
        self.layers = [layer] + [copy.deepcopy(layer)
                                 for _ in range(num_layers - 1)]
        for i, lyr in enumerate(self.layers):
            self.add_sublayer(f"layer_{i}", lyr)
        self.num_layers = num_layers
        self.norm = norm

    def _finish(self, out):
        return out if self.norm is None else self.norm(out)


class TransformerEncoder(_Stack):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__(encoder_layer, num_layers, norm)

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return self._finish(out)


class TransformerDecoderLayer(Layer):
    """Self-attention is causal by default through the fused kernel (no
    materialized subsequent mask), as in the reference. Pass
    ``causal=False`` (and a tgt_mask if needed) for non-autoregressive
    decoding; a given tgt_mask is added to the causal masking."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 causal=True):
        super().__init__()
        from . import LayerNorm, Linear
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr,
                                            causal=causal)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward,
                              weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model,
                              weight_attr=weight_attr, bias_attr=bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout = dropout
        self.act_dropout = act_dropout if act_dropout is not None else dropout
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        tgt = _residual(self, tgt, self.norm1,
                        lambda h: self.self_attn(h, attn_mask=tgt_mask))
        tgt = _residual(self, tgt, self.norm2,
                        lambda h: self.cross_attn(h, memory, memory,
                                                  attn_mask=memory_mask))
        return _residual(self, tgt, self.norm3,
                         lambda h: _ffn_forward(self, h))


class TransformerDecoder(_Stack):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__(decoder_layer, num_layers, norm)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        return self._finish(out)


class Transformer(Layer):
    """paddle.nn.Transformer parity (encoder-decoder); with
    ``normalize_before`` each stack ends in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 causal=True):
        super().__init__()
        from . import LayerNorm
        enc = TransformerEncoderLayer(
            d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr)
        dec = TransformerDecoderLayer(
            d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr, causal=causal)
        enc_norm = LayerNorm(d_model) if normalize_before else None
        dec_norm = LayerNorm(d_model) if normalize_before else None
        self.encoder = TransformerEncoder(enc, num_encoder_layers, enc_norm)
        self.decoder = TransformerDecoder(dec, num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
