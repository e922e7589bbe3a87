"""paddle.nn parity: the layer classes BERT uses.

Port of ``Linear``, ``LayerNorm``, ``Embedding`` and ``ParamAttr`` from
``paddle_tpu/nn/__init__.py``. Weights keep the reference's layouts
(``Linear`` is ``[in, out]``), so weights carry across with no transposes.
"""
from __future__ import annotations

import math

import torch

from ..dygraph.layers import Layer, LayerList  # noqa: F401
from ..dygraph.varbase import Parameter, to_variable  # noqa: F401
from . import functional as F  # noqa: F401
from . import initializer
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)


def _init_of(attr, default):
    if attr is not None and getattr(attr, "initializer", None) is not None:
        return attr.initializer
    return default


class ParamAttr:
    """fluid.ParamAttr parity, for the parameter's initializer."""

    def __init__(self, initializer=None):
        self.initializer = initializer


class Linear(Layer):
    """y = xW + b with W of shape [in_features, out_features]."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.weight = self.create_parameter(
            (in_features, out_features),
            default_initializer=initializer.XavierNormal())
        self.bias = self.create_parameter((out_features,), is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = math.prod(self._normalized_shape)
        self.weight = self.create_parameter(
            (n,), default_initializer=initializer.Constant(1.0))
        self.bias = self.create_parameter((n,), is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_attr=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim),
            default_initializer=_init_of(weight_attr,
                                         initializer.Normal(0.0, 0.02)))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)
