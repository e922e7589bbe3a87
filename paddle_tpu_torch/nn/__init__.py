"""paddle.nn parity: the layer classes the text and vision models use.

Port of ``Linear``, ``Conv2D``, the batch norms, the 2-D pools,
``LayerNorm``, ``Embedding``, ``Dropout``, ``Flatten``, ``ReLU``,
``ReLU6``, ``LeakyReLU`` and ``ParamAttr`` from
``paddle_tpu/nn/__init__.py``, and every class of ``nn/transformer.py``.
Weights
keep the reference's layouts (``Linear`` is ``[in, out]``, ``Conv2D``
OIHW in either data format), so weights carry across with no transposes.
"""
from __future__ import annotations

import math

import torch

from ..device import get_device
from ..dygraph.layers import Layer, LayerList, Sequential  # noqa: F401
from ..dygraph.tracer import trace_op
from ..dygraph.varbase import Parameter, to_variable  # noqa: F401
from . import functional as F  # noqa: F401
from . import initializer
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)


def _init_of(attr, default):
    if attr is not None and getattr(attr, "initializer", None) is not None:
        return attr.initializer
    return default


class ParamAttr:
    """fluid.ParamAttr parity, for the parameter's initializer."""

    def __init__(self, initializer=None):
        self.initializer = initializer


def _bias(layer, n, bias_attr):
    """The bias parameter, or None for ``bias_attr=False``."""
    if bias_attr is False:
        return None
    return layer.create_parameter(
        (n,), is_bias=True, default_initializer=_init_of(bias_attr, None))


class Linear(Layer):
    """y = xW + b with W of shape [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            (in_features, out_features),
            default_initializer=_init_of(weight_attr,
                                         initializer.XavierNormal()))
        self.bias = _bias(self, out_features, bias_attr)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2D(Layer):
    """ref: python/paddle/nn/layer/conv.py Conv2D. The weight is OIHW for
    either ``data_format``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, (list, tuple)) else \
            (kernel_size, kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan_in = in_channels * k[0] * k[1] // groups
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, k[0], k[1]),
            default_initializer=_init_of(weight_attr,
                                         initializer.KaimingNormal(fan_in)))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        data_format=self._data_format)


class _BatchNormBase(Layer):
    """ref: python/paddle/nn/layer/norm.py; op batch_norm_op.cc.

    The running statistics are buffers named ``_mean`` and ``_variance``,
    as in the reference, so ``state_dict`` names match it (no
    ``torch.nn.BatchNorm2d``, whose ``num_batches_tracked`` it lacks).
    ``train()`` / ``eval()`` pick the op's batch or running statistics."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._momentum, self._epsilon = momentum, epsilon
        fmt = str(data_format).upper()
        if fmt in ("NHWC", "NDHWC", "NLC"):
            self._data_format = "NHWC"
        elif fmt in ("NCHW", "NCDHW", "NCL"):
            self._data_format = "NCHW"
        else:
            raise ValueError(f"BatchNorm: bad data_format {data_format!r}")
        self.weight = self.create_parameter(
            (num_features,),
            default_initializer=_init_of(weight_attr,
                                         initializer.Constant(1.0)))
        self.bias = self.create_parameter(
            (num_features,), is_bias=True,
            default_initializer=_init_of(bias_attr, None))
        dev = get_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format)


class BatchNorm(_BatchNormBase):
    """fluid.dygraph.BatchNorm signature parity."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 **kwargs):
        super().__init__(num_channels, momentum, epsilon)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act:
            y = getattr(F, self._act)(y)
        return y


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN through the ``sync_batch_norm`` op, which on one
    device is local BN."""

    def forward(self, x):
        return F._batch_norm(
            "sync_batch_norm", x, self._mean, self._variance, self.weight,
            self.bias, self.training, self._momentum, self._epsilon,
            self._data_format)


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


class Dropout(Layer):
    def __init__(self, p=0.5, mode="upscale_in_train"):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode)
        self._data_format = data_format

    def forward(self, x):
        k, s, p, c = self._args
        return F.max_pool2d(x, k, s, p, c, data_format=self._data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive)
        self._data_format = data_format

    def forward(self, x):
        k, s, p, c, e = self._args
        return F.avg_pool2d(x, k, s, p, c, e, data_format=self._data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size,
                                     data_format=self._data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size,
                                     data_format=self._data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._axes = (start_axis, stop_axis)

    def forward(self, x):
        return trace_op("flatten_contiguous_range", {"X": [x]},
                        {"start_axis": self._axes[0],
                         "stop_axis": self._axes[1]}, out_slots=["Out"])[0]


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)
