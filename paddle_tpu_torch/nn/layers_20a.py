"""paddle.nn 2.0-alpha surface completion.

Port of ``paddle_tpu/nn/layers_20a.py``: the remaining activations,
``AlphaDropout``, the 1-D conv and pool layers (over the 2-D ops on
[N, C, 1, L]), the 3-D pools, the adaptive 1-D / 3-D pools, the padding
layers (pad2d / pad3d), ``Bilinear``, ``HSigmoid``, and the cell drivers
``RNN`` / ``BiRNN`` with ``SimpleRNNCell`` (a composition of ``linear``
and an activation), and ``RowConv`` over the ``row_conv`` op.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from . import functional as F
from . import initializer
from .layers_ext import channel_dropout


def _v(x):
    if isinstance(x, torch.Tensor):
        return x
    from .. import to_tensor
    return to_tensor(x)


def _first(v):
    return v if isinstance(v, int) else v[0]


# ------------------------------------------------------------ activations
def _unary_op_layer(cls_name, op_type, params=(), attr_map=None):
    """An activation layer whose ctor takes ``params`` ((name, default)
    pairs) by position or keyword, as the reference's; ``attr_map``
    renames a parameter to the op's attr (threshold -> lambda)."""
    attr_map = attr_map or {}

    class _L(Layer):
        def __init__(self, *args, **kw):
            super().__init__()
            names = [p for p, _ in params]
            if len(args) > len(names):
                raise TypeError(
                    f"{cls_name} takes at most {len(names)} positional "
                    f"arguments ({names}), got {len(args)}")
            vals = dict(params)
            vals.update(zip(names, args))
            for k, v in kw.items():
                if k not in vals:
                    raise TypeError(
                        f"{cls_name}: unexpected argument {k!r} "
                        f"(valid: {names})")
                vals[k] = v
            self._attrs = {attr_map.get(k, k): v for k, v in vals.items()}

        def forward(self, x):
            return trace_op(op_type, {"X": [_v(x)]}, self._attrs,
                            out_slots=["Out"])[0]

    _L.__name__ = cls_name
    return _L


ELU = _unary_op_layer("ELU", "elu", params=(("alpha", 1.0),))
SELU = _unary_op_layer(
    "SELU", "selu", params=(("scale", 1.0507009873554805),
                            ("alpha", 1.6732632423543772)))
Hardshrink = _unary_op_layer("Hardshrink", "hard_shrink",
                             params=(("threshold", 0.5),))
Softshrink = _unary_op_layer("Softshrink", "soft_shrink",
                             params=(("threshold", 0.5),),
                             attr_map={"threshold": "lambda"})
Softsign = _unary_op_layer("Softsign", "softsign")
Tanhshrink = _unary_op_layer("Tanhshrink", "tanh_shrink")
LogSigmoid = _unary_op_layer("LogSigmoid", "logsigmoid")


class Hardtanh(Layer):
    """ref: nn/layer/activation.py Hardtanh: clip to [min, max] (the
    brelu op)."""

    def __init__(self, min=-1.0, max=1.0):
        super().__init__()
        self._min, self._max = float(min), float(max)

    def forward(self, x):
        return trace_op("brelu", {"X": [_v(x)]},
                        {"t_min": self._min, "t_max": self._max},
                        out_slots=["Out"])[0]


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)


class AlphaDropout(Layer):
    """ref: nn/layer/common.py AlphaDropout: dropped units take SELU's
    saturation value and the output is rescaled affinely so the mean and
    variance hold; p >= 1 gives zeros."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        x = _v(x)
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return x * 0.0
        q = 1.0 - self.p
        alpha_p = -self._ALPHA * self._SCALE
        a = (q + alpha_p ** 2 * q * self.p) ** -0.5
        b = -a * alpha_p * self.p
        gen = rng.random_generator(0, x.device)
        keep = (torch.rand(x.shape, generator=gen, device=x.device)
                < q).to(x.dtype)
        return (x * keep + alpha_p * (1.0 - keep)) * a + b


# ------------------------------------------------------- 1-D conv / pool
def _squeeze_h(out):
    return out.reshape((out.shape[0], out.shape[1], out.shape[3]))


class Conv1d(Layer):
    """ref: nn/layer/conv.py Conv1d: conv2d with a [1, k] kernel over
    [N, C, 1, L]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        from . import _bias, _init_of
        k = _first(kernel_size)
        self._stride, self._padding = _first(stride), _first(padding)
        self._dilation, self._groups = _first(dilation), groups
        fan_in = in_channels // groups * k
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, 1, k),
            default_initializer=_init_of(weight_attr,
                                         initializer.KaimingNormal(fan_in)))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        x = _v(x)
        b, c, length = x.shape
        out = trace_op(
            "conv2d",
            {"Input": [x.reshape((b, c, 1, length))],
             "Filter": [self.weight]},
            {"strides": [1, self._stride], "paddings": [0, self._padding],
             "dilations": [1, self._dilation], "groups": self._groups},
            out_slots=["Output"])[0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1}, out_slots=["Out"])[0]
        return _squeeze_h(out)


class ConvTranspose1d(Layer):
    """ref: nn/layer/conv.py ConvTranspose1d, via conv2d_transpose; the
    weight is [in, out, 1, k]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, weight_attr=None, bias_attr=None):
        super().__init__()
        from . import _bias, _init_of
        k = _first(kernel_size)
        self._stride, self._padding = _first(stride), _first(padding)
        self.weight = self.create_parameter(
            (in_channels, out_channels, 1, k),
            default_initializer=_init_of(weight_attr,
                                         initializer.XavierNormal()))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        x = _v(x)
        b, c, length = x.shape
        out = trace_op(
            "conv2d_transpose",
            {"Input": [x.reshape((b, c, 1, length))],
             "Filter": [self.weight]},
            {"strides": [1, self._stride], "paddings": [0, self._padding]},
            out_slots=["Output"])[0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1}, out_slots=["Out"])[0]
        return _squeeze_h(out)


def _pool1d_layer(cls_name, ptype):
    class _P(Layer):
        def __init__(self, kernel_size, stride=None, padding=0,
                     ceil_mode=False):
            super().__init__()
            self._k = _first(kernel_size)
            self._s = _first(stride if stride is not None else kernel_size)
            self._p, self._ceil = _first(padding), ceil_mode

        def forward(self, x):
            x = _v(x)
            b, c, length = x.shape
            out = trace_op(
                "pool2d", {"X": [x.reshape((b, c, 1, length))]},
                {"ksize": [1, self._k], "pooling_type": ptype,
                 "strides": [1, self._s], "paddings": [0, self._p],
                 "global_pooling": False, "ceil_mode": self._ceil,
                 "exclusive": True}, out_slots=["Out"])[0]
            return _squeeze_h(out)

    _P.__name__ = cls_name
    return _P


MaxPool1d = _pool1d_layer("MaxPool1d", "max")
AvgPool1d = _pool1d_layer("AvgPool1d", "avg")


def _pool3d_layer(cls_name, ptype):
    class _P(Layer):
        def __init__(self, kernel_size, stride=None, padding=0,
                     ceil_mode=False):
            super().__init__()

            def _t3(v):
                return [v] * 3 if isinstance(v, int) else list(v)
            self._k = _t3(kernel_size)
            self._s = _t3(stride if stride is not None else kernel_size)
            self._p, self._ceil = _t3(padding), ceil_mode

        def forward(self, x):
            return trace_op(
                "pool3d", {"X": [_v(x)]},
                {"ksize": self._k, "pooling_type": ptype,
                 "strides": self._s, "paddings": self._p,
                 "global_pooling": False, "ceil_mode": self._ceil,
                 "exclusive": True}, out_slots=["Out"])[0]

    _P.__name__ = cls_name
    return _P


MaxPool3d = _pool3d_layer("MaxPool3d", "max")
AvgPool3d = _pool3d_layer("AvgPool3d", "avg")


def _adaptive_layer(cls_name, op_type, ptype, nd):
    class _A(Layer):
        def __init__(self, output_size):
            super().__init__()
            self._out = [output_size] * nd if isinstance(
                output_size, int) else list(output_size)

        def forward(self, x):
            x = _v(x)
            if nd == 1:
                b, c, length = x.shape
                out = trace_op(
                    "adaptive_pool2d", {"X": [x.reshape((b, c, 1, length))]},
                    {"pool_size": [1, self._out[0]], "pool_type": ptype},
                    out_slots=["Out"])[0]
                return _squeeze_h(out)
            return trace_op(op_type, {"X": [x]},
                            {"pool_size": self._out, "pool_type": ptype},
                            out_slots=["Out"])[0]

    _A.__name__ = cls_name
    return _A


AdaptiveAvgPool1d = _adaptive_layer("AdaptiveAvgPool1d",
                                    "adaptive_pool2d", "avg", 1)
AdaptiveMaxPool1d = _adaptive_layer("AdaptiveMaxPool1d",
                                    "adaptive_pool2d", "max", 1)
AdaptiveAvgPool3d = _adaptive_layer("AdaptiveAvgPool3d",
                                    "adaptive_pool3d", "avg", 3)
AdaptiveMaxPool3d = _adaptive_layer("AdaptiveMaxPool3d",
                                    "adaptive_pool3d", "max", 3)


# --------------------------------------------------------------- padding
def _pad_layer(cls_name, nd, mode, fixed_value=None):
    """``padding`` in paddle's layer order: [left, right] (1-D), [left,
    right, top, bottom] (2-D, pad2d takes [top, bottom, left, right]),
    [left, right, top, bottom, front, back] (3-D, pad3d's own order)."""
    class _Pad(Layer):
        def __init__(self, padding, value=0.0):
            super().__init__()
            self._pad = [padding] * (2 * nd) if isinstance(padding, int) \
                else list(padding)
            self._value = fixed_value if fixed_value is not None else \
                float(value)

        def forward(self, x):
            x = _v(x)
            if nd == 1:
                b, c, length = x.shape
                out = trace_op(
                    "pad2d", {"X": [x.reshape((b, c, 1, length))]},
                    {"paddings": [0, 0] + self._pad, "mode": mode,
                     "pad_value": self._value}, out_slots=["Out"])[0]
                return _squeeze_h(out)
            if nd == 2:
                p = self._pad
                return trace_op(
                    "pad2d", {"X": [x]},
                    {"paddings": [p[2], p[3], p[0], p[1]], "mode": mode,
                     "pad_value": self._value}, out_slots=["Out"])[0]
            return trace_op(
                "pad3d", {"X": [x]},
                {"paddings": list(self._pad), "mode": mode,
                 "value": self._value}, out_slots=["Out"])[0]

    _Pad.__name__ = cls_name
    return _Pad


ConstantPad1d = _pad_layer("ConstantPad1d", 1, "constant")
ConstantPad2d = _pad_layer("ConstantPad2d", 2, "constant")
ConstantPad3d = _pad_layer("ConstantPad3d", 3, "constant")
ReflectionPad1d = _pad_layer("ReflectionPad1d", 1, "reflect",
                             fixed_value=0.0)
ReflectionPad2d = _pad_layer("ReflectionPad2d", 2, "reflect",
                             fixed_value=0.0)
ReplicationPad1d = _pad_layer("ReplicationPad1d", 1, "edge",
                              fixed_value=0.0)
ReplicationPad2d = _pad_layer("ReplicationPad2d", 2, "edge",
                              fixed_value=0.0)
ReplicationPad3d = _pad_layer("ReplicationPad3d", 3, "replicate",
                              fixed_value=0.0)


# ----------------------------------------------------------- misc layers
class Bilinear(Layer):
    """ref: nn/layer/common.py Bilinear: out_s = x1 W_s x2^T + b (the
    bilinear_tensor_product op)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from . import _bias, _init_of
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features),
            default_initializer=_init_of(weight_attr,
                                         initializer.XavierNormal()))
        self.bias = _bias(self, out_features, bias_attr)

    def forward(self, x1, x2):
        ins = {"X": [_v(x1)], "Y": [_v(x2)], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return trace_op("bilinear_tensor_product", ins, {},
                        out_slots=["Out"])[0]


class RowConv(Layer):
    """ref: nn/layer/extension.py RowConv (lookahead conv)."""

    def __init__(self, num_channels, future_context_size, param_attr=None):
        super().__init__()
        from . import _init_of
        self.weight = self.create_parameter(
            (future_context_size, num_channels), attr=param_attr,
            default_initializer=_init_of(
                param_attr, initializer.XavierNormal()))

    def forward(self, x):
        return trace_op("row_conv",
                        {"X": [_v(x)], "Filter": [self.weight]}, {},
                        out_slots=["Out"])[0]


class HSigmoid(Layer):
    """ref: nn/layer/activation.py HSigmoid: hierarchical softmax over a
    complete binary tree (the hierarchical_sigmoid op)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        from . import _init_of
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size),
            default_initializer=_init_of(weight_attr,
                                         initializer.XavierNormal()))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_classes - 1, 1), is_bias=True,
            default_initializer=_init_of(bias_attr, None))

    def forward(self, x, label):
        ins = {"X": [_v(x)], "W": [self.weight], "Label": [_v(label)]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return trace_op("hierarchical_sigmoid", ins,
                        {"num_classes": self.num_classes},
                        out_slots=["Out"])[0]


# --------------------------------------------------------- cell drivers
class RNNCellBase(Layer):
    """ref: nn/layer/rnn.py RNNCellBase: the zero state of a cell."""

    def get_initial_states(self, batch_size, hidden_size=None):
        from .. import to_tensor
        h = hidden_size or self.hidden_size
        return to_tensor(np.zeros((batch_size, h), np.float32))


class SimpleRNNCell(RNNCellBase):
    """ref: nn/layer/rnn.py SimpleRNNCell: h' = act(x W_ih^T + b_ih +
    h W_hh^T + b_hh)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        from . import _init_of
        self.hidden_size = hidden_size
        self.activation = activation
        scale = 1.0 / math.sqrt(hidden_size)
        init = initializer.Uniform(-scale, scale)
        self.weight_ih = self.create_parameter(
            (hidden_size, input_size),
            default_initializer=_init_of(weight_ih_attr, init))
        self.weight_hh = self.create_parameter(
            (hidden_size, hidden_size),
            default_initializer=_init_of(weight_hh_attr, init))
        self.bias_ih = self.create_parameter(
            (hidden_size,), is_bias=True,
            default_initializer=_init_of(bias_ih_attr, init))
        self.bias_hh = self.create_parameter(
            (hidden_size,), is_bias=True,
            default_initializer=_init_of(bias_hh_attr, init))

    def forward(self, inputs, states=None):
        x = _v(inputs)
        if states is None:                  # zeros beside the input
            states = torch.zeros((x.shape[0], self.hidden_size),
                                 dtype=x.dtype, device=x.device)
        pre = (F.linear(x, self.weight_ih.t(), self.bias_ih)
               + F.linear(states, self.weight_hh.t(), self.bias_hh))
        act = {"tanh": "tanh", "relu": "relu"}[self.activation]
        h = trace_op(act, {"X": [pre]}, {}, out_slots=["Out"])[0]
        return h, h


class RNN(Layer):
    """ref: nn/layer/rnn.py RNN: any cell driven over the time axis, one
    step at a time."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        x = _v(inputs)
        t_axis = 0 if self.time_major else 1
        steps = x.shape[t_axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else \
            range(steps)
        states = initial_states
        outs = [None] * steps
        for t in order:
            out, states = self.cell(x[t] if self.time_major else x[:, t],
                                    states)
            outs[t] = out
        seq = trace_op("stack", {"X": outs}, {"axis": t_axis},
                       out_slots=["Y"])[0]
        return seq, states


class BiRNN(Layer):
    """ref: nn/layer/rnn.py BiRNN: a forward and a backward cell, the
    outputs joined on the features."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None):
        fw_states, bw_states = (initial_states if initial_states is not None
                                else (None, None))
        out_f, st_f = self.fw(inputs, fw_states)
        out_b, st_b = self.bw(inputs, bw_states)
        cat = trace_op("concat", {"X": [out_f, out_b]}, {"axis": -1},
                       out_slots=["Out"])[0]
        return cat, (st_f, st_b)


class RNNMixin:
    """ref: nn/layer/rnn.py RNNMixin: the marker the 2.0-alpha RNN classes
    share."""


class Dropout3d(Layer):
    """ref: nn/layer/common.py Dropout3d: whole channels zeroed."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = float(p)

    def forward(self, x):
        x = _v(x)
        if not self.training or self._p == 0.0:
            return x
        return channel_dropout(x, self._p)
