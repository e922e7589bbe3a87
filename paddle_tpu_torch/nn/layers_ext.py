"""Extended paddle.nn layer classes over the new op families.

Port of ``paddle_tpu/nn/layers_ext.py`` (ref: python/paddle/nn/layer/:
conv.py Conv3D / Conv3DTranspose, common.py Upsample / Pad2D / Unfold,
vision.py PixelShuffle, norm.py SpectralNorm / LocalResponseNorm,
pooling.py MaxUnPool2D, loss.py KLDivLoss / NLLLoss / BCELoss /
SmoothL1Loss / MarginRankingLoss, rnn.py LSTMCell / GRUCell, distance.py
PairwiseDistance, common.py CosineSimilarity). The cells run one step of
the reference's ``rnn_scan`` cell as torch code, with its packed
weights and gate order.
"""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from . import functional as F
from . import initializer


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v, v]


class Conv3D(Layer):
    """ref: nn/layer/conv.py Conv3D (NCDHW); the weight is OIDHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__()
        from . import _bias, _init_of
        k = _triple(kernel_size)
        groups = groups or 1
        self._attrs = {"strides": _triple(stride),
                       "paddings": _triple(padding),
                       "dilations": _triple(dilation), "groups": groups}
        fan_in = in_channels * k[0] * k[1] * k[2] // groups
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, *k),
            default_initializer=_init_of(weight_attr,
                                         initializer.KaimingNormal(fan_in)))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        out = trace_op("conv3d", {"Input": [x], "Filter": [self.weight]},
                       dict(self._attrs), out_slots=["Output"])[0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1},
                           out_slots=["Out"])[0]
        return out


class Conv3DTranspose(Layer):
    """The weight is [in, out / groups, kd, kh, kw]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from . import _bias, _init_of
        k = _triple(kernel_size)
        groups = groups or 1
        self._attrs = {"strides": _triple(stride),
                       "paddings": _triple(padding),
                       "output_padding": _triple(output_padding),
                       "dilations": _triple(dilation), "groups": groups}
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups, *k),
            default_initializer=_init_of(weight_attr, None))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        out = trace_op("conv3d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       dict(self._attrs), out_slots=["Output"])[0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1},
                           out_slots=["Out"])[0]
        return out


class Upsample(Layer):
    """ref: nn/layer/common.py Upsample (``interpolate_v2``)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW"):
        super().__init__()
        self._cfg = (size, scale_factor, mode, align_corners, align_mode)

    def forward(self, x):
        return F.interpolate_v2(x, *self._cfg)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size, scale_factor, "nearest")


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self._r, self._fmt = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._r, self._fmt)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self._cfg = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._cfg)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self._cfg = (kernel_size, stride, padding)

    def forward(self, x, indices, output_size=None):
        return F.max_unpool2d(x, indices, *self._cfg, output_size)


class Pad2D(Layer):
    """paddle.nn.Pad2D: ``padding`` is [left, right, top, bottom]; the
    pad2d op takes [top, bottom, left, right]."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        pad = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        left, right, top, bottom = (int(p) for p in pad)
        self._cfg = ([top, bottom, left, right], mode, value, data_format)

    def forward(self, x):
        pad, mode, value, fmt = self._cfg
        return trace_op("pad2d", {"X": [x]},
                        {"paddings": pad, "mode": mode,
                         "pad_value": float(value), "data_format": fmt},
                        out_slots=["Out"])[0]


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, "constant", 0.0, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0):
        super().__init__()
        self._cfg = (size, alpha, beta, k)

    def forward(self, x):
        return F.local_response_norm(x, *self._cfg)


class SpectralNorm(Layer):
    """ref: fluid/dygraph/nn.py SpectralNorm: ``weight`` / sigma by power
    iteration from the persistent ``weight_u`` / ``weight_v``
    (parameters with ``stop_gradient``, so ``state_dict`` carries them)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = math.prod(s for i, s in enumerate(weight_shape) if i != dim)
        self.weight_u = self.create_parameter(
            (h,), default_initializer=initializer.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            (w,), default_initializer=initializer.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        return trace_op("spectral_norm",
                        {"Weight": [weight], "U": [self.weight_u],
                         "V": [self.weight_v]},
                        {"dim": self._dim, "power_iters": self._power_iters,
                         "eps": self._eps}, out_slots=["Out"])[0]


# --------------------------------------------------------------- losses
class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self._cfg = (weight, ignore_index, reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, *self._cfg)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self._cfg = (weight, reduction)

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, *self._cfg)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self._cfg = (reduction, delta)

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, *self._cfg)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self._cfg = (margin, reduction)

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, *self._cfg)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._cfg = (blank, reduction)

    def forward(self, log_probs, labels, input_lengths=None,
                label_lengths=None):
        blank, red = self._cfg
        return F.ctc_loss(log_probs, labels, input_lengths,
                          label_lengths, blank, red)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._cfg = (axis, eps)

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, *self._cfg)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self._cfg = (p, epsilon, keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, *self._cfg)


# ------------------------------------------------------------ RNN cells
class _PackedCell(Layer):
    """The packed weights of an RNN cell: [gates * H, I] and [gates * H,
    H], biases [gates * H], uniform in +-1/sqrt(H)."""

    def __init__(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
        super().__init__()
        from . import _init_of
        self.hidden_size = hidden_size
        scale = 1.0 / math.sqrt(hidden_size)
        init = initializer.Uniform(-scale, scale)
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            (g, input_size), default_initializer=_init_of(weight_ih_attr,
                                                          init))
        self.weight_hh = self.create_parameter(
            (g, hidden_size), default_initializer=_init_of(weight_hh_attr,
                                                           init))
        self.bias_ih = self.create_parameter(
            (g,), is_bias=True, default_initializer=_init_of(bias_ih_attr,
                                                             init))
        self.bias_hh = self.create_parameter(
            (g,), is_bias=True, default_initializer=_init_of(bias_hh_attr,
                                                             init))

    def _zeros(self, x):
        return torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                           device=x.device)

    def _proj(self, x, h):
        return (x @ self.weight_ih.T + self.bias_ih,
                h @ self.weight_hh.T + self.bias_hh)


class LSTMCell(_PackedCell):
    """ref: nn/layer/rnn.py LSTMCell: gates (i, f, g, o); returns
    (h, (h, c))."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__(4, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h, c = states
        xp, hp = self._proj(inputs, h)
        i, f, g, o = (xp + hp).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_PackedCell):
    """ref: nn/layer/rnn.py GRUCell: gates (r, u, c), the candidate
    c = tanh(x_c + r * (h W_c + b_c)); returns (h, h)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__(3, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        xp, hp = self._proj(inputs, h)
        xr, xu, xc = xp.chunk(3, dim=-1)
        hr, hu, hc = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        u = torch.sigmoid(xu + hu)
        h = u * h + (1.0 - u) * torch.tanh(xc + r * hc)
        return h, h


def channel_dropout(x, p):
    """Whole channels zeroed with probability p (mask [N, C, 1, ...]),
    the rest scaled by 1 / (1 - p); p >= 1 zeroes everything."""
    if p >= 1.0:
        return x * 0.0
    gen = rng.random_generator(0, x.device)
    shape = tuple(x.shape[:2]) + (1,) * (x.ndim - 2)
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - p
    return x * keep / (1.0 - p)


class Dropout2D(Layer):
    """Channel-wise dropout (whole feature maps zeroed)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if not self.training or self._p == 0.0:
            return x
        return channel_dropout(x, self._p)
